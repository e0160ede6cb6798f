"""Stream buffers: frames of tensors flowing through a pipeline.

Counterpart of the JAX package's ``core/buffer.py`` (replacement for
GstBuffer + the reference's tensor-buffer helpers).  A :class:`Tensor`
holds its payload in one of three residences — a ``torch.Tensor`` on the
pipeline's device, a host ``np.ndarray``, or raw wire ``bytes`` — and
converts lazily.  ``torch()`` uploads to a given device, ``np()`` drains to
the host.  PyTorch launches device work asynchronously, so a Buffer may
hold tensors whose values the card has not computed yet; a drain waits
for them.

Timestamps (``pts``/``duration``) are integer nanoseconds as in GStreamer;
``None`` means "no timestamp" (GST_CLOCK_TIME_NONE).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import transfer as _xfer
from .meta import MetaInfo
from .spec import TensorSpec, TensorsSpec
from .types import DType, MediaType, TensorFormat

ArrayLike = Any  # torch.Tensor | np.ndarray | bytes

SECOND = 1_000_000_000  # ns, parity with GST_SECOND
MSECOND = 1_000_000
USECOND = 1_000


class DonatedTensorError(RuntimeError):
    """A tensor's device payload was handed over (donated) to a consumer
    that may reuse its memory, and then read again.  The runtime marks
    donated tensors eagerly and fails the *read*, at the exact line that
    would have consumed stale data."""


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host ndarray of a tensor (waits for pending device work; a drain
    off the card is recorded in the transfer ledger)."""
    return _host_array(_xfer.to_host(t.detach()))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """ndarray view of a host tensor.  bfloat16 needs ``ml_dtypes`` and
    imports it only here."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(DType.BFLOAT16.np_dtype)
    return t.numpy()


def from_numpy(a: np.ndarray, device: Optional[torch.device] = None,
               reason: str = "input") -> torch.Tensor:
    """``torch.Tensor`` of a host ndarray (bfloat16 by bit pattern),
    placed on ``device`` (an upload to the card is recorded in the
    transfer ledger under ``reason``)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else _xfer.to_device(t, device, reason)


class Tensor:
    """One tensor payload with lazy device/host/wire conversion."""

    __slots__ = ("_dev", "_host", "_raw", "_spec", "_donated", "_shared",
                 "_fetch")

    def __init__(self, data: ArrayLike, spec: Optional[TensorSpec] = None):
        self._dev = None
        self._host = None
        self._raw = None
        self._donated = False
        #: set by a fan-out (``tee``): more than one branch holds this
        #: tensor, so no branch may write into its memory
        self._shared = False
        #: a started host copy (obs/transfer.py ``prefetch``): np() waits
        #: for it instead of draining again
        self._fetch = None
        if isinstance(data, (bytes, bytearray, memoryview)):
            if spec is None:
                raise ValueError("raw bytes tensor requires an explicit spec")
            self._raw = bytes(data)
            if len(self._raw) != spec.nbytes:
                raise ValueError(
                    f"payload size {len(self._raw)} != spec size {spec.nbytes}")
            self._spec = spec
        elif isinstance(data, np.ndarray):
            self._host = data
            self._spec = spec or TensorSpec.from_shape(data.shape, data.dtype)
        elif isinstance(data, torch.Tensor):
            self._dev = data
            self._spec = spec or TensorSpec.from_shape(
                tuple(data.shape), DType.from_torch(data.dtype))
        else:
            raise TypeError(f"unsupported tensor payload {type(data)}")

    # -- residence conversions ---------------------------------------------

    def _check_donated(self) -> None:
        """Raise if the only payload this tensor ever had was donated.
        Donation consumes the DEVICE tensor; an independent host/raw copy
        (if one exists) stays valid and readable."""
        if self._donated and self._host is None and self._raw is None:
            raise DonatedTensorError(
                f"tensor {self._spec} was donated and cannot be read again "
                f"(its device memory may have been reused)")

    def mark_donated(self) -> None:
        """Record that this tensor's device payload was handed to a
        consumer that may reuse its memory: the device handle is dropped
        so no code path can read it, and a read with no surviving
        host/raw copy raises :class:`DonatedTensorError`.  Host-resident
        tensors are unaffected."""
        if self._dev is not None:
            self._donated = True
            self._dev = None

    @property
    def is_donated(self) -> bool:
        return self._donated

    def shared_view(self) -> "Tensor":
        """Another handle on this payload, for a second consumer (a
        repeated pick, a frame pushed again).  Both handles are marked
        shared, so no consumer writes into the memory in place, and
        donating one handle leaves the other readable."""
        self._shared = True
        t = Tensor.__new__(Tensor)
        t._dev, t._host, t._raw = self._dev, self._host, self._raw
        t._spec, t._donated, t._shared = self._spec, self._donated, True
        t._fetch = self._fetch
        return t

    def torch(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The payload as a ``torch.Tensor`` on ``device`` (uploads host
        data on first call; moves a tensor that lives elsewhere).  With
        ``device=None`` a device-resident payload is returned where it is
        and host data is wrapped on the CPU."""
        if self._dev is None:
            self._check_donated()
            self._dev = from_numpy(self.np(), device)
        elif device is not None and self._dev.device != device:
            self._dev = _xfer.move(self._dev, device)
        elif self._fetch is not None:
            # device work from here on (an in-place chain) runs after
            # the host copy has read the payload
            _xfer.wait_prefetch(self._fetch, self._dev.device)
        return self._dev

    def np(self) -> np.ndarray:
        """Host ndarray (waits for the device computation if needed)."""
        if self._host is None:
            # a donated payload raises even when its host copy was
            # started: the read would return bytes from before the
            # donation
            self._check_donated()
            if self._fetch is not None:
                self._host = _host_array(_xfer.prefetched(self._fetch))
                self._fetch = None
                return self._host
            if self._dev is not None:
                self._host = to_numpy(self._dev)
            else:
                self._host = np.frombuffer(
                    self._raw, dtype=self._spec.dtype.np_dtype
                ).reshape(self._spec.shape)
        return self._host

    def tobytes(self) -> bytes:
        if self._raw is None:
            if self._host is None and self._dev is not None:
                # straight from the tensor's bytes: no numpy dtype needed
                # (bfloat16 has none without ml_dtypes)
                if self._fetch is not None:
                    flat = _xfer.prefetched(self._fetch).reshape(-1)
                else:
                    flat = _xfer.to_host(
                        self._dev.detach().contiguous().reshape(-1))
                self._raw = flat.view(torch.uint8).numpy().tobytes()
            else:
                self._raw = np.ascontiguousarray(self.np()).tobytes()
        return self._raw

    # -- accessors ----------------------------------------------------------

    @property
    def spec(self) -> TensorSpec:
        return self._spec

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._spec.shape

    @property
    def dtype(self) -> DType:
        return self._spec.dtype

    @property
    def nbytes(self) -> int:
        return self._spec.nbytes

    @property
    def is_device(self) -> bool:
        return self._dev is not None

    @property
    def prefetching(self) -> bool:
        """Whether a host copy of the card payload was started
        (:meth:`prefetch_host`) and not read yet."""
        return self._fetch is not None

    def prefetch_host(self) -> None:
        """Start a non-blocking copy of the card payload into pinned host
        memory on a side stream (``obs/transfer.py`` ``prefetch``), counted
        once in the transfer ledger; a later ``np()`` waits for that copy
        and never makes a second one.  No-op for a host tensor and for
        one whose host copy exists or is in flight."""
        if self._dev is None or self._host is not None \
                or self._fetch is not None or not _xfer.on_card(self._dev):
            return
        self._fetch = _xfer.prefetch(self._dev.detach())

    def seed_host(self, arr: np.ndarray) -> None:
        """Install an already-drained host copy (size-checked) so later
        ``np()`` calls read it instead of paying another device→host
        crossing.  Used by the decoders' single-packed-drain path
        (decoders/__init__.py ``drain_once``)."""
        if arr.nbytes != self._spec.nbytes:
            raise ValueError(
                f"seed_host size mismatch: {arr.nbytes} != "
                f"{self._spec.nbytes}")
        self._host = arr.reshape(self._spec.shape)

    def with_spec(self, spec: TensorSpec) -> "Tensor":
        """Reinterpret payload under a different spec (sizes must match)."""
        if spec.nbytes != self._spec.nbytes:
            raise ValueError(
                f"cannot reinterpret {self._spec} as {spec}: size mismatch")
        if self._dev is not None and self._dev.dtype == spec.dtype.torch_dtype:
            return Tensor(self._dev.reshape(spec.shape), spec)
        host = np.ascontiguousarray(self.np())
        return Tensor(host.view(spec.dtype.np_dtype).reshape(spec.shape), spec)

    def __repr__(self) -> str:
        res = "dev" if self._dev is not None else (
            "host" if self._host is not None else "raw")
        return f"Tensor({self._spec}, {res})"


@dataclasses.dataclass
class Buffer:
    """One frame of the stream: N tensors + timing + routing metadata.

    ``meta`` carries out-of-band routing info; key ``"client_id"`` is the
    parity of GstMetaQuery.
    """

    tensors: List[Tensor]
    pts: Optional[int] = None
    duration: Optional[int] = None
    offset: Optional[int] = None  # frame index
    format: TensorFormat = TensorFormat.STATIC
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- construction -------------------------------------------------------

    @classmethod
    def of(cls, *arrays, pts: Optional[int] = None, **kw) -> "Buffer":
        return cls(tensors=[a if isinstance(a, Tensor) else Tensor(a)
                            for a in arrays], pts=pts, **kw)

    @classmethod
    def from_bytes_list(cls, payloads: Sequence[bytes], spec: TensorsSpec,
                        pts: Optional[int] = None) -> "Buffer":
        if len(payloads) != spec.num_tensors:
            raise ValueError("payload count mismatch")
        return cls(tensors=[Tensor(p, s) for p, s in zip(payloads, spec.tensors)],
                   pts=pts, format=spec.format)

    # -- accessors ----------------------------------------------------------

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def __len__(self) -> int:
        return len(self.tensors)

    def __getitem__(self, i: int) -> Tensor:
        return self.tensors[i]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors)

    @property
    def residency(self) -> str:
        """Where this frame's payload lives now: ``device`` when every
        tensor is on a card (``obs.transfer.on_card``), ``host`` when
        none is (host arrays, raw bytes, CPU tensors), ``mixed``
        otherwise.  The tracer samples it at element boundaries: each
        flip is a crossing of the frame."""
        if not self.tensors:
            return "host"
        n_dev = sum(1 for t in self.tensors
                    if t._dev is not None and _xfer.on_card(t._dev))
        if n_dev == 0:
            return "host"
        return "device" if n_dev == len(self.tensors) else "mixed"

    def spec(self, rate=None) -> TensorsSpec:
        from fractions import Fraction

        return TensorsSpec(tensors=tuple(t.spec for t in self.tensors),
                           format=self.format,
                           rate=Fraction(rate) if rate is not None else Fraction(0, 1))

    def replace_tensors(self, tensors: Sequence[Tensor]) -> "Buffer":
        return dataclasses.replace(self, tensors=list(tensors))

    def mark_donated(self) -> None:
        """Mark every device-resident tensor of this frame donated (see
        :meth:`Tensor.mark_donated`)."""
        for t in self.tensors:
            t.mark_donated()

    # -- wire form (flexible streams) ----------------------------------------

    def pack_flexible(self, media_type: MediaType = MediaType.TENSOR) -> List[bytes]:
        """Each tensor as ``meta-header || payload`` (parity:
        flexible-tensor memories, nnstreamer_plugin_api_impl.c flex path)."""
        out = []
        for t in self.tensors:
            mi = MetaInfo.from_spec(t.spec, format=TensorFormat.FLEXIBLE,
                                    media_type=media_type)
            out.append(mi.pack() + t.tobytes())
        return out

    @classmethod
    def unpack_flexible(cls, payloads: Sequence[bytes],
                        pts: Optional[int] = None) -> "Buffer":
        tensors = []
        for p in payloads:
            mi = MetaInfo.unpack(p)
            body = p[mi.header_size:]
            if len(body) != mi.data_nbytes():
                raise ValueError(
                    f"flexible payload size {len(body)} != {mi.data_nbytes()}")
            tensors.append(Tensor(body, mi.to_spec()))
        return cls(tensors=tensors, pts=pts, format=TensorFormat.FLEXIBLE)


# -- sparse codec -----------------------------------------------------------
# Parity: the JAX package's ``sparse_from_dense``/``sparse_to_dense`` (the
# reference's gst_tensor_sparse_from_dense / gst_tensor_sparse_to_dense,
# gsttensor_sparseutil.c:31,116).  Layout: sparse meta header (with nnz),
# then u32 flat indices, then values.  The bytes equal the JAX codec's for
# every dtype: NaN is stored (it is nonzero), -0.0 is not (it equals 0).

#: a signed integer dtype per element size: an integer is zero exactly
#: when its bits are, so unsigned tensors are tested through these views
_SIGNED_BY_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}


def _sparse_parts_torch(x: torch.Tensor) -> Tuple[int, bytes]:
    """(nnz, indices ‖ values bytes) of a tensor, found where it lives:
    the nonzeros are selected on its device and the indices and values
    cross to the host in ONE copy; the dense tensor never does."""
    flat = x.detach().contiguous().reshape(-1)
    esize = flat.element_size()
    test = flat if flat.dtype.is_floating_point \
        else flat.view(_SIGNED_BY_SIZE[esize])
    idx = torch.nonzero(test != 0).reshape(-1)
    vals = flat.view(torch.uint8).reshape(-1, esize)[idx].reshape(-1)
    packed = torch.cat([idx.to(torch.int32).view(torch.uint8), vals])
    return int(idx.numel()), _xfer.to_host(packed).numpy().tobytes()


def sparse_from_dense(t: Tensor) -> bytes:
    """The sparse wire form of one tensor.  A tensor resident on a device
    is encoded there (:func:`_sparse_parts_torch`); a host or wire tensor
    with numpy, as the JAX package does."""
    if t.is_device:
        nnz, body = _sparse_parts_torch(t.torch())
    else:
        arr = np.ascontiguousarray(t.np()).reshape(-1)
        idx = np.nonzero(arr)[0].astype(np.uint32)
        nnz, body = len(idx), idx.tobytes() + arr[idx].tobytes()
    mi = MetaInfo.from_spec(t.spec, format=TensorFormat.SPARSE, nnz=nnz)
    return mi.pack() + body


def sparse_to_dense(payload: bytes) -> Tensor:
    """The dense host tensor of one sparse payload.  The values are
    scattered as bytes, so bfloat16 needs no numpy dtype."""
    mi = MetaInfo.unpack(payload)
    if mi.format != TensorFormat.SPARSE:
        raise ValueError("payload is not sparse")
    esize = mi.dtype.size
    off = mi.header_size
    idx = np.frombuffer(payload, dtype=np.uint32, count=mi.nnz, offset=off)
    off += mi.nnz * 4
    vals = np.frombuffer(payload, dtype=np.uint8, count=mi.nnz * esize,
                         offset=off).reshape(mi.nnz, esize)
    spec = mi.to_spec()
    dense = np.zeros((spec.num_elements, esize), np.uint8)
    dense[idx] = vals
    if mi.dtype is DType.BFLOAT16:
        return Tensor(dense.tobytes(), spec)
    return Tensor(dense.view(mi.dtype.np_dtype).reshape(mi.shape), spec)
