"""``tensor_if`` — data-dependent stream branching.

Counterpart of the JAX package's ``elements/condition.py`` (parity: the
reference's gsttensor_if.c) with
- compared-value sources {A_VALUE, TENSOR_TOTAL_VALUE, ALL_TENSORS_TOTAL,
  TENSOR_AVERAGE_VALUE, ALL_TENSORS_AVERAGE, CUSTOM} (gsttensor_if.h:42-55);
- 10 operators incl. ranges (:60-72);
- then/else behaviors {PASSTHROUGH, SKIP, FILL_ZERO, FILL_VALUES,
  REPEAT_PREVIOUS_FRAME, TENSORPICK} (:79-91);
- a registrable custom predicate callback (include/tensor_if.h).

On the device: the compared value is reduced where the tensor lives, and
only the scalar verdict crosses to the host — one copy a frame, recorded
in the transfer ledger (``obs/transfer.py``),
which waits for the work that computes the tensor (the filter upstream):
the element cannot route a frame before its value exists.  A device error
raises; the port does not retry on the host (the JAX element does).
``FILL_ZERO``/``FILL_VALUES`` make their tensors on the frame's device.

Shared storage: a frame this element may push again
(``REPEAT_PREVIOUS_FRAME``) is kept as its own handles and marked shared
(``Tensor.shared_view``), so a downstream ``donate=true`` never writes
into it, and the repeat reads the frame as it was.

``offload=then|else`` names the branch that feeds the heavy stage of a
cascade: each routing decision is recorded into the stage store
(``obs/stagestat.py``, ``nns_cascade_offload_ratio``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, Tensor
from ..obs import stagestat as _stagestat
from ..obs import transfer as _xfer
from ..runtime.element import Element, NegotiationError, Pad, StreamError
from ..runtime.registry import register_element
from .combiners import parse_tensorpick

# -- custom predicate registry (parity: nns_tensor_if_custom_register) ------

_custom_preds: Dict[str, Callable] = {}
_custom_lock = threading.Lock()


def register_if_callback(name: str, fn: Callable[[Buffer], bool]) -> None:
    with _custom_lock:
        _custom_preds[name] = fn


def unregister_if_callback(name: str) -> None:
    with _custom_lock:
        _custom_preds.pop(name, None)


_OPS = ("eq", "ne", "gt", "ge", "lt", "le",
        "range_inclusive", "range_exclusive",
        "not_in_range_inclusive", "not_in_range_exclusive")


def _reduce(x: torch.Tensor, kind: str, flat_idx: int = 0) -> torch.Tensor:
    """The compared value of one device tensor, still on its device: one
    element, or the sum or mean in float64 (numpy's sum of an integer
    tensor does not wrap, and its mean is a float64)."""
    if kind == "at":
        return x.reshape(-1)[flat_idx]
    x = x.to(torch.float64)
    return x.sum() if kind == "sum" else x.mean()


@register_element("tensor_if")
class TensorIf(Element):
    """1 sink → ``src_then`` / ``src_else`` pads."""

    FACTORY = "tensor_if"

    def __init__(self, name=None, compared_value: str = "A_VALUE",
                 compared_value_option: str = "0:0",
                 supplied_value: str = "0",
                 operator: str = "eq",
                 then: str = "PASSTHROUGH", then_option: str = "",
                 else_: str = "SKIP", else_option: str = "",
                 offload: str = "", **props):
        self.compared_value = compared_value
        self.compared_value_option = compared_value_option
        self.supplied_value = supplied_value
        self.operator = operator
        self.then = then
        self.then_option = then_option
        self.else_ = else_
        self.else_option = else_option
        # conditional-cascade marker: which branch feeds the heavy stage
        # (validated at start; see the module doc)
        self.offload = offload
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad("src_then")
        self.add_src_pad("src_else")
        self._prev: Dict[str, Optional[Buffer]] = {
            "src_then": None, "src_else": None}
        #: scalar device→host copies made for verdicts
        self.verdict_copies = 0

    def set_property(self, key, value):
        if key in ("else", "else-option"):
            key = "else_" if key == "else" else "else_option"
        super().set_property(key, value)

    @property
    def then_pad(self) -> Pad:
        return self.srcpads[0]

    @property
    def else_pad(self) -> Pad:
        return self.srcpads[1]

    # -- predicate -----------------------------------------------------------

    def _item(self, v: torch.Tensor) -> float:
        """The one scalar copy a verdict makes."""
        self.verdict_copies += 1
        return float(_xfer.item(v))

    def _scalar(self, t: Tensor, kind: str, flat_idx: int = 0) -> float:
        """One predicate scalar from one tensor: reduced on its device
        when it lives there (only the scalar crosses), with numpy on the
        host otherwise."""
        if t.is_device:
            return self._item(_reduce(t.torch(), kind, flat_idx))
        a = t.np()
        if kind == "at":
            return float(a.reshape(-1)[flat_idx])
        return float(a.sum() if kind == "sum" else a.mean())

    def _compared(self, buf: Buffer) -> float:
        cv = str(self.compared_value).upper()
        opt = str(self.compared_value_option)
        if cv == "CUSTOM":
            with _custom_lock:
                fn = _custom_preds.get(opt)
            if fn is None:
                raise StreamError(f"{self.name}: no custom callback {opt!r}")
            return 1.0 if fn(buf) else 0.0
        if cv == "A_VALUE":
            # option "<flat_index>:<tensor_index>" (innermost-first flat idx)
            idx_s, _, ti_s = opt.partition(":")
            ti = int(ti_s or 0)
            return self._scalar(buf.tensors[ti], "at", int(idx_s or 0))
        if cv in ("TENSOR_TOTAL_VALUE", "TENSOR_TOTAL"):
            return self._scalar(buf.tensors[int(opt or 0)], "sum")
        if cv in ("ALL_TENSORS_TOTAL", "ALL_TOTAL"):
            return self._total(buf.tensors)
        if cv in ("TENSOR_AVERAGE_VALUE", "AVERAGE"):
            return self._scalar(buf.tensors[int(opt or 0)], "mean")
        if cv in ("ALL_TENSORS_AVERAGE", "ALL_AVERAGE"):
            if any(t.is_device for t in buf.tensors):
                # element-count-weighted mean == mean of the concatenation
                n = sum(t.spec.num_elements for t in buf.tensors)
                return self._total(buf.tensors) / max(n, 1)
            vals = np.concatenate([t.np().reshape(-1) for t in buf.tensors])
            return float(vals.mean())
        raise StreamError(f"{self.name}: unknown compared-value {cv!r}")

    def _total(self, tensors: List[Tensor]) -> float:
        """Sum over every tensor: the device tensors' sums are added on
        the device, so the frame still makes one scalar copy."""
        dev = [_reduce(t.torch(), "sum") for t in tensors if t.is_device]
        host = sum(float(t.np().sum()) for t in tensors if not t.is_device)
        if not dev:
            return float(host)
        return self._item(torch.stack(
            [d.to(dev[0].device) for d in dev]).sum()) + host

    def _verdict(self, buf: Buffer) -> bool:
        if str(self.compared_value).upper() == "CUSTOM":
            return bool(self._compared(buf))
        x = self._compared(buf)
        sv = [float(v) for v in str(self.supplied_value).split(":")]
        op = str(self.operator).lower()
        if op not in _OPS:
            raise StreamError(f"{self.name}: unknown operator {op!r}")
        if op == "eq":
            return x == sv[0]
        if op == "ne":
            return x != sv[0]
        if op == "gt":
            return x > sv[0]
        if op == "ge":
            return x >= sv[0]
        if op == "lt":
            return x < sv[0]
        if op == "le":
            return x <= sv[0]
        lo, hi = sv[0], sv[1]
        inside_incl = lo <= x <= hi
        inside_excl = lo < x < hi
        if op == "range_inclusive":
            return inside_incl
        if op == "range_exclusive":
            return inside_excl
        if op == "not_in_range_inclusive":
            return not inside_incl
        return not inside_excl

    # -- behaviors -----------------------------------------------------------

    @staticmethod
    def _filled(t: Tensor, value: float) -> Tensor:
        """A tensor of ``t``'s spec filled with ``value``, made where ``t``
        lives, with its dtype (numpy's cast of the value for the host)."""
        if t.is_device:
            x = t.torch()
            return Tensor(torch.full(x.shape, value, dtype=x.dtype,
                                     device=x.device), t.spec)
        return Tensor(np.full(t.spec.shape, value, t.spec.dtype.np_dtype),
                      t.spec)

    def _apply_behavior(self, behavior: str, option: str, buf: Buffer,
                        pad_name: str) -> Optional[Buffer]:
        b = str(behavior).upper()
        if b == "PASSTHROUGH":
            return buf
        if b == "SKIP":
            return None
        if b == "FILL_ZERO":
            return buf.replace_tensors(
                [self._filled(t, 0) for t in buf.tensors])
        if b == "FILL_VALUES":
            v = float(option or 0)
            return buf.replace_tensors(
                [self._filled(t, v) for t in buf.tensors])
        if b in ("REPEAT_PREVIOUS_FRAME", "REPEAT_PREV"):
            prev = self._prev[pad_name]
            if prev is None:
                return None
            return prev.replace_tensors(prev.tensors)
        if b == "TENSORPICK":
            picks = [i for grp in parse_tensorpick(option) for i in grp]
            return buf.replace_tensors([buf.tensors[i] for i in picks])
        raise StreamError(f"{self.name}: unknown behavior {behavior!r}")

    # -- flow ----------------------------------------------------------------

    def negotiate_src_pads(self) -> None:
        in_caps = self.sinkpad.caps
        for sp in self.srcpads:
            if sp.peer is None or sp.caps is not None:
                continue
            beh = self.then if sp.name == "src_then" else self.else_
            opt = self.then_option if sp.name == "src_then" \
                else self.else_option
            caps = in_caps
            if str(beh).upper() == "TENSORPICK" and self.sinkpad.spec:
                picks = [i for grp in parse_tensorpick(opt) for i in grp]
                spec = self.sinkpad.spec
                caps = Caps.from_spec(spec.with_tensors(
                    [spec.tensors[i] for i in picks]))
            m = caps.intersect(sp.peer.template)
            if m.is_empty():
                raise NegotiationError(
                    f"{self.name}.{sp.name}: downstream refuses {caps}")
            sp.caps = m.fixate()
            try:
                sp.spec = sp.caps.to_spec()
            except ValueError:
                sp.spec = None
            sp.peer.element.set_caps(sp.peer, sp.caps)

    def start(self) -> None:
        off = str(self.offload or "").strip().lower()
        if off not in ("", "then", "else"):
            raise ValueError(
                f"{self.name}: offload={self.offload!r} must be "
                f"'then' or 'else' (the branch feeding the heavy stage)")
        self.offload = off

    def chain(self, pad: Pad, buf: Buffer) -> None:
        take_then = self._verdict(buf)
        if self.offload:
            # cascade accounting: the DECISION counts (a SKIP on the kept
            # branch still was a routing verdict)
            _stagestat.record_offload(
                self.pipeline.name if self.pipeline is not None else "",
                self.name, take_then == (self.offload == "then"))
        pad_name = "src_then" if take_then else "src_else"
        behavior = self.then if take_then else self.else_
        option = self.then_option if take_then else self.else_option
        out = self._apply_behavior(behavior, option, buf, pad_name)
        if out is None:
            return
        # kept for a later REPEAT_PREVIOUS_FRAME as handles of its own
        self._prev[pad_name] = out.replace_tensors(
            [t.shared_view() for t in out.tensors])
        target = self.then_pad if take_then else self.else_pad
        if target.peer is not None:
            self.push(out, pad=target)
