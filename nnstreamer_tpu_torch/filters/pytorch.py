"""``pytorch`` filter framework: TorchScript models in the pipeline.

Counterpart of the JAX package's ``filters/pytorch.py`` (parity: the
reference's tensor_filter_pytorch.cc, which loads a TorchScript file and
invokes it through libtorch).  The JAX package runs the module on the
host and moves tensors across at the filter boundary.  In the port torch
is the device runtime: the module is loaded onto the filter's device —
the pipeline's, or the one ``accelerator=`` names — and takes and returns
tensors on that device, so a TorchScript model on the card reads the
frames where the upstream elements left them.

Output specs: TorchScript carries no tensor schema, so the input spec is
required (``input=``/``inputtype=``) and the output spec, unless given, is
inferred by ONE forward on zeros at the negotiated input shape (at the
batch of the stream: a full forward at a large batch), under the forward
lock: TorchScript modules are not guaranteed thread-safe, and negotiation
can race a streaming invoke.  Output dtypes map through the port's
``DType`` table (bfloat16 included).
"""

from __future__ import annotations

import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..core import DType, TensorsSpec
from ..core.buffer import from_numpy
from ..utils.device import parse_accel_kind, resolve_device
from .api import FilterError, FilterProps, FilterSubplugin
from .registry import register_filter


@register_filter
class PyTorchFilter(FilterSubplugin):
    NAME = "pytorch"
    ACCELERATORS = ("cpu", "cuda")
    ALLOCATE_IN_INVOKE = True

    def __init__(self):
        super().__init__()
        self._model = None
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None
        self._lock = threading.Lock()

    def configure(self, props: FilterProps) -> None:
        super().configure(props)
        kind = parse_accel_kind(props.accelerator)
        if kind is not None:
            self.device = resolve_device(kind)
        else:
            self.device = props.device if props.device is not None \
                else resolve_device("cuda")
        model = props.model
        if isinstance(model, str):
            if not os.path.isfile(model):
                raise FilterError(f"pytorch: no such model file {model!r}")
            try:
                self._model = torch.jit.load(model, map_location=self.device)
            except (RuntimeError, ValueError) as e:
                raise FilterError(
                    f"pytorch: cannot load {model!r}: {e}") from e
        elif hasattr(model, "forward"):
            # an in-process nn.Module / ScriptModule
            self._model = model.to(self.device)
        else:
            raise FilterError(
                f"pytorch: unsupported model object {type(model)}")
        self._model.eval()
        if props.input_spec is None:
            raise FilterError(
                "pytorch: input spec required (TorchScript carries no "
                "tensor schema — pass input=/inputtype= or input_spec)")
        self._in_spec = props.input_spec
        self._out_spec = props.output_spec or \
            self._infer_out_spec(self._in_spec)

    def _forward(self, inputs: Sequence[torch.Tensor]) -> Tuple:
        with self._lock, torch.no_grad():
            return self._out_tensors(self._model(*inputs))

    def _infer_out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        dummies = [torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                               device=self.device) for t in in_spec.tensors]
        try:
            outs = self._forward(dummies)
        except (RuntimeError, TypeError, ValueError) as e:
            raise FilterError(
                f"pytorch: model rejects input {in_spec}: {e}") from e
        try:
            dtypes = [DType.from_torch(o.dtype) for o in outs]
        except ValueError as e:
            raise FilterError(
                f"pytorch: model output dtype unsupported by the tensor "
                f"core: {e}") from e
        return TensorsSpec.from_shapes([tuple(o.shape) for o in outs],
                                       dtypes)

    @staticmethod
    def _out_tensors(out) -> Tuple:
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if not all(isinstance(o, torch.Tensor) for o in outs):
            raise FilterError(
                "pytorch: model output must be a Tensor or a flat "
                f"list/tuple of Tensors, got {type(out).__name__}")
        return tuple(outs)

    def close(self) -> None:
        self._model = None

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        if self._model is None:
            raise FilterError("pytorch: not configured")
        return self._in_spec, self._out_spec

    def set_input_info(self, in_spec: TensorsSpec
                       ) -> Tuple[TensorsSpec, TensorsSpec]:
        # infer FIRST: a rejected reshape must not leave _in_spec and
        # _out_spec describing different schemas
        out_spec = self._infer_out_spec(in_spec)
        self._in_spec, self._out_spec = in_spec, out_spec
        return self._in_spec, self._out_spec

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if self._model is None:
            raise FilterError("pytorch: not configured")
        # a micro-batched window may hand host frames over as numpy
        return list(self._forward(
            [(x if isinstance(x, torch.Tensor) else from_numpy(x))
             .to(self.device) for x in inputs]))
