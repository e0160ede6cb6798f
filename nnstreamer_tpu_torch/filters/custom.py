"""Custom filter adapters: ``custom-easy`` (and its alias ``custom``) and
``python3``.

Counterpart of the JAX package's ``filters/custom.py`` (parity: the
reference's ``NNS_custom_easy_register``,
include/tensor_filter_custom_easy.h:56-66, and the python3 sub-plugin's
``CustomFilter`` class with ``invoke/getInputDim/getOutputDim/
setInputDim``, tensor_filter_python3.cc:265-301).

These are host numpy callbacks, as in the JAX package: escape hatches,
not the device path.  They declare ``HOST_INVOKE``, so ``tensor_filter``
copies a buffer's device tensors to the host in one packed copy
(``drain_once``) and hands them over as numpy arrays; their numpy outputs
travel on as host tensors.  The port keeps its own registry of
custom-easy models, never the JAX package's.
"""

from __future__ import annotations

import importlib.util
import os
import threading
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import DType, TensorSpec, TensorsSpec
from ..core.buffer import to_numpy
from .api import FilterError, FilterProps, FilterSubplugin
from .registry import register_filter

# -- custom-easy -------------------------------------------------------------

_easy_models: Dict[str, Tuple[Callable, TensorsSpec, TensorsSpec]] = {}
_easy_lock = threading.Lock()


def register_custom_easy(name: str, fn: Callable,
                         in_spec: TensorsSpec, out_spec: TensorsSpec) -> str:
    """Register ``fn(list[np.ndarray]) -> list[np.ndarray]`` as a model."""
    with _easy_lock:
        _easy_models[name] = (fn, in_spec, out_spec)
    return name


def unregister_custom_easy(name: str) -> None:
    with _easy_lock:
        _easy_models.pop(name, None)


def easy_model_registered(name: str) -> bool:
    with _easy_lock:
        return name in _easy_models


def _host(x: Any) -> np.ndarray:
    """A model input as a numpy array (a torch tensor that reached the
    sub-plugin directly, e.g. from a micro-batched window, is copied)."""
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _outputs(out: Any) -> List[Any]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


class _HostFilter(FilterSubplugin):
    """A framework whose model runs on the host with numpy."""

    ACCELERATORS = ("cpu",)
    ALLOCATE_IN_INVOKE = True
    #: tensor_filter hands this framework host arrays (see the module doc)
    HOST_INVOKE = True

    def configure(self, props: FilterProps) -> None:
        super().configure(props)
        self.device = torch.device("cpu")


@register_filter
class CustomEasyFilter(_HostFilter):
    NAME = "custom-easy"

    def __init__(self):
        super().__init__()
        self._fn = None
        self._in_spec = None
        self._out_spec = None

    def configure(self, props: FilterProps) -> None:
        super().configure(props)
        model = props.model
        if callable(model):
            self._fn = model
            self._in_spec = props.input_spec
            self._out_spec = props.output_spec
            if self._in_spec is None or self._out_spec is None:
                raise FilterError(
                    "custom-easy: callable model needs input_spec and "
                    "output_spec")
            return
        with _easy_lock:
            entry = _easy_models.get(model)
        if entry is None:
            raise FilterError(f"custom-easy: no registered model {model!r}")
        self._fn, self._in_spec, self._out_spec = entry

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        return self._in_spec, self._out_spec

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        return _outputs(self._fn([_host(x) for x in inputs]))


@register_filter
class CustomFilter(CustomEasyFilter):
    """``framework=custom`` — name alias of the callable-model path (the
    reference loads a user .so there; here a user filter is a Python
    callable or a registered model)."""

    NAME = "custom"


# -- python3 -----------------------------------------------------------------


@register_filter
class Python3Filter(_HostFilter):
    """Load a user .py file whose ``CustomFilter`` class implements
    ``invoke(list[np.ndarray])`` and declares I/O specs via
    ``getInputDim/getOutputDim`` (returning TensorsSpec or
    (dims-string, types-string)) — optionally ``setInputDim`` for reshape."""

    NAME = "python3"

    def __init__(self):
        super().__init__()
        self._obj = None

    def configure(self, props: FilterProps) -> None:
        super().configure(props)
        path = props.model
        if not isinstance(path, str) or not os.path.isfile(path):
            raise FilterError(f"python3: model script not found: {path!r}")
        spec = importlib.util.spec_from_file_location(
            f"nns_torch_py_filter_{abs(hash(path))}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cls = getattr(mod, "CustomFilter", None)
        if cls is None:
            raise FilterError(f"python3: {path} defines no CustomFilter class")
        self._obj = cls(*([] if not props.custom else [props.custom]))

    @staticmethod
    def _spec_of(raw) -> TensorsSpec:
        if isinstance(raw, TensorsSpec):
            return raw
        if isinstance(raw, (list, tuple)) and raw and \
                isinstance(raw[0], (list, tuple)):
            # list of per-tensor (dims, dtype) pairs — the reference
            # script style (nns.TensorShape analogs)
            tensors = []
            for dims, dt in raw:
                if not isinstance(dt, DType):
                    dt = DType.from_np(dt)
                if isinstance(dims, str):
                    tensors.append(TensorSpec.parse(dims, str(dt)))
                else:
                    tensors.append(TensorSpec(dtype=dt, dims=tuple(dims)))
            return TensorsSpec.of(*tensors)
        dims, types = raw
        return TensorsSpec.parse(dims, types)

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        return (self._spec_of(self._obj.getInputDim()),
                self._spec_of(self._obj.getOutputDim()))

    def set_input_info(self, in_spec: TensorsSpec
                       ) -> Tuple[TensorsSpec, TensorsSpec]:
        if not hasattr(self._obj, "setInputDim"):
            return super().set_input_info(in_spec)
        out = self._obj.setInputDim(in_spec)
        return in_spec, self._spec_of(out)

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        return _outputs(self._obj.invoke([_host(x) for x in inputs]))
