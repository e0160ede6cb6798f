"""Filter sub-plugin ABI (near-copy of the JAX package's ``filters/api.py``).

Parity target: the reference's v1 filter framework ABI
(nnstreamer:gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:247-469):
open/close lifecycle, ``invoke``, model-info queries incl. SET_INPUT_INFO
reshape, event handling, the micro-batched ``invoke_batched`` entry point,
the hot-reload pair ``prepare_swap``/``commit_swap`` (a framework without
hot reload raises), shared opens for the serving pool, and the shared-model
table
(nnstreamer_plugin_api_filter.h:551-590).

In the port, ``invoke`` consumes and produces ``torch.Tensor``s on the
sub-plugin's device; outputs are freshly allocated by the framework
(allocate-in-invoke).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import TensorsSpec
from ..runtime.events import Event


@dataclasses.dataclass
class FilterProps:
    """Parsed ``tensor_filter`` properties handed to sub-plugin
    ``configure`` (parity: GstTensorFilterProperties)."""

    framework: str = ""
    model: Any = None          # registered name or in-process object
    accelerator: str = ""      # e.g. "true:gpu", "cuda", "cpu"
    custom: str = ""           # free-form custom_properties
    input_spec: Optional[TensorsSpec] = None   # user-forced input info
    output_spec: Optional[TensorsSpec] = None
    #: the pipeline's device; ``accelerator=`` may override it
    device: Optional[torch.device] = None
    shared_key: Optional[str] = None  # shared-model table key
    is_updatable: bool = False        # hot reload allowed


class FilterError(Exception):
    pass


class FilterSubplugin:
    """Abstract base for filter frameworks (torch-cuda, …).

    Lifecycle: ``configure(props)`` → ``get_model_info()`` (and optionally
    ``set_input_info``) during negotiation → ``invoke`` per frame → ``close``.
    """

    #: registry name, e.g. "torch-cuda"
    NAME: str = ""
    #: hardware the framework can run on (parity: getFrameworkInfo hw list)
    ACCELERATORS: Tuple[str, ...] = ("cpu",)
    #: outputs are freshly allocated by invoke
    ALLOCATE_IN_INVOKE: bool = True
    #: sub-plugin implements ``invoke_batched(frames, bucket)`` — run a
    #: micro-batched window of frames as ONE dispatch (see
    #: runtime/batching.py).  Frameworks without it still work under
    #: ``tensor_filter batch>1``: the element falls back to per-frame
    #: ``invoke`` inside the coalesced window (ordering/flush semantics
    #: preserved, no dispatch reduction).
    SUPPORTS_BATCH: bool = False

    def __init__(self):
        self.props: Optional[FilterProps] = None
        #: where invoke expects its inputs (set by configure)
        self.device: Optional[torch.device] = None

    # -- lifecycle -----------------------------------------------------------

    def configure(self, props: FilterProps) -> None:
        """Parity: open() / configure_instance()."""
        self.props = props

    def close(self) -> None:
        pass

    # -- shared open (serving pool, runtime/serving.py) ----------------------

    @classmethod
    def open_shared(cls, props: FilterProps) -> "FilterSubplugin":
        """Open an instance for shared use across filter elements (the
        ModelPool path): a fresh configured instance.  The pool opens
        one per key and ref-counts it, so every sharer of a key holds
        this one instance (one set of weights on the card)."""
        sp = cls()
        sp.configure(props)
        return sp

    @classmethod
    def close_shared(cls, sp: "FilterSubplugin") -> None:
        """Release an instance obtained from :meth:`open_shared`
        (default: close it — pairs with the default open)."""
        sp.close()

    # -- model info ----------------------------------------------------------

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        """Return (input_spec, output_spec)."""
        raise NotImplementedError

    def set_input_info(self, in_spec: TensorsSpec
                       ) -> Tuple[TensorsSpec, TensorsSpec]:
        """Reshape the model for a new input schema; return updated
        (in, out).  Default: reject."""
        raise FilterError(
            f"{self.NAME}: model cannot be reshaped to {in_spec}")

    # -- hot path ------------------------------------------------------------

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        """Run the model on one frame's tensors (device tensors in,
        device tensors out)."""
        raise NotImplementedError

    # -- hot reload (runtime/lifecycle.py) ------------------------------------

    def model_name(self) -> str:
        """The served model's identity (a path, a registered name)."""
        return ""

    def prepare_swap(self, model: Any, buckets: Sequence[int] = (),
                     warm: bool = True) -> "FilterSubplugin":
        """Load ``model`` into a warmed shadow instance off the dispatch
        path.  Default: this framework has no hot reload."""
        raise FilterError(f"{self.NAME}: this framework has no hot reload")

    def commit_swap(self, shadow: Any) -> None:
        """Flip a prepared shadow in.  Default: no hot reload."""
        raise FilterError(f"{self.NAME}: this framework has no hot reload")

    # -- events --------------------------------------------------------------

    def handle_event(self, event: Event) -> None:
        """RELOAD_MODEL etc. (parity: eventHandler)."""


class SharedModelTable:
    """key → opened representation shared across filter instances
    (parity: nnstreamer_filter_shared_model_get/insert/remove,
    nnstreamer_plugin_api_filter.h:551-590)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, Any] = {}

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._table.get(key)

    def insert(self, key: str, value: Any) -> Any:
        with self._lock:
            return self._table.setdefault(key, value)

    def remove(self, key: str) -> None:
        with self._lock:
            self._table.pop(key, None)


#: the process-wide ``shared-tensor-filter-key`` table
SHARED_MODELS = SharedModelTable()
