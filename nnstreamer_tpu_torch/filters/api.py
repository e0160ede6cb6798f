"""Filter sub-plugin ABI (near-copy of the JAX package's ``filters/api.py``).

Parity target: the reference's v1 filter framework ABI
(nnstreamer:gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:247-469):
open/close lifecycle, ``invoke``, model-info queries incl. SET_INPUT_INFO
reshape, and event handling.

In the port, ``invoke`` consumes and produces ``torch.Tensor``s on the
sub-plugin's device; outputs are freshly allocated by the framework
(allocate-in-invoke).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

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

    # -- events --------------------------------------------------------------

    def handle_event(self, event: Event) -> None:
        """RELOAD_MODEL etc. (parity: eventHandler)."""
