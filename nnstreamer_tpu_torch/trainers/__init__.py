"""Trainer sub-plugin layer: in-pipeline training backends.

Counterpart of the JAX package's ``trainers/``: the trainer sub-plugin
ABI (``configure/start/stop/push_data/get_status/save`` plus a notifier
the sub-plugin uses to signal ``epoch-completion`` /
``training-completion``), consumed by the ``tensor_trainer`` element.

The flagship backend is :mod:`.torch_optim` (``torch-optim``), the
counterpart of ``jax-optax``: it trains with the sharded step of
``parallel/sharded.py`` (``train_step``) and a ``torch.optim`` optimizer.
:mod:`.checkpoint` holds the step-directory helpers.

One field is the port's own: ``TrainerProps.device``, the pipeline's
device, on which a backend runs its step (the JAX package's trainer
takes its devices from the mesh alone).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Type

# event types the sub-plugin sends through its notifier
# (parity: GstTensorTrainerEventType)
EVENT_EPOCH_COMPLETION = "epoch-completion"
EVENT_TRAINING_COMPLETION = "training-completion"


@dataclasses.dataclass
class TrainerProps:
    """Read-only trainer configuration (parity:
    GstTensorTrainerProperties)."""

    framework: str = ""
    model_config: Any = None      # dict, or path to a JSON config
    model_save_path: str = ""
    model_load_path: str = ""
    num_inputs: int = 1
    num_labels: int = 1
    num_training_samples: int = 0
    num_validation_samples: int = 0
    num_epochs: int = 1
    device: Any = None            # the pipeline's torch.device (None: cuda)


class TrainerError(Exception):
    pass


class TrainerSubplugin:
    """Base class every trainer backend implements.

    ``error`` and ``finished`` are part of the ABI: the element polls
    ``error`` to surface failures instead of blocking a full epoch
    timeout, and waits on ``finished`` to gate EOS on training
    completion."""

    NAME: str = ""

    def __init__(self):
        self.props: Optional[TrainerProps] = None
        self.notify: Optional[Callable[[str, Dict], None]] = None
        self.error: Optional[BaseException] = None
        self.finished = threading.Event()

    def configure(self, props: TrainerProps,
                  notify: Callable[[str, Dict], None]) -> None:
        """create(): resolve the model/optimizer from props."""
        self.props = props
        self.notify = notify

    def start(self) -> None:
        """Begin accepting samples (training may run asynchronously)."""

    def push_data(self, inputs: List, labels: List,
                  is_validation: bool = False) -> None:
        """Feed ONE sample (already split into inputs/labels)."""
        raise NotImplementedError

    def get_status(self) -> Dict[str, float]:
        """Current ``epoch``, ``training_loss``, ``training_accuracy``,
        ``validation_loss``, ``validation_accuracy``."""
        raise NotImplementedError

    def save(self, path: str) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        """destroy(): stop training and release resources."""


_lock = threading.Lock()
_trainers: Dict[str, Type[TrainerSubplugin]] = {}


def register_trainer(cls: Type[TrainerSubplugin]) -> Type[TrainerSubplugin]:
    with _lock:
        _trainers[cls.NAME] = cls
    return cls


def find_trainer(name: str) -> Type[TrainerSubplugin]:
    with _lock:
        try:
            return _trainers[name]
        except KeyError:
            known = ", ".join(sorted(_trainers))
            raise KeyError(
                f"no trainer sub-plugin {name!r}; known: {known}") from None


from . import torch_optim  # noqa: E402,F401  (registers the flagship)
