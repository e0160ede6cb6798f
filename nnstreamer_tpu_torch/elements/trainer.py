"""``tensor_trainer`` — in-pipeline training node.

Counterpart of the JAX package's ``elements/trainer.py``.  Parity target:
the reference's gst/nnstreamer/elements/gsttensor_trainer.c (props
``framework``, ``model-config``, ``model-save-path``,
``model-load-path``, ``num-inputs``, ``num-labels``,
``num-training-samples``, ``num-validation-samples``, ``epochs`` —
:94-104): each incoming buffer is ONE sample whose first ``num-inputs``
tensors are model inputs and next ``num-labels`` tensors are labels; the
trainer sub-plugin trains asynchronously and signals
EPOCH/TRAINING_COMPLETION through its notifier; the element pushes a
per-sample status tensor downstream ([epoch, training_loss,
training_accuracy, validation_loss, validation_accuracy], float64) and
holds EOS until training completes (gsttensor_trainer.c:889).

The element is thin control flow: sample ingest stays on the streaming
thread, which waits only at the epoch boundary (parity:
wait_for_epoch_completion, gsttensor_trainer.c:561-593).  The samples go
to the sub-plugin as tensors where they lie — a sample on the card stays
on the card — and the sub-plugin runs on the pipeline's device
(``TrainerProps.device``).  The analyzer's dry run (a pipeline on the
``meta`` device) checks the tensor count and the status caps and opens
no sub-plugin.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core import Buffer, Caps, Tensor, TensorsSpec
from ..runtime.element import Element, NegotiationError, Pad, StreamError
from ..runtime.events import Event, EventKind, Message, MessageKind
from ..runtime.registry import register_element
from ..trainers import (
    EVENT_EPOCH_COMPLETION,
    EVENT_TRAINING_COMPLETION,
    TrainerError,
    TrainerProps,
    find_trainer,
)
from ..utils.profile import GATE

STATUS_FIELDS = ("epoch", "training_loss", "training_accuracy",
                 "validation_loss", "validation_accuracy")


@register_element("tensor_trainer")
class TensorTrainer(Element):
    FACTORY = "tensor_trainer"

    def __init__(self, name=None, framework: str = "torch-optim",
                 model_config=None, model_save_path: str = "",
                 model_load_path: str = "", num_inputs: int = 1,
                 num_labels: int = 1, num_training_samples: int = 0,
                 num_validation_samples: int = 0, epochs: int = 1,
                 completion_timeout: float = 300.0, **props):
        self.framework = framework
        self.model_config = model_config
        self.model_save_path = model_save_path
        self.model_load_path = model_load_path
        self.num_inputs = num_inputs
        self.num_labels = num_labels
        self.num_training_samples = num_training_samples
        self.num_validation_samples = num_validation_samples
        self.epochs = epochs
        self.completion_timeout = completion_timeout
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self.subplugin = None
        self._pushed = 0
        self._epoch_evt = threading.Event()
        self._done_evt = threading.Event()

    # -- open -----------------------------------------------------------------

    def _open(self) -> None:
        if self.subplugin is not None:
            return
        cls = find_trainer(self.framework)
        sp = cls()
        sp.configure(TrainerProps(
            framework=self.framework, model_config=self.model_config,
            model_save_path=self.model_save_path,
            model_load_path=self.model_load_path,
            num_inputs=int(self.num_inputs),
            num_labels=int(self.num_labels),
            num_training_samples=int(self.num_training_samples),
            num_validation_samples=int(self.num_validation_samples),
            num_epochs=int(self.epochs), device=self.device), self._notify)
        self.subplugin = sp

    def _notify(self, event: str, data: dict) -> None:
        """Sub-plugin notifier → bus messages + downstream events
        (parity: TRAINER_EVENT_* through GstTensorTrainerEventNotifier)."""
        self.post_message(Message(MessageKind.ELEMENT, self.name,
                                  data={"event": event, **data}))
        if event == EVENT_EPOCH_COMPLETION:
            self._epoch_evt.set()
            self.forward_event(Event(EventKind.EPOCH_COMPLETE, dict(data)))
        elif event == EVENT_TRAINING_COMPLETION:
            self._done_evt.set()
            self.forward_event(
                Event(EventKind.TRAINING_COMPLETE, dict(data)))

    # -- negotiation ----------------------------------------------------------

    def pad_template_caps(self, pad: Pad) -> Caps:
        return Caps.any_tensors()

    def caps_negotiated(self, pad: Pad) -> None:
        spec = pad.spec
        need = int(self.num_inputs) + int(self.num_labels)
        if spec is not None and spec.is_static() and \
                spec.num_tensors < need:
            raise NegotiationError(
                f"{self.name}: stream has {spec.num_tensors} tensors but "
                f"num-inputs+num-labels = {need}")
        if self.device.type != "meta":
            self._open()

    def propose_src_caps(self, pad: Pad) -> Caps:
        rate = self.sinkpad.spec.rate if self.sinkpad.spec else None
        spec = TensorsSpec.parse("5:1", "float64")
        if rate:
            spec = spec.with_rate(rate)
        return Caps.from_spec(spec)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._open()
        self.subplugin.start()

    def stop(self) -> None:
        if self.subplugin is not None:
            self.subplugin.stop()
            self.subplugin = None

    # -- hot path -------------------------------------------------------------

    def chain(self, pad: Pad, buf: Buffer) -> None:
        sp = self.subplugin
        if sp is None:
            raise StreamError(f"{self.name}: trainer not opened")
        ni, nl = int(self.num_inputs), int(self.num_labels)
        if buf.num_tensors < ni + nl:
            raise StreamError(
                f"{self.name}: sample has {buf.num_tensors} tensors, "
                f"need {ni + nl}")
        inputs = [buf.tensors[i].torch() for i in range(ni)]
        labels = [buf.tensors[ni + i].torch() for i in range(nl)]
        try:
            sp.push_data(inputs, labels)
        except TrainerError as e:
            raise StreamError(str(e)) from e
        self._pushed += 1
        per_epoch = int(self.num_training_samples) + \
            int(self.num_validation_samples)
        if per_epoch and self._pushed % per_epoch == 0:
            # epoch boundary: wait for the sub-plugin to finish the epoch
            # before feeding the next one (parity:
            # gst_tensor_trainer_wait_for_epoch_completion); wake early
            # if the trainer died so the error surfaces instead of a hang
            deadline = time.monotonic() + float(self.completion_timeout)
            with GATE.outside():
                while not self._epoch_evt.wait(timeout=0.2):
                    err = sp.error
                    if err is not None:
                        raise StreamError(
                            f"{self.name}: training failed: {err}")
                    if self._done_evt.is_set():
                        break
                    if time.monotonic() > deadline:
                        raise StreamError(
                            f"{self.name}: epoch did not complete within "
                            f"{self.completion_timeout}s")
            self._epoch_evt.clear()
        if self.srcpad.peer is not None:
            st = sp.get_status()
            arr = np.array([[st.get(k, 0.0) for k in STATUS_FIELDS]],
                           np.float64).reshape(1, 5)
            self.push(Buffer(tensors=[Tensor(arr)], pts=buf.pts,
                             meta=dict(buf.meta)))

    # -- EOS gating -----------------------------------------------------------

    def handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.EOS:
            # hold EOS until training completes (parity:
            # gsttensor_trainer.c:889 "got EOS but training is not
            # completed")
            done = self.subplugin.finished if self.subplugin else None
            with GATE.outside():
                finished = done is None or done.wait(
                    timeout=self.completion_timeout)
            if not finished:
                self.post_error(StreamError(
                    f"{self.name}: EOS but training did not complete "
                    f"within {self.completion_timeout}s"))
        super().handle_event(pad, event)
