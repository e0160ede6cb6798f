"""``torch-optim`` — the flagship trainer sub-plugin.

Counterpart of the JAX package's ``jax-optax``: it micro-batches the
sample stream and trains with the sharded step of
``parallel/sharded.py`` (``train_step``) and a ``torch.optim``
optimizer, on the pipeline's device — the card, or the CPU when the
pipeline asks for it; without a card a CUDA pipeline's trainer raises.

``model-config`` keys:

- ``apply``   — the model's apply fn: a callable, a ``"module:callable"``
  import path, or the name of a model registered with the ``torch-cuda``
  filter
- ``init``    — optional params source: a tree, a callable
  ``init(seed) -> params`` (called with the int ``seed``: the port's
  numpy inits seed as the JAX ones do from ``PRNGKey(seed)``), or
  omitted when ``apply`` names a registered model that carries params /
  ``model_load_path`` is set
- ``optimizer`` — ``"sgd"`` (default, momentum 0.9) / ``"adam"`` /
  ``"adamw"`` (weight decay 1e-4, optax's default)
- ``lr``      — learning rate (default 1e-2)
- ``batch_size`` — micro-batch assembled from the sample stream
  (default 8; rounded up to a multiple of the data-axis size)
- ``mesh``    — mesh spec string, default ``"data:-1"``, over this
  process's records of the pipeline device's platform (every card, or
  the virtual records when set: in a world of several ranks each rank's
  trainer trains alone, as the JAX ``jax-optax`` trainer, whose step
  JAX refuses numpy rows on a mesh across processes); its first data
  shard must lead on the pipeline's device, where the batch is stacked.  Over S > 1 data
  shards the step splits, with the batch statistics over all of them
  (``parallel/sharded.py``, ``parallel/syncbn.py``); a ``model`` axis
  of M > 1 splits the pointwise convolutions and the dense head into M
  slices over each shard's ``model`` group, as the JAX step places them
- ``seed``    — seed for init (default 0)

Training runs on a worker thread, so ``push_data`` blocks only when the
sample queue is full (backpressure).  A sample that arrives on the card
stays there: the worker stacks the samples of a batch where they lie
(a host sample is uploaded once, in its batch).  A sample written on
another CUDA stream than the worker's carries an event the worker waits
on before it reads it.

The saved model (``model-save-path``): a ``.pkl`` dict (``apply``, the
JAX-layout ``params`` tree, ``in_shapes``, ``in_dtypes``) the
``torch-cuda`` filter loads with ``model=<path>.pkl``, or, for a
directory path, an orbax step the JAX package's ``load_orbax`` reads
(``trainers/checkpoint.py``, ``trainers/orbax_write.py``), a split
leaf written a chunk a slice.  The eval
(``training_accuracy``, the validation numbers) runs the apply without
``train``, on the stored ``mean``/``var`` leaves that training never
sets — as the JAX trainer does.
"""

from __future__ import annotations

import importlib
import pickle
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import (
    EVENT_EPOCH_COMPLETION,
    EVENT_TRAINING_COMPLETION,
    TrainerError,
    TrainerProps,
    TrainerSubplugin,
    register_trainer,
)
from ..utils.profile import GATE


def _resolve_apply(cfg: Dict, load_path: str) -> Tuple[Any, Any, str]:
    """Returns (apply_fn, params_or_None, apply_import_path_or_empty)."""
    apply = cfg.get("apply")
    params = cfg.get("init")
    apply_path = ""
    if isinstance(apply, str) and ":" in apply:
        mod, _, attr = apply.partition(":")
        try:
            fn = getattr(importlib.import_module(mod), attr)
        except (ImportError, AttributeError) as e:
            raise TrainerError(
                f"torch-optim: cannot resolve apply {apply!r}: {e}") from e
        apply_path = apply
    elif isinstance(apply, str):
        from ..filters.torch_cuda import get_model

        m = get_model(apply)
        if m is None:
            raise TrainerError(
                f"torch-optim: {apply!r} is neither an import path nor a "
                "registered model")
        fn, params = m.fn, params if params is not None else m.params
    elif callable(apply):
        fn = apply
    else:
        raise TrainerError("torch-optim: model-config needs an 'apply'")
    if load_path:
        from ..nativelib import NativeBuildError
        from .checkpoint import is_dir_path, load_dir

        if is_dir_path(load_path):
            # the init tree, where given, is the template of a JAX orbax
            # step (each leaf takes its dtype), as jax-optax's resume
            template = params if isinstance(params, (dict, list, tuple)) \
                else None
            try:
                params = load_dir(load_path, template)
            except (ValueError, NativeBuildError) as e:
                raise TrainerError(f"torch-optim: {e}") from e
        else:
            with open(load_path, "rb") as f:
                blob = pickle.load(f)
            params = blob["params"] if isinstance(blob, dict) and \
                "params" in blob else blob
    if callable(params) and not isinstance(params, torch.nn.Module):
        params = params(int(cfg.get("seed", 0)))
    return fn, params, apply_path


def _make_optimizer(cfg: Dict) -> Callable[[List[torch.Tensor]],
                                           torch.optim.Optimizer]:
    """``leaves -> torch.optim.Optimizer`` from ``optimizer``, ``lr`` and
    ``momentum`` (``parallel.sharded.make_optimizer``: optax's
    settings)."""
    from ..parallel.sharded import make_optimizer

    try:
        return make_optimizer(str(cfg.get("optimizer", "sgd")),
                              float(cfg.get("lr", 1e-2)),
                              float(cfg.get("momentum", 0.9)))
    except ValueError as e:
        raise TrainerError(f"torch-optim: {e}") from None


def _as_tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _side_stream_event(t: torch.Tensor):
    """An event behind ``t``'s writer when it was written on a stream the
    worker does not run on (the default stream), else None."""
    if not t.is_cuda:
        return None
    cur = torch.cuda.current_stream(t.device)
    if cur == torch.cuda.default_stream(t.device):
        return None
    ev = torch.cuda.Event()
    ev.record(cur)
    return ev


@register_trainer
class TorchOptimTrainer(TrainerSubplugin):
    NAME = "torch-optim"

    def __init__(self):
        super().__init__()
        self._cfg: Dict = {}
        self._queue: "queue.Queue" = queue.Queue(maxsize=256)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._status_lock = threading.Lock()
        self._status = {"epoch": 0.0, "training_loss": 0.0,
                        "training_accuracy": 0.0, "validation_loss": 0.0,
                        "validation_accuracy": 0.0}
        self._apply = None
        self._params = None        # the tree until the first step
        self._apply_path = ""
        self._device: Optional[torch.device] = None
        self._sample_shape = None  # (shape, torch dtype) of one input sample
        #: (mesh, step, params, opt_state, batch) once built
        self.built: Optional[Tuple[Any, ...]] = None

    # -- lifecycle ------------------------------------------------------------

    def configure(self, props: TrainerProps, notify) -> None:
        super().configure(props, notify)
        from ..utils.device import resolve_device

        cfg = props.model_config
        if isinstance(cfg, str):
            import json

            with open(cfg) as f:
                cfg = json.load(f)
        if not isinstance(cfg, dict):
            raise TrainerError(
                "torch-optim: model-config must be a dict or a JSON path")
        try:
            self._device = resolve_device(
                props.device if props.device is not None else "cuda")
        except (RuntimeError, ValueError) as e:
            raise TrainerError(f"torch-optim: {e}") from e
        self._cfg = cfg
        self._apply, self._params, self._apply_path = _resolve_apply(
            cfg, props.model_load_path)
        if self._params is None:
            raise TrainerError(
                "torch-optim: no params — provide 'init' in model-config, a "
                "registered model with params, or model-load-path")

    def start(self) -> None:
        self._stop_evt.clear()
        self.finished.clear()
        from ..obs import prof as _prof

        self._thread = _prof.named_thread(
            "train", f"optim:{self.NAME}", self._train_loop)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self.built is not None:
            self.built[1].close()   # a split step's shard threads

    # -- data feed ------------------------------------------------------------

    def push_data(self, inputs: List, labels: List,
                  is_validation: bool = False) -> None:
        if self.error is not None:
            raise TrainerError(
                f"torch-optim: training failed: {self.error}")
        x = _as_tensor(inputs[0])
        if x.ndim > 1 and x.shape[0] == 1:
            x = x[0]  # stream buffers carry a leading frame dim of 1
        y = _as_tensor(labels[0]).reshape(-1)
        y = y[0] if y.numel() == 1 else y  # class index label
        item = (x, y, is_validation, _side_stream_event(x))
        with GATE.outside():   # a profiler start/stop may run meanwhile
            while not self._stop_evt.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue  # backpressure: block the streaming thread

    def get_status(self) -> Dict[str, float]:
        with self._status_lock:
            return dict(self._status)

    def trained_params(self, gather: bool = True) -> Any:
        """The current weights as a JAX-layout numpy tree (the
        configured tree before the first step); without ``gather`` a leaf
        split over the ``model`` axis stays in slices
        (``parallel.sharded.trained_tree``)."""
        if self.built is None:
            return self._params
        from ..parallel.sharded import trained_tree

        return trained_tree(self.built[2], gather)

    def save(self, path: str) -> None:
        from .checkpoint import is_dir_path, save_dir

        if is_dir_path(path):
            # an orbax step, split leaves a chunk a slice, as jax-optax's
            save_dir(path, self.trained_params(gather=False))
            return
        if not self._apply_path:
            raise TrainerError(
                "torch-optim: saving needs 'apply' as a \"module:callable\" "
                "import path so the saved model is loadable by the "
                "torch-cuda filter")
        in_shapes = in_dtypes = None
        if self._sample_shape is not None:
            from ..core.types import DType

            shape, dtype = self._sample_shape
            in_shapes = [(1, *shape)]
            in_dtypes = DType.from_torch(dtype).np_dtype
        with open(path, "wb") as f:
            pickle.dump({"apply": self._apply_path,
                         "params": self.trained_params(),
                         "in_shapes": in_shapes, "in_dtypes": in_dtypes}, f)

    # -- training loop --------------------------------------------------------

    def _mesh_and_step(self):
        from ..parallel import make_mesh, train_step
        from ..parallel.mesh import local_devices
        from ..parallel.sharded import data_shard_groups

        mesh_spec = str(self._cfg.get("mesh", "data:-1"))
        dev = self._device
        try:
            mesh = make_mesh(mesh_spec, local_devices(dev.type))
        except ValueError as e:
            raise TrainerError(f"torch-optim: {e}") from e
        lead = data_shard_groups(mesh, ("data",))[0][0].torch_device
        if lead != dev:
            raise TrainerError(
                f"torch-optim: mesh {mesh_spec!r} is led by {lead}, the "
                f"pipeline runs on {dev}: the batch is stacked on the "
                "pipeline's device, where the first data shard must run")
        data_axis = dict(zip(mesh.axis_names, mesh.devices.shape)).get(
            "data", 1)
        batch = int(self._cfg.get("batch_size", 8))
        batch = data_axis * max(1, -(-batch // data_axis))
        try:
            step, params, opt_state = train_step(
                mesh, self._apply, self._params,
                optimizer=_make_optimizer(self._cfg))
        except ValueError as e:
            raise TrainerError(f"torch-optim: {e}") from e
        return mesh, step, params, opt_state, batch

    def _stack(self, items: List[Tuple]) -> torch.Tensor:
        """One batch tensor on the trainer's device from per-sample
        tensors, stacked where they lie."""
        dev = self._device
        for t, ev in items:
            if ev is not None:
                cur = torch.cuda.current_stream(t.device)
                cur.wait_event(ev)
                t.record_stream(cur)
        return torch.stack([t for t, _ in items]).to(dev)

    def _train_loop(self) -> None:
        # the worker runs torch ops: inside the profiler's gate, out of it
        # while it waits for samples (utils/profile.py)
        try:
            with GATE.inside():
                self._train_loop_inner()
        except BaseException as e:  # noqa: BLE001 - surfaced via push/status
            self.error = e
            self.finished.set()
            if self.notify is not None:
                self.notify(EVENT_TRAINING_COMPLETION,
                            {"error": repr(e), **self.get_status()})

    def _train_loop_inner(self) -> None:
        from ..parallel.sharded import softmax_xent

        p = self.props
        per_epoch = int(p.num_training_samples)
        per_val = int(p.num_validation_samples)
        epochs = int(p.num_epochs)
        xs: List[Tuple] = []
        ys: List[Tuple] = []
        val_xs: List[Tuple] = []
        val_ys: List[Tuple] = []
        epoch, seen_train, seen_val = 0, 0, 0
        losses: List[float] = []

        last_train: List = []  # last train batch, for sampled train acc

        def ensure_built(bx):
            if self.built is None:
                self.built = self._mesh_and_step()
                x0 = bx[0][0]
                self._sample_shape = (tuple(x0.shape), x0.dtype)
            return self.built

        def run_train(bx, by) -> float:
            mesh, step, params, opt_state, batch = ensure_built(bx)
            # pad by repetition to the static batch size (dropping the
            # tail would starve small datasets)
            while len(bx) < batch:
                bx = bx + bx[:batch - len(bx)]
                by = by + by[:batch - len(by)]
            x, y = self._stack(bx[:batch]), self._stack(by[:batch])
            params, opt_state, loss = step(params, opt_state, x, y)
            self.built = (mesh, step, params, opt_state, batch)
            last_train[:] = [bx[:batch], by[:batch]]
            return float(loss)

        def run_eval(bxs, bys):
            """Loss/accuracy over the WHOLE given set, evaluated in
            batch-size chunks with the tail weighted by its true count
            (no truncation, no double-counted padding)."""
            _, step, params, _, batch = ensure_built(bxs)
            total, loss_sum, correct = 0, 0.0, 0
            for off in range(0, len(bxs), batch):
                cx, cy = bxs[off:off + batch], bys[off:off + batch]
                n = len(cx)
                while len(cx) < batch:  # pad, then weight by n only
                    cx = cx + cx[:batch - len(cx)]
                    cy = cy + cy[:batch - len(cy)]
                x, y = self._stack(cx), self._stack(cy)
                with torch.no_grad():
                    logits = step.apply(params, x, train=False)
                pred = logits.argmax(dim=-1)
                loss_sum += float(softmax_xent(logits[:n], y[:n])) * n
                correct += int((pred[:n] == y[:n]).sum())
                total += n
            if not total:
                return 0.0, 0.0
            return loss_sum / total, correct / total

        def finish_epoch():
            nonlocal val_xs, val_ys, seen_train, seen_val
            vloss, vacc = 0.0, 0.0
            if val_xs:
                vloss, vacc = run_eval(val_xs, val_ys)
                val_xs, val_ys = [], []
            tacc = 0.0
            if last_train:
                _, tacc = run_eval(last_train[0], last_train[1])
            with self._status_lock:
                self._status.update(
                    epoch=float(epoch),
                    training_loss=(sum(losses) / len(losses)) if losses
                    else 0.0,
                    training_accuracy=tacc,  # sampled on last train batch
                    validation_loss=vloss, validation_accuracy=vacc)
            losses.clear()
            seen_train, seen_val = 0, 0
            if self.notify is not None:
                self.notify(EVENT_EPOCH_COMPLETION, self.get_status())

        while not self._stop_evt.is_set():
            try:
                with GATE.outside():
                    x, y, is_val, ev = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if is_val or (per_val and seen_train >= per_epoch > 0):
                val_xs.append((x, ev))
                val_ys.append((y, None))
                seen_val += 1
            else:
                xs.append((x, ev))
                ys.append((y, None))
                seen_train += 1
                batch = int(self._cfg.get("batch_size", 8))
                epoch_done = per_epoch and seen_train >= per_epoch
                if len(xs) >= batch or (epoch_done and xs):
                    losses.append(run_train(xs, ys))
                    xs, ys = [], []
            if per_epoch and seen_train >= per_epoch and \
                    seen_val >= per_val:
                if xs:
                    losses.append(run_train(xs, ys))
                    xs, ys = [], []
                epoch += 1
                finish_epoch()
                if epochs and epoch >= epochs:
                    break
        if self.props.model_save_path:
            # save() raises a descriptive TrainerError when 'apply' is not
            # an import path — never silently discard trained params
            self.save(self.props.model_save_path)
        self.finished.set()
        if self.notify is not None and self.error is None:
            self.notify(EVENT_TRAINING_COMPLETION, self.get_status())
