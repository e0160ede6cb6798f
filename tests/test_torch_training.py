"""In-pipeline training of the port against the JAX package's, on the CPU
over 8 virtual host devices (``parallel.mesh.set_virtual_devices``).

1. ``tests/test_training.py``'s ``TestTrainerPipeline`` replayed through
   the port (``jax-optax`` → ``torch-optim``; the JAX package's
   ``models.mobilenet:mobilenet_v1_apply`` → the port's
   ``models.convert:mobilenet_v1_tree_apply``; the single-shot filter on
   the CPU): ``datareposrc ! tensor_trainer`` trains MobileNetV1 at width
   0.25 on ``mesh=data:-1`` and saves a ``.pkl`` the ``torch-cuda``
   filter loads, and the toy linear model's epoch losses fall.
2. ``softmax_xent`` against the JAX one (labels outside the classes
   give a zero row in both): within 1e-6.
3. The train-mode forwards (batch statistics) of MobileNetV1 and V2 at
   width 0.25 and of the SSD, at f32, against the JAX ``train=True``
   applies on the same tree and batch: atol 1e-3 + rtol 1e-3 (measured
   1.2e-4 at batch 8; the batch statistics of the 1x1 deep layers pass
   on the two frameworks' summation-order differences, which the
   inference forwards hold at 1e-4).
4. ``train_step``: 3 steps of sgd, adam and adamw from the same seeded
   MobileNetV1 tree (width 0.25, 10 classes, 32x32, batch 16, seeded
   stored ``mean``/``var``) and batches, the port on ``data:-1`` over 8
   devices — the split step: 8 shards of 2 rows on 8 threads, the batch
   statistics combined over all of them (``parallel/syncbn.py``) —, at
   f32, lr 1e-4, against the JAX ``train_step`` (8 CPU devices for sgd).  The JAX
   adam/adamw reference runs on a one-device mesh: its optax ``count``
   sits on one device, and the JAX step refuses it beside 8-device params
   (a JAX-package fault, not copied).  Tolerances:
   - the first loss (before any update): rtol 1e-5; every later loss:
     rtol 5e-3;
   - every leaf's update, Δ = leaf after − leaf before, by relative norm
     ||Δport − Δjax|| / ||Δjax||: at most 0.1 under sgd, 0.4 under
     adam/adamw; a leaf the JAX step left as it was (``mean``/``var``:
     no gradient, and adamw's decay below their spacing at this lr) is
     left bit for bit;
   - adamw at lr 1e-2, where the decay moves ``mean``/``var``: their
     updates within 0.2 (measured 6.3e-2: the rounding of three decays).
   Why the gaps are not near 0: the train-mode forward is non-smooth
   (ReLU6) and its batch statistics spread each element to its channel,
   so an element within f32 rounding of a clip boundary is clipped in
   one framework and not the other; adam turns the sign of each
   near-zero gradient entry into a step of lr.  Measured on this data
   (the tests print each reading; ``-s``) under 1, 2, 3, 4, 6 and 8
   torch threads (``OMP_NUM_THREADS``): the worst leaf 9.5e-3 to 1.9e-2
   under sgd, 0.193 under adam/adamw, later losses within 6e-4.  Each
   planted defect of ``test_update_check_sees_planted_faults`` reads at
   least 1.0: the update skipped, a leaf's gradient zeroed, mean/var left
   out of adamw (1.0 each), the batch statistics detached (1.39 under
   adam, about 700 under sgd), each shard normalizing by its own 2 rows'
   statistics (the shard group bypassed: 1.09e3 under sgd, 1.86 under
   adam).  The losses alone pass some of them.
5. The optimizers alone, exactly: a smooth linear model (no kinks) with a
   leaf the apply never reads, 3 steps of each optimizer at lr 1e-2 over
   8 devices: losses rtol 1e-6, every leaf atol 1e-6, the unread leaf
   decayed by adamw alone; ``train_step``'s default optimizer is the
   JAX default, and an unknown optimizer name is refused by both
   trainers.
6. The eval quirk, copied and pinned: ``training_accuracy`` and the
   validation numbers run the apply without ``train`` — the stored
   ``mean``/``var`` leaves, which training never sets — in both
   packages; the port's numbers equal the JAX trainer's on the same
   samples at f32 (losses rtol 5e-3 as in 4, since they follow updates
   — measured within 3.5e-5 over seeds 2-5 and 1, 4 and 8 threads —;
   accuracies equal), and the
   stored-statistics forward they come from differs from the
   batch-statistics one.
7. The split step itself: ``data:8`` against the stacked ``data:1`` on
   the same global batch for MobileNetV1 and V2 at width 0.25 (losses
   rtol 1e-5, leaves atol 1e-4; measured 1.6e-6 and 4.0e-5 for V1, 1.0e-6
   and 2.7e-7 for V2); ``batch_moments`` over three shards of 1, 3 and 4
   rows against ``torch.var_mean`` of the stacked rows, values and
   gradients, and under more shard threads than cores over 200 layers
   with a short switch interval; a shard that raises makes the step
   raise its error at once
   and a shard that never reaches a barrier breaks it after the timeout,
   naming the layer and the shard, the step running again after either
   and its shard threads ending with ``close()``; a mesh over
   two distinct devices (``cpu`` and ``meta`` records) runs each shard on
   its own record's device.  What the trainer refuses: a mesh led on
   another device than the pipeline's, a CUDA trainer without a card.
   Before them: the trainer's threads leave the profiler's gate to wait,
   so a profiler start or stop runs while a trainer is fed.
8. The ``trainer_status`` golden (``tests/golden_cases.py``) through the
   port's ``register_trainer``, byte for byte.

Every test that starts a trainer stops it (the pipelines' ``with``
blocks), so no worker thread outlives its test.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import golden_cases
from nnstreamer_tpu.models import mobilenet as jmb
from nnstreamer_tpu.models import ssd as jssd
from nnstreamer_tpu.parallel import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel import train_step as jtrain_step
from nnstreamer_tpu.parallel.sharded import softmax_xent as jsoftmax_xent
from nnstreamer_tpu_torch.core import Buffer as TBuffer
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec
from nnstreamer_tpu_torch.models import convert
from nnstreamer_tpu_torch.models import mobilenet as tmb
from nnstreamer_tpu_torch.parallel import mesh as tmesh
from nnstreamer_tpu_torch.parallel import sharded as tsharded
from nnstreamer_tpu_torch.parallel import syncbn
from nnstreamer_tpu_torch.runtime import parse_launch as t_parse
from nnstreamer_tpu_torch.trainers import TrainerError, TrainerProps
from nnstreamer_tpu_torch.trainers import torch_optim
from torch_replay import port_function, replay

replay("test_training.py", globals(), subs=[
    ('framework="jax-optax"', 'framework="torch-optim"'),
    ('"nnstreamer_tpu.models.mobilenet:mobilenet_v1_apply"',
     '"nnstreamer_tpu.models.convert:mobilenet_v1_tree_apply"'),
    ('FilterSingle(framework="jax-xla", model=save)',
     'FilterSingle(framework="jax-xla", model=save, device="cpu")'),
], only=["TestTrainerPipeline"])

CLASSES = 10


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    tmesh.set_virtual_devices(8, "cpu")
    yield
    tmesh.clear_virtual_devices()


@pytest.fixture(scope="module", autouse=True)
def _cpu_exp_warmed():
    """One multi-threaded ``torch.exp`` first: in a fresh process under
    load the first one can come back 1.49e-4 off in relative terms
    (``tests/test_torch_ops.py``)."""
    torch.exp(torch.zeros(1 << 20))


def _jtree(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree)


def _pairs(jt, tt, path=""):
    """(path, jax leaf, port leaf) over two trees of one structure."""
    if isinstance(jt, dict):
        assert sorted(jt) == sorted(tt), path
        for k in sorted(jt):
            yield from _pairs(jt[k], tt[k], f"{path}/{k}")
    elif isinstance(jt, (list, tuple)):
        assert len(jt) == len(tt), path
        for i, (a, b) in enumerate(zip(jt, tt)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, np.asarray(jt), np.asarray(tt)


# -- 2. softmax_xent ---------------------------------------------------------------


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((8, 10)).astype(np.float32) * 3
    labels = np.array([0, 3, 9, -1, 10, 5, 5, 2], np.int32)  # two outside
    got = float(tsharded.softmax_xent(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    want = float(jsoftmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    # a label outside the classes is a zero row in both, not an error
    alone = float(tsharded.softmax_xent(torch.from_numpy(logits[3:5]),
                                        torch.from_numpy(labels[3:5])))
    assert alone == 0.0 == float(jsoftmax_xent(jnp.asarray(logits[3:5]),
                                               jnp.asarray(labels[3:5])))


# -- 3. train-mode forwards --------------------------------------------------------


@pytest.mark.parametrize("family", ["v1", "v2"])
def test_train_forward_matches_jax(family):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    tree = getattr(tmb, f"mobilenet_{family}_init")(0, CLASSES, 0.25)
    want = np.asarray(getattr(jmb, f"mobilenet_{family}_apply")(
        _jtree(tree), x, train=True, dtype=jnp.float32))
    got = getattr(convert, f"mobilenet_{family}_tree_apply")(
        tree, torch.from_numpy(x), dtype=torch.float32, train=True)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-3,
                               rtol=1e-3)
    # and the batch statistics are used: the stored ones give another
    # function
    stored = getattr(convert, f"mobilenet_{family}_tree_apply")(
        tree, torch.from_numpy(x), dtype=torch.float32)
    assert not np.allclose(stored.detach().numpy(), want, atol=1e-2)


def test_ssd_train_forward_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    tree = convert.ssd_mobilenet_v2_init(0, 5)
    jt = _jtree(tree)   # num_classes stays a Python int: closed over
    jloc, jcls = jax.jit(lambda x: jssd.ssd_mobilenet_v2_apply(
        jt, x, train=True, dtype=jnp.float32))(x)
    with torch.no_grad():
        loc, cls = convert.ssd_from_jax(tree)(torch.from_numpy(x),
                                              torch.float32, train=True)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=1e-3,
                               rtol=1e-3)


# -- 4. train_step against the JAX step --------------------------------------------

STEP_LR = 1e-4
STATS_LR = 1e-2   # adamw's decay of mean/var is above f32 spacing only here
JAX_OPT = {"sgd": lambda lr: optax.sgd(lr, momentum=0.9),
           "adam": optax.adam, "adamw": optax.adamw}
#: the largest ||Δport − Δjax|| / ||Δjax|| a leaf may show (Δ = leaf after
#: 3 steps − leaf before), by optimizer; and for mean/var under adamw at
#: STATS_LR
UPDATE_GAP = {"sgd": 0.1, "adam": 0.4, "adamw": 0.4}
STATS_GAP = 0.2


def _step_tree():
    """The seeded width-0.25 tree with seeded stored statistics (the
    train-mode forward reads none of them, so each is moved by the
    optimizer alone)."""
    tree = tmb.mobilenet_v1_init(0, CLASSES, 0.25)
    rng = np.random.default_rng(7)

    def fill(t):
        if isinstance(t, list):
            return [fill(v) for v in t]
        out = {k: fill(v) if isinstance(v, (dict, list)) else v
               for k, v in t.items()}
        if "mean" in out:
            out["mean"] = (rng.standard_normal(out["mean"].shape)
                           * 0.1).astype(np.float32)
            out["var"] = rng.uniform(0.5, 1.5, out["var"].shape).astype(
                np.float32)
        return out
    return fill(tree)


def _step_data():
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((3, 16, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, CLASSES, (3, 16)).astype(np.int32)
    return xs, ys


@functools.lru_cache(maxsize=None)
def _jax_steps(name, lr):
    """The JAX step's 3 losses and final tree from ``_step_tree``."""
    jmesh = jmake_mesh("data:-1") if name == "sgd" \
        else jmake_mesh("data:-1", jax.devices()[:1])
    jstep, jp, jo = jtrain_step(
        jmesh, functools.partial(jmb.mobilenet_v1_apply, dtype=jnp.float32),
        _jtree(_step_tree()), optimizer=JAX_OPT[name](lr))
    losses = []
    for x, y in zip(*_step_data()):
        jp, jo, loss = jstep(jp, jo, x, y)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, jp)


def _port_steps(name, lr, fault=None, mesh="data:-1",
                rules=tsharded.mobilenet_param_rules):
    """The port's 3 losses and final tree over ``mesh`` (the 8 virtual
    records) with ``rules``; ``fault`` plants one defect the update check
    must see: ``no_update`` (the optimizer's step skipped),
    ``head_bias_grad`` (the head bias's gradient zeroed),
    ``stats_left_out`` (mean/var not handed to the optimizer),
    ``shard_stats`` (each shard's statistics from its own rows: the shard
    group bypassed), ``slice_grad`` (the gradient of the last pointwise
    weight's second slice zeroed, on a ``model`` axis)."""
    opt = torch_optim._make_optimizer({"optimizer": name, "lr": lr})
    if fault == "no_update":
        build = opt

        def opt(leaves):
            o = build(leaves)
            o.step = lambda *a, **k: None
            return o
    tmesh_ = tmesh.make_mesh(mesh)
    step, tp, to = tsharded.train_step(
        tmesh_, functools.partial(convert.mobilenet_v1_tree_apply,
                                  dtype=torch.float32), _step_tree(),
        optimizer=opt, rules=rules)
    model = tmesh_.shape.get("model", 1)
    assert step.data_size == 8 // model and len(step.devices) == 8 // model
    if fault == "slice_grad":
        tp.blocks[12].pw.weight.slices[1].register_hook(torch.zeros_like)
    if fault == "shard_stats":
        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.setattr(syncbn, "batch_moments", lambda y, dims: (
            y.mean(dim=dims), y.var(dim=dims, unbiased=False)))
    if fault == "head_bias_grad":
        tp.head.b.register_hook(torch.zeros_like)
    if fault == "stats_left_out":
        held = {id(t) for n, t in tp.named_buffers()
                if n.endswith((".mean", ".var"))}
        for g in to.param_groups:
            g["params"] = [t for t in g["params"] if id(t) not in held]
    losses = []
    try:
        for x, y in zip(*_step_data()):
            tp, to, loss = step(tp, to, x, y)
            losses.append(float(loss))
    finally:
        if fault == "shard_stats":
            monkeypatch.undo()
    return losses, tsharded.trained_tree(tp)


def _update_gaps(init, jax_after, port_after):
    """{leaf path: ||Δport − Δjax|| / ||Δjax||}, Δ = after − init; a leaf
    the JAX step left as it was must be left bit for bit (gap 0, else
    inf)."""
    gaps = {}
    for (path, j, t), (_, _, i0) in zip(_pairs(jax_after, port_after),
                                        _pairs(jax_after, init)):
        assert j.shape == t.shape and j.dtype == t.dtype, path
        dj, dt = j - i0, t - i0
        nj = float(np.linalg.norm(dj))
        gaps[path] = float(np.linalg.norm(dt - dj)) / nj if nj else (
            0.0 if np.array_equal(dt, dj) else np.inf)
    assert len(gaps) == 5 + 13 * 2 * 5 + 2   # stem, 13 blocks of dw+pw, head
    return gaps


def _hold_updates(gaps, limit, stats_only=False):
    over = {p: g for p, g in gaps.items()
            if g > limit and (not stats_only or p.endswith(("/mean", "/var")))}
    assert not over, f"leaf updates off the JAX step's (limit {limit}): {over}"


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_train_step_matches_jax(name):
    jl, jp = _jax_steps(name, STEP_LR)
    tl, got = _port_steps(name, STEP_LR)
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    assert tl == pytest.approx(jl, rel=5e-3)
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"train_step {name}: losses rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(tl, jl)):.3e}, largest "
          f"leaf update gap {max(gaps.values()):.3e}")
    _hold_updates(gaps, UPDATE_GAP[name])
    # at this lr mean/var stay bit for bit in both (no gradient; adamw's
    # decay is below their spacing)
    assert all(g == 0.0 for p, g in gaps.items()
               if p.endswith(("/mean", "/var")))


def test_train_step_decays_the_statistics_as_jax():
    """adamw at STATS_LR: mean/var (no gradient) move by the decay alone,
    as optax's ``adamw`` moves them; the rest of the step is chaotic at
    this lr and not held here."""
    _, jp = _jax_steps("adamw", STATS_LR)
    _, got = _port_steps("adamw", STATS_LR)
    gaps = _update_gaps(_step_tree(), jp, got)
    print("adamw at lr 1e-2: largest mean/var update gap "
          f"{max(g for p, g in gaps.items() if p.endswith(('/mean', '/var'))):.3e}")
    _hold_updates(gaps, STATS_GAP, stats_only=True)
    assert all(g > 0 for p, g in gaps.items()
               if p.endswith(("/mean", "/var")))


@pytest.mark.parametrize("fault,name", [
    ("no_update", "sgd"), ("no_update", "adam"),
    ("detached_stats", "sgd"), ("detached_stats", "adam"),
    ("head_bias_grad", "sgd"), ("head_bias_grad", "adamw"),
    ("stats_left_out", "adamw"), ("shard_stats", "sgd"),
    ("shard_stats", "adam")])
def test_update_check_sees_planted_faults(fault, name, monkeypatch):
    """The update check of the two tests above fails a step with one
    planted defect (the losses alone pass some of them)."""
    lr = STATS_LR if fault == "stats_left_out" else STEP_LR
    if fault == "detached_stats":   # the batch mean/variance detached
        mean, var = torch.Tensor.mean, torch.Tensor.var
        var_mean = torch.var_mean   # a split step's per-shard moments
        monkeypatch.setattr(
            torch.Tensor, "mean", lambda t, *a, **k: mean(t, *a, **k).detach()
            if k.get("dim") == (0, 1, 2) else mean(t, *a, **k))
        monkeypatch.setattr(torch.Tensor, "var",
                            lambda t, *a, **k: var(t, *a, **k).detach())
        monkeypatch.setattr(torch, "var_mean", lambda *a, **k: tuple(
            t.detach() for t in var_mean(*a, **k)))
    _, jp = _jax_steps(name, lr)
    _, got = _port_steps(name, lr, fault)
    monkeypatch.undo()
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"planted {fault} under {name}: largest leaf update gap "
          f"{max(gaps.values()):.3e}")
    assert max(gaps.values()) >= 1.0
    with pytest.raises(AssertionError, match="leaf updates off"):
        _hold_updates(gaps, STATS_GAP if lr == STATS_LR
                      else UPDATE_GAP[name], stats_only=lr == STATS_LR)


# -- 5. the optimizers exactly, on a smooth model ------------------------------------


def _smooth_apply(params, x, train=False):
    return x @ params["w"] + params["b"]


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizers_exact_on_smooth_model(name):
    rng = np.random.default_rng(11)
    tree = {"w": rng.standard_normal((6, 4)).astype(np.float32) * 0.1,
            "b": np.zeros(4, np.float32),
            "unread": np.full(3, 2.0, np.float32)}
    xs = rng.standard_normal((3, 8, 6)).astype(np.float32)
    ys = rng.integers(0, 4, (3, 8)).astype(np.int32)
    jmesh = jmake_mesh("data:-1") if name == "sgd" \
        else jmake_mesh("data:-1", jax.devices()[:1])
    jstep, jp, jo = jtrain_step(jmesh, _smooth_apply, _jtree(tree),
                                optimizer=JAX_OPT[name](1e-2))
    step, tp, to = tsharded.train_step(
        tmesh.make_mesh("data:-1"), _smooth_apply, tree,
        optimizer=torch_optim._make_optimizer({"optimizer": name,
                                               "lr": 1e-2}))
    for x, y in zip(xs, ys):
        jp, jo, jl = jstep(jp, jo, x, y)
        tp, to, tl = step(tp, to, x, y)
        assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    got = tsharded.trained_tree(tp)
    for path, a, b in _pairs(jax.tree_util.tree_map(np.asarray, jp), got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=path)
    assert (got["unread"] != 2.0).all() == (name == "adamw")
    assert tree["unread"].tolist() == [2.0] * 3   # the input tree is kept


def test_one_optimizer_policy():
    """``train_step``'s default and the trainer's ``sgd`` are one builder
    (``parallel.sharded.make_optimizer``): sgd, lr 1e-2, momentum 0.9,
    as the JAX default; an unknown name is a ``TrainerError`` in both
    trainers."""
    from nnstreamer_tpu.trainers import TrainerError as JTrainerError
    from nnstreamer_tpu.trainers.jax_optax import (_make_optimizer as
                                                   j_make_optimizer)

    tree = {"w": np.zeros((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    _, _, to = tsharded.train_step(tmesh.make_mesh("data:-1"),
                                   _smooth_apply, tree)
    group = to.param_groups[0]
    assert type(to) is torch.optim.SGD and (
        group["lr"], group["momentum"], group["dampening"],
        group["nesterov"]) == (1e-2, 0.9, 0.0, False)
    cfg = {"optimizer": "lamb"}
    with pytest.raises(JTrainerError, match="unknown optimizer 'lamb'"):
        j_make_optimizer(cfg)
    with pytest.raises(TrainerError, match="unknown optimizer 'lamb'"):
        torch_optim._make_optimizer(cfg)


def test_train_step_refuses_the_wrong_state():
    tree = {"w": np.zeros((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    step, tp, to = tsharded.train_step(tmesh.make_mesh("data:-1"),
                                       _smooth_apply, tree)
    x = np.zeros((8, 6), np.float32)
    y = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="pass back"):
        step(dict(tp), to, x, y)
    with pytest.raises(ValueError, match="data axis"):
        step(tp, to, x[:6], y[:6])


# -- 6. the eval quirk ---------------------------------------------------------------


def _run_trainer(P, framework, apply, tree, samples, val):
    p = P["Pipeline"]()
    src = P["AppSrc"](name="src", spec=P["TensorsSpec"].parse(
        "3:32:32:1,1:1", "float32,int32"))
    trn = P["make"]("tensor_trainer", el_name="trn", framework=framework,
                    model_config={"apply": apply, "init": tree,
                                  "batch_size": 8, "lr": STEP_LR,
                                  "mesh": "data:-1"},
                    num_inputs=1, num_labels=1,
                    num_training_samples=len(samples) - val,
                    num_validation_samples=val, epochs=1)
    snk = P["AppSink"](name="out", max_buffers=len(samples) + 8)
    p.add(src, trn, snk).link(src, trn, snk)
    status = []
    p.bus.add_watch(lambda m: status.append(dict(m.data))
                    if m.data and m.data.get("event") == "epoch-completion"
                    else None)
    with p:
        for x, y in samples:
            src.push_buffer(P["Buffer"].of(x, y))
        src.end_of_stream()
        assert p.wait_eos(timeout=180)
    return status


def test_eval_reads_stored_statistics_as_jax_does():
    import nnstreamer_tpu.core as jcore
    import nnstreamer_tpu.elements.basic as jbasic
    import nnstreamer_tpu.runtime as jrt
    import nnstreamer_tpu_torch.elements.basic as tbasic
    import nnstreamer_tpu_torch.runtime as trt

    rng = np.random.default_rng(2)
    samples = [(rng.standard_normal((1, 32, 32, 3)).astype(np.float32),
                np.array([[i % 3]], np.int32)) for i in range(24)]
    tree = tmb.mobilenet_v1_init(0, 3, 0.25)
    jax_pkg = dict(Pipeline=jrt.Pipeline, make=jrt.make, AppSrc=jbasic.AppSrc,
                   AppSink=jbasic.AppSink, TensorsSpec=jcore.TensorsSpec,
                   Buffer=jcore.Buffer)
    port = dict(Pipeline=lambda: trt.Pipeline(device="cpu"), make=trt.make,
                AppSrc=tbasic.AppSrc, AppSink=tbasic.AppSink,
                TensorsSpec=TSpec, Buffer=TBuffer)
    want = _run_trainer(jax_pkg, "jax-optax", functools.partial(
        jmb.mobilenet_v1_apply, dtype=jnp.float32), _jtree(tree), samples, 8)
    got = _run_trainer(port, "torch-optim", functools.partial(
        convert.mobilenet_v1_tree_apply, dtype=torch.float32), tree,
        samples, 8)
    assert len(got) == len(want) == 1
    for k in ("training_loss", "validation_loss"):   # after updates: 4.
        assert got[0][k] == pytest.approx(want[0][k], rel=5e-3), k
    for k in ("training_accuracy", "validation_accuracy", "epoch"):
        assert got[0][k] == want[0][k], k
    # the numbers come from the stored statistics: the same last batch
    # through the batch-statistics forward gives other logits
    x = torch.from_numpy(np.concatenate([s[0] for s in samples[8:16]]))
    stored = convert.mobilenet_v1_tree_apply(tree, x, dtype=torch.float32)
    batch = convert.mobilenet_v1_tree_apply(tree, x, dtype=torch.float32,
                                            train=True)
    assert not torch.allclose(stored, batch, atol=1e-2)


def test_trainer_threads_step_out_of_the_profiler_gate():
    """A ``torch.profiler`` start or stop goes through ``GATE.hold``,
    which waits until no thread is inside a torch op
    (``utils/profile.py``).  The trainer's threads step out of the gate
    to wait: a streaming thread held back by the full sample queue, and
    the worker waiting for samples; so a hold runs meanwhile instead of
    timing out."""
    import threading

    from nnstreamer_tpu_torch.utils.profile import GATE

    sp = torch_optim.TorchOptimTrainer()
    sp.configure(TrainerProps(
        model_config={"apply": _smooth_apply, "batch_size": 8,
                      "mesh": "data:-1",
                      "init": {"w": np.zeros((6, 4), np.float32),
                               "b": np.zeros(4, np.float32)}},
        num_training_samples=10 ** 6, num_epochs=1, device="cpu"),
        lambda ev, data: None)
    sample = ([np.ones(6, np.float32)], [np.zeros(1, np.int32)])
    for _ in range(256):   # the queue full, no worker yet
        sp.push_data(*sample)
    entered = threading.Event()

    def streaming():
        with GATE.inside():
            entered.set()
            sp.push_data(*sample)

    t = threading.Thread(target=streaming)
    t.start()
    try:
        assert entered.wait(5)
        assert t.is_alive()   # blocked on the full queue
        assert GATE.hold(lambda: "ran", 5.0) == "ran"
        sp.start()            # the worker drains the queue and trains
        t.join(30)
        assert not t.is_alive()
        assert GATE.hold(lambda: "ran", 5.0) == "ran"
        assert sp.error is None and sp.built is not None
    finally:
        sp.stop()
        t.join(5)


# -- 7. the split step, and refusals ----------------------------------------------

#: the split step against the stacked one on one global batch: losses
#: rtol, leaves atol (module doc: measured 1.6e-6 / 4.0e-5 at the worst)
SPLIT_LOSS_RTOL = 1e-5
SPLIT_LEAF_ATOL = 1e-4


@pytest.mark.parametrize("family", ["v1", "v2"])
def test_split_step_matches_stacked(family):
    """``data:8`` (8 shards of 2 rows, the statistics over all 16) against
    ``data:1`` (the 16 rows stacked): the same function up to the order
    of the sums."""
    tree = getattr(tmb, f"mobilenet_{family}_init")(0, CLASSES, 0.25)
    apply = functools.partial(
        getattr(convert, f"mobilenet_{family}_tree_apply"),
        dtype=torch.float32)
    recs = tmesh.local_devices("cpu")
    runs = {}
    for spec, devs in (("data:1", recs[:1]), ("data:8", recs)):
        step, tp, to = tsharded.train_step(
            tmesh.make_mesh(spec, devs), apply, tree,
            optimizer=torch_optim._make_optimizer({"optimizer": "sgd",
                                                   "lr": STEP_LR}))
        assert step.data_size == len(devs)
        losses = []
        for x, y in zip(*_step_data()):
            tp, to, loss = step(tp, to, x, y)
            losses.append(float(loss))
        runs[spec] = (losses, tsharded.trained_tree(tp))
    (ls, ts), (lp, tp_) = runs["data:1"], runs["data:8"]
    worst = max(float(np.abs(a - b).max()) for _, a, b in _pairs(ts, tp_))
    print(f"split {family}: losses rel "
          f"{max(abs(a - b) / abs(a) for a, b in zip(ls, lp)):.3e}, leaves "
          f"max {worst:.3e}")
    assert lp == pytest.approx(ls, rel=SPLIT_LOSS_RTOL)
    assert worst <= SPLIT_LEAF_ATOL


def _as_shards(group, fn, n):
    """``fn(k)`` on ``n`` threads as the shards of ``group``; the results
    in shard order, or the first error raised."""
    import threading

    outs, errs = [None] * n, []

    def run(k):
        try:
            with group.shard(k):
                outs[k] = fn(k)
        except BaseException as e:   # noqa: BLE001 - returned below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return outs, errs


def test_batch_moments_over_uneven_shards_equal_the_stacked_ones():
    rng = np.random.default_rng(8)
    rows = (1, 3, 4)
    full = torch.from_numpy(rng.standard_normal((8, 5, 5, 7)).astype(
        np.float32) * 3 + 1)
    parts = [p.clone().requires_grad_(True)
             for p in full.split(list(rows))]
    whole = full.clone().requires_grad_(True)
    dims = (0, 1, 2)
    # outside a group: the plain moments of the rows given
    m0, v0 = syncbn.batch_moments(whole, dims)
    var, mean = torch.var_mean(whole, dim=dims, correction=0)
    assert torch.equal(m0, whole.mean(dim=dims)) and torch.equal(
        v0, whole.var(dim=dims, unbiased=False))
    outs, errs = _as_shards(syncbn.ShardGroup(3, timeout=30),
                            lambda k: syncbn.batch_moments(parts[k], dims),
                            3)
    assert not errs
    a, b = torch.linspace(-1, 1, 7), torch.linspace(2, 0.5, 7)
    for m, v in outs:
        torch.testing.assert_close(m, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v, var, rtol=1e-5, atol=1e-6)
    # the gradients reach every shard's rows through the others' moments
    sum((a * m + b * v).sum() for m, v in outs).backward()
    (3 * (a * mean + b * var).sum()).backward()
    for g, w in zip([p.grad for p in parts], whole.grad.split(list(rows))):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_a_lone_shards_moments_are_the_stacked_ones():
    """One data shard in all (a ``model`` group across ranks over one
    shard: ``RankShards`` of one global shard, no collective): Chan's
    formula with weight 1 gives the rows' own ``mean``/``var`` bit for
    bit, as the stacked step takes them (``relu6_edge_study.py``: a
    one-pass ``var_mean`` rounds a ReLU6 input to the other side of 0),
    and the gradient through them."""
    rng = np.random.default_rng(10)
    rows = torch.from_numpy(rng.standard_normal((16, 3, 3, 7)).astype(
        np.float32) * 2 + 1)
    dims = (0, 1, 2)
    a, b = torch.linspace(-1, 1, 7), torch.linspace(2, 0.5, 7)
    whole = rows.clone().requires_grad_(True)
    m0, v0 = syncbn.batch_moments(whole, dims)
    (a * m0 + b * v0).sum().backward()
    lone = rows.clone().requires_grad_(True)
    group = syncbn.ShardGroup(1, timeout=30,
                              ranks=syncbn.RankShards([0], 1))
    outs, errs = _as_shards(group, lambda k: syncbn.batch_moments(lone, dims),
                            1)
    assert not errs
    (m, v), = outs
    assert torch.equal(m, m0) and torch.equal(v, v0)
    (a * m + b * v).sum().backward()
    torch.testing.assert_close(lone.grad, whole.grad, rtol=1e-6, atol=1e-7)


def test_batch_moments_hold_under_many_shards_and_layers():
    """More shard threads than cores, 200 layers in a row and a short
    switch interval: every layer's moments on every shard are the stacked
    rows' (a post overwritten before another shard read it would not
    be)."""
    import sys

    n, layers = (os.cpu_count() or 4) + 4, 200
    rng = np.random.default_rng(9)
    data = torch.from_numpy(rng.standard_normal((layers, n, 3, 5)).astype(
        np.float32) * np.arange(1, n + 1, dtype=np.float32)[:, None, None])

    def shard(k):
        return [syncbn.batch_moments(data[layer, k], (0,))
                for layer in range(layers)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs, errs = _as_shards(syncbn.ShardGroup(n, timeout=60), shard, n)
    finally:
        sys.setswitchinterval(interval)
    assert not errs
    for layer in range(layers):
        var, mean = torch.var_mean(data[layer].reshape(-1, 5), dim=(0,),
                                   correction=0)
        for k in range(n):
            m, v = outs[k][layer]
            torch.testing.assert_close(m, mean, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(v, var, rtol=1e-5, atol=1e-6)


def _shard_apply(params, x, train=False, skip=False):
    """Two normalized layers of a linear model; a shard whose rows hold a
    NaN raises after its first moments, or (``skip``) leaves before its
    second."""
    h = x @ params["w"]
    mean, var = syncbn.batch_moments(h, (0,))
    if bool(torch.isnan(x).any()):
        if not skip:
            raise ValueError("planted shard error")
        return h
    h = (h - mean) * torch.rsqrt(var + 1e-3)
    mean, var = syncbn.batch_moments(h, (0,))
    return (h - mean) + params["b"]


@pytest.mark.parametrize("skip", [False, True])
def test_a_failing_shard_fails_the_step(skip):
    import threading
    import time

    tree = {"w": np.ones((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    step, tp, to = tsharded.train_step(
        tmesh.make_mesh("data:-1"),
        functools.partial(_shard_apply, skip=skip), tree)
    step.barrier_timeout = 2.0
    x = np.ones((16, 6), np.float32)
    x[10, 0] = np.nan        # shard 5's rows: 10 and 11
    y = np.zeros(16, np.int32)
    t0 = time.perf_counter()
    want = (syncbn.ShardGroupError, r"layer 1: shards \[5\] of 8 did not "
            r"arrive within 2 s") if skip else (ValueError, "planted")
    with pytest.raises(want[0], match=want[1]):
        step(tp, to, x, y)
    took = time.perf_counter() - t0
    assert took < (10.0 if skip else 1.5)
    x[10, 0] = 1.0           # the step runs again once the rows are sound
    tp, to, loss = step(tp, to, x, y)
    assert np.isfinite(float(loss))
    # the shard threads live with the step and end with it
    threads = step._threads.threads
    assert len(threads) == 7 and all(t.is_alive() for t in threads)
    step.close()
    assert not any(t.is_alive() for t in threads)
    assert not [t for t in threading.enumerate() if t in threads]


def test_split_step_runs_each_shard_on_its_device():
    """A mesh over two distinct devices (a ``cpu`` and a ``meta`` record)
    is accepted: each shard's rows and leaves go to its record's device;
    the gather from ``meta`` then raises, as a copy out of it must."""
    seen = []

    def apply(params, x, train=False):
        seen.append((x.device.type, params["w"].device.type, x.shape[0]))
        return x @ params["w"] + params["b"]

    recs = [tmesh.Device("cpu", 0, 0, torch.device("cpu")),
            tmesh.Device("meta", 1, 0, torch.device("meta"))]
    tree = {"w": np.zeros((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    step, tp, to = tsharded.train_step(tmesh.make_mesh("data:-1", recs),
                                       apply, tree)
    assert step.devices == [torch.device("cpu"), torch.device("meta")]
    assert tp["w"].device.type == "cpu"
    with pytest.raises((NotImplementedError, RuntimeError), match="meta"):
        step(tp, to, np.zeros((8, 6), np.float32), np.zeros(8, np.int32))
    assert sorted(seen) == [("cpu", "cpu", 4), ("meta", "meta", 4)]


def test_trainer_refuses_distinct_devices_and_a_missing_card(monkeypatch):
    cfg = {"apply": _smooth_apply,
           "init": {"w": np.zeros((6, 4), np.float32)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp = torch_optim.TorchOptimTrainer()
    with pytest.raises(TrainerError, match="is_available"):
        sp.configure(TrainerProps(model_config=cfg), None)
    sp = torch_optim.TorchOptimTrainer()
    sp.configure(TrainerProps(model_config=cfg, device="cpu"), None)
    import nnstreamer_tpu_torch.parallel.mesh as pm

    # a mesh whose first data shard leads elsewhere than the pipeline
    monkeypatch.setattr(pm, "local_devices", lambda platform=None: [
        pm.Device("meta", 0, 0, torch.device("meta")),
        pm.Device("cpu", 1, 0, torch.device("cpu"))])
    with pytest.raises(TrainerError, match="led by meta, the pipeline "
                       "runs on cpu"):
        sp._mesh_and_step()


# -- 9. leaves split over ``model`` ---------------------------------------------

#: the model-split step against the replicated one on the same mesh, sgd:
#: losses rtol, leaves atol (measured 3.9e-7 and 1.2e-7 on data:4,model:2)
MODEL_SPLIT_LOSS_RTOL = 1e-6
MODEL_SPLIT_LEAF_ATOL = 5e-5


@pytest.mark.parametrize("mesh,name", [
    ("data:4,model:2", "sgd"), ("data:-1,model:2", "sgd"),
    ("data:-1,model:2", "adam"), ("data:-1,model:2", "adamw")])
def test_model_split_step_matches_jax(mesh, name):
    """The step with the pointwise convolutions and the head in 2 slices
    (4 data shards of 4 rows, each over a ``model`` group of 2 records)
    against the JAX step on 8 CPU devices, at test 4's limits.  The JAX
    reference runs on ``data:-1`` (sgd; adam/adamw on one device, module
    doc 4): on a mesh with a ``model`` axis the JAX step's depthwise
    gradients come out M times too large (next test)."""
    jl, jp = _jax_steps(name, STEP_LR)
    tl, got = _port_steps(name, STEP_LR, mesh=mesh)
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    assert tl == pytest.approx(jl, rel=5e-3)
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"model split {mesh} {name}: losses rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(tl, jl)):.3e}, largest "
          f"leaf update gap {max(gaps.values()):.3e}")
    _hold_updates(gaps, UPDATE_GAP[name])
    assert all(g == 0.0 for p, g in gaps.items()
               if p.endswith(("/mean", "/var")))


def _jax_grads(mesh=None):
    """The JAX gradient of the train-mode loss of ``_step_tree`` on the
    first batch: jitted on one device, or with the params replicated and
    the batch split over ``data`` of ``mesh``."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    def loss(p, x, y):
        return jsoftmax_xent(jmb.mobilenet_v1_apply(
            p, x, train=True, dtype=jnp.float32), y)

    tree = _jtree(_step_tree())
    x, y = (a[0] for a in _step_data())
    if mesh is not None:
        m = jmake_mesh(mesh)
        tree = jax.device_put(tree, NamedSharding(m, JP()))
        x, y = (jax.device_put(a, NamedSharding(m, JP("data")))
                for a in (x, y))
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        tree, x, y))


def test_jax_step_on_a_model_axis_scales_the_depthwise_gradient():
    """A fault of the reference, not copied (``ROADMAP.md`` queue C): with
    every param replicated and the batch split over ``data`` of a mesh
    with a ``model`` axis of M, XLA's gradient of each depthwise weight is
    M times the one-device gradient; every other leaf's is that
    gradient (relative gap at most 1e-3; measured 4.2e-4 on
    ``data:4,model:2``).  The port's split step takes the one-device
    gradient."""
    mesh, m = "data:4,model:2", 2
    one, split = _jax_grads(), _jax_grads(mesh)
    rels = {}
    for path, a, b in _pairs(one, split):
        want = m * a if path.endswith("/dw/w") else a
        n = float(np.linalg.norm(want))
        rels[path] = float(np.linalg.norm(b - want)) / n if n else \
            float(np.abs(b).max())
    print(f"JAX gradient on {mesh}: largest relative gap from the "
          f"one-device gradient (depthwise x{m}) {max(rels.values()):.3e}")
    assert max(rels.values()) <= 1e-3, rels


def _split_vs_replicated(fault=None):
    """(losses, the replicated losses, losses rel, leaves max, largest
    update gap) of the split step (``fault`` planted) against the
    replicated one on ``data:-1,model:2``, sgd."""
    sl, st = _port_steps("sgd", STEP_LR, fault, mesh="data:-1,model:2")
    rl, rt = _port_steps("sgd", STEP_LR, mesh="data:-1,model:2",
                         rules=tsharded.replicated_param_rules)
    rel = max(abs(a - b) / abs(b) for a, b in zip(sl, rl))
    worst = max(float(np.abs(a - b).max()) for _, a, b in _pairs(rt, st))
    gaps = _update_gaps(_step_tree(), rt, st)
    return sl, rl, rel, worst, max(gaps.values())


def test_model_split_step_matches_replicated():
    sl, rl, rel, worst, gap = _split_vs_replicated()
    print(f"model split against replicated: losses rel {rel:.3e}, leaves "
          f"max {worst:.3e}, largest update gap {gap:.3e}")
    assert sl == pytest.approx(rl, rel=MODEL_SPLIT_LOSS_RTOL)
    assert worst <= MODEL_SPLIT_LEAF_ATOL
    assert gap <= UPDATE_GAP["sgd"]


def test_model_split_checks_see_a_zeroed_slice_gradient():
    """One slice's gradient zeroed (the last pointwise weight's second
    half): the update checks against the replicated step and the JAX
    step fail it (its leaves stay within 5e-5 at this lr: the update
    gap is the check that sees it)."""
    _, _, _, worst, gap = _split_vs_replicated("slice_grad")
    _, jp = _jax_steps("sgd", STEP_LR)
    _, got = _port_steps("sgd", STEP_LR, "slice_grad",
                         mesh="data:-1,model:2")
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"planted slice_grad: against the replicated step leaves max "
          f"{worst:.3e}, largest update gap {gap:.3e}; against JAX "
          f"{max(gaps.values()):.3e}")
    # half of one leaf's update missing: a gap of about 0.7
    assert gap >= 5 * UPDATE_GAP["sgd"]
    assert max(gaps.values()) >= 5 * UPDATE_GAP["sgd"]
    with pytest.raises(AssertionError, match="leaf updates off"):
        _hold_updates(gaps, UPDATE_GAP["sgd"])


def test_model_split_placement_and_bytes_per_record():
    """``MeshParams.specs``: ``P("model", …)`` on every pointwise weight
    and ``P(None, "model")`` on the head, the rest whole; each record of
    the first ``model`` group holds half of the split leaves' bytes; a
    leaf that does not divide, or a mesh without ``model``, stays
    whole."""
    step, tp, _ = tsharded.train_step(
        tmesh.make_mesh("data:-1,model:2"),
        functools.partial(convert.mobilenet_v1_tree_apply,
                          dtype=torch.float32), _step_tree())
    specs = step.placement.specs
    P = tsharded.P
    for i in range(13):
        assert specs[f"blocks.{i}.pw.weight"] == P("model", None, None, None)
        assert specs[f"blocks.{i}.dw.weight"] == P()
        for k in ("scale", "bias", "mean", "var"):
            assert specs[f"blocks.{i}.pw.{k}"] == P()
    assert specs["head.w"] == P(None, "model") and specs["head.b"] == P()
    assert specs["stem.weight"] == P()
    split = [m.pw.weight for m in tp.blocks] + [tp.head.w]
    assert all(isinstance(w, tsharded.ShardedLeaf) and len(w.slices) == 2
               for w in split)
    split_bytes = sum(s.numel() * s.element_size()
                      for w in split for s in w.slices)
    whole = sum(t.numel() * t.element_size()
                for t in list(tp.parameters()) + list(tp.buffers())
                if t.is_floating_point())
    recs = [str(d) for d in step.groups[0]]
    assert step.leaf_bytes() == {recs[0]: whole + split_bytes // 2,
                                 recs[1]: split_bytes // 2}
    assert len(step.leaves) == len(list(tp.parameters())) + \
        len([b for b in tp.buffers() if b.is_floating_point()]) + 2 * 14
    # (6, 5) does not divide over 2; data:-1 has no model axis
    tree = {"w": np.zeros((6, 5), np.float32), "b": np.zeros(5, np.float32)}
    step, tp, _ = tsharded.train_step(tmesh.make_mesh("data:-1,model:2"),
                                      _smooth_apply, tree)
    assert isinstance(tp["w"], torch.Tensor)
    assert step.placement.specs == {"w": P(), "b": P()}
    step, tp, _ = tsharded.train_step(tmesh.make_mesh("data:-1"),
                                      _smooth_apply, tree)
    assert step.placement is None and isinstance(tp["w"], torch.Tensor)


def test_model_split_trainer_saves_slices_as_chunks(tmp_path):
    """A ``torch-optim`` trainer on ``mesh=data:-1,model:2`` with a
    directory ``model-save-path``: its orbax step holds the split leaf in
    one chunk a slice, and orbax's restore (the JAX ``load_orbax``) and
    the port's reader give the trained tree bit for bit."""
    from nnstreamer_tpu.trainers.checkpoint import load_orbax as jload
    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir
    from nnstreamer_tpu_torch.trainers.ocdbt import Ocdbt

    save = str(tmp_path / "ck") + "/"
    sp = torch_optim.TorchOptimTrainer()
    done = []
    sp.configure(TrainerProps(
        model_config={"apply": _smooth_apply, "batch_size": 8, "lr": 0.1,
                      "mesh": "data:-1,model:2",
                      "init": {"w": np.full((6, 4), 0.1, np.float32),
                               "b": np.zeros(4, np.float32)}},
        model_save_path=save, num_training_samples=16, num_epochs=1,
        device="cpu"), lambda ev, data: done.append(ev))
    rng = np.random.default_rng(4)
    sp.start()
    try:
        for i in range(16):
            sp.push_data([rng.standard_normal(6).astype(np.float32)],
                         [np.array([i % 4], np.int32)])
        assert sp.finished.wait(60) and sp.error is None
        step, params = sp.built[1], sp.built[2]
        assert isinstance(params["w"], tsharded.ShardedLeaf)
        assert step.data_size == 4
        want = sp.trained_params()
    finally:
        sp.stop()
    chunks = sorted(k for k in Ocdbt(save).list() if not k.endswith("zarray"))
    assert chunks == ["b/0", "w/0.0", "w/0.1"]
    assert np.abs(want["w"] - 0.1).sum() > 0
    for got in (jload(save), load_dir(save)):
        assert sorted(got) == ["b", "w"]
        for k in want:
            assert np.asarray(got[k]).dtype == want[k].dtype
            assert np.asarray(got[k]).tobytes() == want[k].tobytes(), k


# -- converters both ways --------------------------------------------------------------


@pytest.mark.parametrize("family", ["v1", "v2"])
def test_to_jax_inverts_from_jax_bit_for_bit(family):
    tree = getattr(tmb, f"mobilenet_{family}_init")(4, CLASSES, 0.5)
    back = getattr(convert, f"mobilenet_{family}_to_jax")(
        getattr(convert, f"mobilenet_{family}_from_jax")(tree))
    pairs = list(_pairs(tree, back))
    assert pairs
    for path, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    build, module_apply = convert.tree_module_of(functools.partial(
        getattr(convert, f"mobilenet_{family}_tree_apply"), dtype="float32"))
    model = build(tree)
    x = torch.zeros(2, 32, 32, 3)
    assert module_apply(model, x).dtype == torch.float32
    assert convert.tree_module_of(_smooth_apply) is None


# -- 8. the trainer_status golden ------------------------------------------------------


def test_golden_trainer_status(tmp_path):
    """``case_trainer_status`` with the port's ``register_trainer``,
    elements and ``parse_launch(device="cpu")``."""
    case = port_function(golden_cases.case_trainer_status, {
        "parse_launch": lambda desc: t_parse(desc, device="cpu"),
        "TensorsSpec": TSpec, "Buffer": TBuffer})
    out = str(tmp_path / "trainer_status.out")
    case(out)
    with open(os.path.join(golden_cases.GOLDEN_DIR,
                           "trainer_status.golden"), "rb") as f:
        assert open(out, "rb").read() == f.read()
