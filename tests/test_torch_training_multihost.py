"""The port's train step across processes (``parallel/sharded.py``
``TrainStep`` with ``ranks``, ``parallel/syncbn.py`` ``RankShards``), on
the CPU: two worker processes join one gloo group through
``multihost.initialize``, each with 4 virtual ``cpu`` records
(``set_virtual_devices(4, "cpu")``), and train on
``make_mesh("data:-1")`` over both ranks' 8 records, each rank feeding
its own 8 rows of the 16-row batch.  Beside them two JAX CPU workers
(``--xla_force_host_platform_device_count=4`` each) join through the JAX
package's ``multihost.initialize`` and run its ``train_step`` on its
``make_mesh("data:-1")``, each feeding its rows through
``jax.make_array_from_process_local_data``.  One worker pair of each
runs every case, and a fifth process computes the one-process
references meanwhile; each has its own timeout, each pair its free port,
and each lowers its own priority to the least (``os.nice(19)``), so the
other test files' workers keep the host first (the JAX
``test_chaos.py::TestPoolFaults::test_per_owner_error_routing_keeps_other_stream_alive``
races its bus against its sink and fails on a loaded host).

The tree, rows and optimizers are ``tests/test_torch_training.py``'s
``_step_tree()`` and ``_step_data()``: MobileNetV1 at width 0.25, 10
classes, 32x32, batch 16, f32, lr 1e-4, 3 steps.

(a) Against the JAX step on two processes (sgd), at that file's item 4
    limits: the first loss rtol 1e-5, later losses 5e-3, every leaf's
    update within relative norm 0.1, mean/var left bit for bit.  adam
    and adamw against the one-device JAX step (the JAX step fails them
    on a multi-device mesh: ROADMAP queue C), update gap 0.4.
(b) Against the port's one-process split step, ``data:8`` over 8
    virtual records, on the same global batch: losses rtol 1e-5, leaves
    atol 1e-4 (item 7's limits), for sgd, adam and adamw; rank 0's losses
    and leaves bit-equal to rank 1's.  Under adam/adamw the leaves are
    held to the larger of 1e-4 and the one-process step's own spread over
    two row orders of its batches (the same function, other orders of its
    sums), as ``chip_smoke.py`` 20g holds its split step: adam turns the
    sign of a gradient entry within rounding of zero into a step of lr,
    and the two ranks sum each leaf's gradient in another order (each
    rank's shards, then the ranks) than one process does.  Measured: the
    two ranks 1.49e-4 from one process under adam and adamw, one process
    1.75e-4 to 1.97e-4 from itself over three row orders; under sgd
    1.19e-7 (3.98e-5 with the references on 8 threads, not 2).
(c) Planted faults, each of which (b) must fail: the gradients not
    all-reduced, the statistics combined within the rank only.
(d) ``data:4,model:2`` over the two ranks (every ``model`` group inside
    one rank) against the one-process ``data:4,model:2`` step: the first
    loss rtol 1e-6 and leaves atol 5e-5 (``test_model_split_step_matches_
    replicated``'s limits), the later losses at (b)'s rtol 1e-5: after an
    update they carry the leaves' rounding from the other order of the
    gradient sums.  Measured: the first loss bit-equal, the later ones
    within 1.08e-6 to 1.66e-6, leaves 1.19e-7.
(e) Refusals, each raised on every rank: rows of unequal count on the
    two ranks, a batch that does not split over the rank's shards, rows
    of another shape, and (k) below.  In this process: ``RankExchange``
    and ``_GatherSlices`` against stand-in all-reduces (their buffers,
    rows and backwards), the row digest, and the mesh refusals that need
    no group, the sharded invoke's of a model group across processes
    among them.
(f) The ``torch-optim`` trainer element builds its mesh over
    ``local_devices``: in the two-rank world each rank's trainer trains
    on its own records and rows alone, as a one-process trainer on those
    rows does (the JAX ``jax-optax`` trainer cannot train across
    processes: ROADMAP queue C).
(g) ``model`` groups across the ranks: ``model:2,data:4`` over the two
    ranks' 8 records (every group one record on each rank), the same
    shape from ``hybrid_mesh`` with ``model`` its DCN axis, and
    ``model:4,data:2`` (two records of each group on each rank), each
    rank fed all 16 rows, against the one-process step on the same mesh
    shape at (d)'s limits, and against ``data:8`` at (b)'s for sgd, adam
    and adamw.
(h) sgd on ``model:2,data:4`` against the JAX step on two processes over
    ``data:-1`` at (a)'s limits; the JAX worker also runs its own step on
    the cross-process ``model:2,data:4`` mesh, whose gap from its
    ``data:-1`` step is printed and not held (ROADMAP queue C).
(i) The gathered trees bit-equal on both ranks, also where rank 1
    scales a replicated leaf's gradient by 1 + 2^-20 (as a backward
    kernel that adds in another order rounds it: the sum over every rank
    leaves both one update); each rank holding only its slice of each
    split leaf, and ``trained_tree(gather=False)`` giving that slice; a
    step built again on the same rank sets forms no new group.
(j) Planted faults, each of which (g) must fail: the input-gradient sum
    over the model group removed, the replicated gradients summed over
    every rank and not divided by the ranks of a group, a shard's
    moments written by both ranks of its group.
(k) Refusals on every rank: a shard's rows that differ between the ranks
    of its model group, a layout of groups across ranks the step does
    not take.
(l) Four ranks (``QUAD_WORKER``, 2 virtual ``cpu`` records each) on
    ``model:2,data:4``: every model group spans two ranks and every set
    of data peers two ranks, so the moments' exchanges and the slices'
    gradients reduce over a real peer group between the model groups'
    gathers; against the one-process step at (g)'s limits, the four
    ranks' losses and leaves bit-equal.
(m) Orbax steps written across processes (``trainers/orbax_write.py``
    ``save_orbax(..., group=)`` through ``checkpoint.save_step``): the
    two ranks' ``data:-1`` and ``model:2,data:4`` sgd steps
    (``trained_tree(gather=False)``: each rank its slices) and the four
    ranks' step, each saved by every rank together; the JAX package's
    ``load_orbax`` and the port's ``load_dir`` read each bit-equal to the
    gathered tree; no key lies in two process stores and the chunk bytes
    are the leaves' bytes; each rank builds the step again from what it
    reads, its leaves the saved ones.  The JAX workers save their
    ``data:-1`` and ``model:2,data:4`` steps with the JAX ``save_orbax``
    from both processes, and the port reads each bit-equal to the JAX
    tree; the two packages' top-level files and merged keys are compared.
    Planted faults, each failing: rank 1 raising before it writes (its
    store, a leaf's chunk): every rank raises naming rank 1, nothing left
    but the older step, intact; rank 1 leaving its slices out: the
    readers raise on the missing chunk; rank 1 also writing rank 0's
    replicated chunks: the once-check fails.
(n) A zarr v3 step across processes: the JAX workers save their
    ``model:2,data:4`` step through orbax's
    ``PyTreeCheckpointHandler(use_zarr3=True)`` from both processes (a
    store a process, ``sharding_indexed`` chunks); the port's
    ``load_dir`` reads every leaf bit-equal to the JAX tree and to orbax's
    restore in the test process (a target of one device a leaf).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.parallel import mesh as tmesh
from nnstreamer_tpu_torch.trainers import TrainerProps
from nnstreamer_tpu_torch.trainers import torch_optim
import test_torch_training
from test_torch_training import (STEP_LR, UPDATE_GAP, _hold_updates,
                                 _jax_steps, _pairs, _port_steps, _step_data,
                                 _step_tree, _update_gaps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (b): the two-rank step against the one-process split step
SPLIT_LOSS_RTOL = 1e-5
SPLIT_LEAF_ATOL = 1e-4
#: (d): the two-rank model split against the one-process model split:
#: the first loss, the leaves (later losses at SPLIT_LOSS_RTOL)
MODEL_FIRST_LOSS_RTOL = 1e-6
MODEL_LEAF_ATOL = 5e-5
#: seconds each worker may take, and a refusal on a rank
WORKER_TIMEOUT_S = 420
REFUSAL_S = 30.0
TOY_SAMPLES = 16


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    tmesh.set_virtual_devices(8, "cpu")
    yield
    tmesh.clear_virtual_devices()


PORT_WORKER = textwrap.dedent("""\
    import functools
    import os
    import pickle
    import sys
    import time
    os.nice(19)
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    pid, port, cfg_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                     sys.argv[3], sys.argv[4])

    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.parallel import mesh, multihost, sharded
    from nnstreamer_tpu_torch.parallel import syncbn
    from nnstreamer_tpu_torch.trainers import TrainerProps, torch_optim
    from nnstreamer_tpu_torch.trainers import checkpoint, orbax_write

    mesh.set_virtual_devices(4, "cpu")
    multihost.initialize(coordinator_address="127.0.0.1:" + port,
                         num_processes=2, process_id=pid, backend="gloo")
    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    tree, xs, ys = cfg["tree"], cfg["xs"], cfg["ys"]
    b = xs.shape[1] // 2
    mine = slice(pid * b, (pid + 1) * b)
    apply = functools.partial(convert.mobilenet_v1_tree_apply,
                              dtype=torch.float32)
    out = {{"runs": {{}}, "refusals": {{}}, "faults": {{}}}}

    def build_on(name, m, params=None):
        opt = torch_optim._make_optimizer({{"optimizer": name,
                                           "lr": cfg["lr"]}})
        return sharded.train_step(m, apply, tree if params is None
                                  else params, optimizer=opt)

    def save(case, name, m, step, tp):
        # both ranks save the step together, then each builds it again
        # from what it reads back
        root = os.path.join(os.getcwd(), "saved_" + case)
        t0 = time.perf_counter()
        path = checkpoint.save_step(root, 1, sharded.trained_tree(
            tp, gather=False), group=step.ranks.every)
        took = time.perf_counter() - t0
        again, tp2, _ = build_on(name, m, checkpoint.load_dir(path))
        again.close()
        out["runs"][case].update(saved=path, save_s=took, reloaded=
                                 sharded.trained_tree(tp2),
                                 listed=sorted(os.listdir(root)))

    def build(name, spec):
        return build_on(name, mesh.make_mesh(spec))

    def run(case, name, spec="data:-1", rows=None, m=None, nudge=False,
            saved=False):
        m = m if m is not None else mesh.make_mesh(spec)
        opt = torch_optim._make_optimizer({{"optimizer": name,
                                           "lr": cfg["lr"]}})
        step, tp, to = sharded.train_step(m, apply, tree, optimizer=opt)
        if nudge and pid == 1:   # a replicated gradient rounded otherwise
            split = {{id(t) for _, leaf in sharded._split_leaves(tp)
                     for t in leaf.slices}}
            first = next(t for t in step.leaves if id(t) not in split)
            first.register_hook(lambda g: g * (1 + 2.0 ** -20))
        assert step.ranks is not None and step.ranks.size == 8 // \\
            m.shape.get("model", 1), step.ranks
        assert all(d.process_index == pid for g in step.groups for d in g)
        rows = mine if rows is None else rows
        losses = []
        for x, y in zip(xs, ys):
            tp, to, loss = step(tp, to, x[rows], y[rows])
            losses.append(float(loss))
        step.close()
        out["runs"][case] = {{"losses": losses,
                             "tree": sharded.trained_tree(tp),
                             "split": step.placement is not None}}
        if any(g is not None for g in step.ranks.models):
            out["runs"][case].update(
                local=sharded.trained_tree(tp, gather=False),
                held=[(".".join(path), list(leaf.index),
                       [tuple(t.shape) for t in leaf.slices])
                      for path, leaf in sharded._split_leaves(tp)],
                models=[repr(g) for g in step.ranks.models],
                peers=list(step.ranks.peers.ranks))
        if saved:
            save(case, name, m, step, tp)
        print(f"ran {{case}} process={{pid}} losses={{losses}}", flush=True)

    for name in ("sgd", "adam", "adamw"):
        run(name, name, saved=name == "sgd")
    run("model", "sgd", "data:4,model:2")
    # -- (g) model groups across the ranks: every rank all 16 rows --------
    every = slice(None)
    for name in ("sgd", "adam", "adamw"):
        run("across_" + name, name, "model:2,data:4", every,
            saved=name == "sgd")
    run("hybrid", "sgd", rows=every, m=multihost.hybrid_mesh(
        [("data", 4)], [("model", 2)]))
    run("mixed", "sgd", "model:4,data:2", every)
    run("nudged", "sgd", "model:2,data:4", every, nudge=True)
    # a step built again on the same sets forms no group
    out["groups"] = len(multihost._GROUPS)
    formed = []
    real_new_group = torch.distributed.new_group
    torch.distributed.new_group = lambda *a, **k: (
        formed.append(a) or real_new_group(*a, **k))
    try:
        build("sgd", "model:2,data:4")[0].close()
    finally:
        torch.distributed.new_group = real_new_group
    out["formed_again"] = len(formed)

    # -- planted faults, the same on both ranks ---------------------------
    real_reduce = sharded.TrainStep._reduce

    def loss_only(self, loss):   # the gradients left as each rank's own
        total = loss.clone()
        self.ranks.all_reduce(total)
        return total

    sharded.TrainStep._reduce = loss_only
    try:
        run("no_grad_reduce", "sgd")
    finally:
        sharded.TrainStep._reduce = real_reduce
    real_group = syncbn.ShardGroup
    syncbn.ShardGroup = lambda size, timeout, ranks=None: real_group(
        size, timeout)   # each rank's shards combined among themselves
    try:
        run("rank_stats", "sgd")
    finally:
        syncbn.ShardGroup = real_group

    # -- (j) planted faults on the groups across ranks ----------------------
    real_input = sharded._model_input
    sharded._model_input = lambda x, model: x   # no input-gradient sum
    try:
        run("no_input_reduce", "sgd", "model:2,data:4", every)
    finally:
        sharded._model_input = real_input

    def every_rank(self, loss):   # each shard's gradient once a rank
        self.ranks.mates = 1        # the sum over every rank not divided
        return real_reduce(self, loss)

    sharded.TrainStep._reduce = every_rank
    try:
        run("every_rank_grads", "sgd", "model:2,data:4", every)
    finally:
        sharded.TrainStep._reduce = real_reduce
    real_fwd = syncbn.RankExchange.forward

    def both_write(ctx, local, ranks):   # every rank of a group writes
        ctx.ranks = ranks
        buf = local.new_zeros((ranks.size, local.shape[1]))
        buf[ranks.index] = local
        torch.distributed.all_reduce(buf)
        return buf

    syncbn.RankExchange.forward = staticmethod(both_write)
    try:
        run("both_write_moments", "sgd", "model:2,data:4", every)
    finally:
        syncbn.RankExchange.forward = staticmethod(real_fwd)

    # -- planted faults of the write across ranks ---------------------------
    ranks = multihost.Subgroup([0, 1])
    good = out["runs"]["sgd"]["tree"]

    def plus_one(t):
        if isinstance(t, dict):
            return {{k: plus_one(v) for k, v in t.items()}}
        if isinstance(t, list):
            return [plus_one(v) for v in t]
        return t + 1

    def fault(case, module_name, on_rank_1, root, tree):
        real = getattr(orbax_write, module_name)
        if pid == 1:
            setattr(orbax_write, module_name, on_rank_1(real))
        try:
            checkpoint.save_step(root, 1, tree, group=ranks)
        except orbax_write.OrbaxWriteError as e:
            out["faults"][case] = str(e)
        else:
            out["faults"][case] = None
        finally:
            setattr(orbax_write, module_name, real)
        out["faults"][case + "_listed"] = sorted(os.listdir(root))
        out["faults"][case + "_root"] = root
        ranks.all_gather_object(None)   # each rank listed before the next

    def cannot_write(real):
        def failing(path, values, token=b""):
            raise OSError("planted: the store cannot be written")
        return failing

    def cannot_copy(real):
        def failing(leaf):
            raise OSError("planted: the leaf cannot be copied")
        return failing

    def leave_out(real):   # rank 1's slices of the split leaves left out
        def share(tree, plans, rank, primary):
            return {{k: v for k, v in real(tree, plans, rank, primary)
                    .items() if k.endswith(b".zarray")
                    or plans[k.decode().split("/")[0]].dim < 0}}
        return share

    def both_write(real):   # rank 1 also writes rank 0's replicated chunks
        def share(tree, plans, rank, primary):
            vals = real(tree, plans, rank, primary)
            vals.update({{k: v for k, v in real(tree, plans, 0, False)
                         .items() if plans[k.decode().split("/")[0]]
                         .dim < 0}})
            return vals
        return share

    older = os.path.join(os.getcwd(), "fault_older")
    checkpoint.save_step(older, 1, good, group=ranks)
    fault("store", "write_store", cannot_write, older, plus_one(good))
    fault("leaf", "host_array", cannot_copy, older, plus_one(good))
    fault("left_out", "share", leave_out,
          os.path.join(os.getcwd(), "fault_left_out"),
          out["runs"]["across_sgd"]["local"])
    fault("both_write", "share", both_write,
          os.path.join(os.getcwd(), "fault_both_write"), good)

    # -- refusals, each on every rank -------------------------------------
    def refused(case, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except ValueError as e:
            out["refusals"][case] = (str(e), time.perf_counter() - t0)
        else:
            out["refusals"][case] = (None, time.perf_counter() - t0)
        print(f"refusal {{case}} process={{pid}}: "
              f"{{out['refusals'][case]}}", flush=True)

    devs = mesh.devices()
    refused("layout", lambda: build_on(
        "sgd", mesh.make_mesh("data:4,model:2",
                              [devs[i] for i in (0, 4, 1, 2, 5, 6, 3, 7)])))
    step, tp, to = build("sgd", "model:2,data:4")
    x = xs[0].copy()
    if pid == 1:   # two rows of data shard 2 swapped on rank 1
        x[[8, 9]] = x[[9, 8]]
    refused("rows_differ", lambda: step(tp, to, x, ys[0]))
    step.close()
    step, tp, to = build("sgd", "data:-1")
    rows = 8 if pid == 0 else 4
    refused("unequal_rows", lambda: step(tp, to, xs[0][:rows], ys[0][:rows]))
    rows = 6 if pid == 0 else 8
    refused("batch_not_split",
            lambda: step(tp, to, xs[0][:rows], ys[0][:rows]))
    side = 32 if pid == 0 else 16
    refused("row_shape",
            lambda: step(tp, to, xs[0][:8, :side, :side], ys[0][:8]))
    step.close()

    # -- the trainer element: its mesh is this rank's records -------------
    sp = torch_optim.TorchOptimTrainer()
    sp.configure(TrainerProps(
        model_config={{"apply": lambda p, x, train=False: x @ p["w"] + p["b"],
                       "init": cfg["toy_init"], "batch_size": 8, "lr": 0.1,
                       "mesh": "data:-1"}},
        num_training_samples={toy}, num_epochs=1, device="cpu"),
        lambda ev, data: None)
    sp.start()
    try:
        for x, y in cfg["toy"][pid]:
            sp.push_data([x], [y])
        assert sp.finished.wait(60) and sp.error is None, sp.error
        tmesh_, step = sp.built[0], sp.built[1]
        out["trainer"] = {{
            "records": [d.process_index for d in tmesh_.devices.flat],
            "ranks": step.ranks, "shards": step.data_size,
            "params": sp.trained_params()}}
    finally:
        sp.stop()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print(f"worker ok process={{pid}}", flush=True)
    multihost.shutdown()
""")

JAX_WORKER = textwrap.dedent("""\
    import functools
    import os
    import pickle
    import sys
    os.nice(19)
    sys.path.insert(0, {repo!r})
    import numpy as np

    pid, port, cfg_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                     sys.argv[3], sys.argv[4])

    from nnstreamer_tpu.parallel import multihost

    multihost.initialize(coordinator_address="127.0.0.1:" + port,
                         num_processes=2, process_id=pid)

    import jax
    import jax.numpy as jnp
    import optax

    from nnstreamer_tpu.models import mobilenet as jmb
    from nnstreamer_tpu.parallel import make_mesh, train_step
    from nnstreamer_tpu.parallel.sharded import batch_sharding

    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    xs, ys = cfg["xs"], cfg["ys"]
    b = xs.shape[1] // 2
    mine = slice(pid * b, (pid + 1) * b)
    mesh = make_mesh("data:-1")
    assert len(jax.devices()) == 8 and jax.process_count() == 2
    step, p, o = train_step(
        mesh, functools.partial(jmb.mobilenet_v1_apply, dtype=jnp.float32),
        cfg["tree"], optimizer=optax.sgd(cfg["lr"], momentum=0.9))
    rows = batch_sharding(mesh)
    losses = []
    for x, y in zip(xs, ys):
        p, o, loss = step(
            p, o, jax.make_array_from_process_local_data(rows, x[mine],
                                                         x.shape),
            jax.make_array_from_process_local_data(rows, y[mine], y.shape))
        losses.append(float(loss))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.addressable_data(0)),
                                  p)
    from nnstreamer_tpu.trainers.checkpoint import save_orbax

    res = {{"losses": losses, "tree": tree,
           "saved": os.path.join(os.getcwd(), "jax_saved", "data")}}
    save_orbax(res["saved"], p)

    # (h): the same step on model:2,data:4, each model group across the
    # processes; every process feeds all rows (the batch is replicated
    # over model)
    try:
        from jax.experimental import multihost_utils

        mmesh = make_mesh("model:2,data:4")
        step, p, o = train_step(
            mmesh, functools.partial(jmb.mobilenet_v1_apply,
                                     dtype=jnp.float32),
            cfg["tree"], optimizer=optax.sgd(cfg["lr"], momentum=0.9))
        rows = batch_sharding(mmesh)
        mlosses = []
        for x, y in zip(xs, ys):
            p, o, loss = step(
                p, o, jax.make_array_from_process_local_data(rows, x, x.shape),
                jax.make_array_from_process_local_data(rows, y, y.shape))
            mlosses.append(float(loss))
        res["model"] = {{"losses": mlosses, "tree": jax.tree_util.tree_map(
            lambda a: np.asarray(multihost_utils.process_allgather(
                a, tiled=True)), p),
            "saved": os.path.join(os.getcwd(), "jax_saved", "model")}}
        save_orbax(res["model"]["saved"], p)
    except Exception as e:   # recorded: the test prints what it raised
        res["model"] = {{"error": f"{{type(e).__name__}}: {{e}}"}}
    # (n): the same model:2,data:4 step saved by orbax itself with zarr v3
    # arrays, as an orbax client other than save_orbax saves it
    try:
        import orbax.checkpoint as ocp

        res["zarr3"] = {{"saved": os.path.join(os.getcwd(), "jax_saved",
                                               "zarr3"),
                        "tree": res["model"]["tree"]}}
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
            res["zarr3"]["saved"], args=ocp.args.PyTreeSave(p))
    except Exception as e:
        res["zarr3"] = {{"error": f"{{type(e).__name__}}: {{e}}"}}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    print(f"jax ok process={{pid}} losses={{losses}} model="
          f"{{res['model'].get('losses', res['model'].get('error'))}}",
          flush=True)
""")


QUAD_WORKER = textwrap.dedent("""\
    import functools
    import os
    import pickle
    import sys
    os.nice(19)
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    pid, port, cfg_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                     sys.argv[3], sys.argv[4])

    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.parallel import mesh, multihost, sharded
    from nnstreamer_tpu_torch.trainers import torch_optim

    mesh.set_virtual_devices(2, "cpu")
    multihost.initialize(coordinator_address="127.0.0.1:" + port,
                         num_processes=4, process_id=pid, backend="gloo")
    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    xs, ys = cfg["xs"], cfg["ys"]
    step, tp, to = sharded.train_step(
        mesh.make_mesh("model:2,data:4"),
        functools.partial(convert.mobilenet_v1_tree_apply,
                          dtype=torch.float32),
        cfg["tree"], optimizer=torch_optim._make_optimizer(
            {{"optimizer": "sgd", "lr": cfg["lr"]}}))
    # every rank the rows of its data shards, in shard order
    b = xs.shape[1] // 4
    rows = np.concatenate([np.arange(k * b, (k + 1) * b)
                           for k in step.ranks.index])
    losses = []
    for x, y in zip(xs, ys):
        tp, to, loss = step(tp, to, x[rows], y[rows])
        losses.append(float(loss))
    step.close()
    out = {{"losses": losses, "tree": sharded.trained_tree(tp),
           "index": step.ranks.index, "peers": list(step.ranks.peers.ranks),
           "models": [repr(g) for g in step.ranks.models]}}
    # the four ranks save the step together, then each builds it again
    from nnstreamer_tpu_torch.trainers import checkpoint

    out["saved"] = checkpoint.save_step(
        os.path.join(os.getcwd(), "quad_saved"), 1,
        sharded.trained_tree(tp, gather=False), group=step.ranks.every)
    again, tp2, _ = sharded.train_step(
        mesh.make_mesh("model:2,data:4"),
        functools.partial(convert.mobilenet_v1_tree_apply,
                          dtype=torch.float32),
        checkpoint.load_dir(out["saved"]))
    again.close()
    out["reloaded"] = sharded.trained_tree(tp2)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print(f"quad ok process={{pid}} losses={{losses}}", flush=True)
    multihost.shutdown()
""")


REFS_WORKER = textwrap.dedent("""\
    import os
    import pickle
    import sys
    os.nice(19)
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    import torch

    from nnstreamer_tpu_torch.parallel import mesh

    mesh.set_virtual_devices(8, "cpu")
    torch.set_num_threads(2)
    import test_torch_training_multihost as t

    with open(sys.argv[1], "wb") as f:
        pickle.dump(t._references(), f)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _toy():
    """(f)'s linear model and each rank's own samples."""
    rng = np.random.default_rng(12)
    init = {"w": np.full((6, 4), 0.1, np.float32),
            "b": np.zeros(4, np.float32)}
    per_rank = [[(rng.standard_normal(6).astype(np.float32),
                  np.array([i % 4], np.int32)) for i in range(TOY_SAMPLES)]
                for _ in range(2)]
    return init, per_rank


def _one_process(name, mesh="data:8", perm=None):
    """The one-process step's 3 losses and tree (``_port_steps``), on
    ``_step_data``'s rows in the order ``perm`` where given (patched into
    ``test_torch_training``, whose ``_port_steps`` reads them)."""
    if perm is None:
        return _port_steps(name, STEP_LR, mesh=mesh)
    xs, ys = _step_data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_torch_training, "_step_data",
                   lambda: (xs[:, perm], ys[:, perm]))
        return _port_steps(name, STEP_LR, mesh=mesh)


def _references():
    """What the workers are held to (``REFS_WORKER`` computes it while
    they run, 8 virtual records, 2 threads): the one-process split steps,
    the adam/adamw spread over row orders, the one-device JAX adam/adamw
    steps."""
    refs = {name: _one_process(name) for name in ("sgd", "adam", "adamw")}
    refs["model"] = _one_process("sgd", "data:4,model:2")
    refs["across"] = _one_process("sgd", "model:2,data:4")
    refs["mixed"] = _one_process("sgd", "model:4,data:2")
    refs["spread"], refs["jax"] = {}, {}
    for name in ("adam", "adamw"):
        refs["spread"][name] = max(
            _split_gaps(_one_process(name, perm=np.random.default_rng(
                seed).permutation(16)), refs[name])[1] for seed in (0, 1))
        refs["jax"][name] = _jax_steps(name, STEP_LR)
    return refs


def _start(tmp, name, text, args, env, n=2):
    """``n`` processes of ``text`` (process i gets ``i``, then ``args``,
    then its output path), at a lower priority (each script lowers its
    own): they share the host with other test files' workers."""
    script = tmp / f"{name}_worker.py"
    script.write_text(text.format(repo=REPO, toy=TOY_SAMPLES))
    return [(subprocess.Popen(
        [sys.executable, str(script)] + ([str(i)] if n > 1 else [])
        + [str(a) for a in args] + [str(tmp / f"{name}{i}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp)), tmp / f"{name}{i}.pkl") for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worker pairs, the four-rank world and the references, started
    together: {"port": [rank 0's, rank 1's results], "jax": [...],
    "quad": [the four ranks'], "refs": [what they are held to]}."""
    tmp = tmp_path_factory.mktemp("training_multihost")
    xs, ys = _step_data()
    init, per_rank = _toy()
    cfg = tmp / "cfg.pkl"
    with open(cfg, "wb") as f:
        pickle.dump({"tree": _step_tree(), "xs": xs, "ys": ys, "lr": STEP_LR,
                     "toy_init": init, "toy": per_rank}, f)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    port_env = dict(base, OMP_NUM_THREADS="1")
    jax_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    refs_env = dict(base, JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count=8")
    pairs = {"port": _start(tmp, "port", PORT_WORKER,
                            [_free_port(), cfg], port_env),
             "jax": _start(tmp, "jax", JAX_WORKER, [_free_port(), cfg],
                           jax_env),
             "quad": _start(tmp, "quad", QUAD_WORKER, [_free_port(), cfg],
                            port_env, n=4),
             "refs": _start(tmp, "refs", REFS_WORKER, [], refs_env, n=1)}
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    outs, failed = {}, []
    try:
        for kind, procs in pairs.items():
            for i, (pr, _) in enumerate(procs):
                try:
                    out, _ = pr.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append(f"{kind} worker {i} timed out")
                    continue
                outs[(kind, i)] = out
                if pr.returncode != 0:
                    failed.append(f"{kind} worker {i} exit "
                                  f"{pr.returncode}:\n{out}")
    finally:
        for procs in pairs.values():
            for pr, _ in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.communicate()
    if failed:
        pytest.fail("\n".join(failed))
    res = {}
    for kind, procs in pairs.items():
        res[kind] = []
        for _, path in procs:
            with open(path, "rb") as f:
                res[kind].append(pickle.load(f))
    return res


def _split_gaps(got, want):
    """(losses rel, leaves max) of ``got`` against ``want`` (each
    ``(losses, tree)``)."""
    (lg, tg), (lw, tw) = got, want
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lw))
    worst = max(float(np.abs(a - b).max()) for _, a, b in _pairs(tw, tg))
    return rel, worst


def _ran(runs, case, rank=0):
    r = runs["port"][rank]["runs"][case]
    return r["losses"], r["tree"]


# -- (a) against the JAX step ---------------------------------------------------


def test_two_ranks_match_the_jax_step_on_two_processes(runs):
    jax_runs = runs["jax"]
    assert jax_runs[0]["losses"] == jax_runs[1]["losses"]
    jl, jp = jax_runs[0]["losses"], jax_runs[0]["tree"]
    tl, got = _ran(runs, "sgd")
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    assert tl == pytest.approx(jl, rel=5e-3)
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"two ranks against the two-process JAX step, sgd: losses rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(tl, jl)):.3e}, largest "
          f"leaf update gap {max(gaps.values()):.3e}")
    _hold_updates(gaps, UPDATE_GAP["sgd"])
    assert all(g == 0.0 for p, g in gaps.items()
               if p.endswith(("/mean", "/var")))


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_two_ranks_match_the_one_device_jax_step(runs, name):
    jl, jp = runs["refs"][0]["jax"][name]
    tl, got = _ran(runs, name)
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    assert tl == pytest.approx(jl, rel=5e-3)
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"two ranks against the one-device JAX step, {name}: largest "
          f"leaf update gap {max(gaps.values()):.3e}")
    _hold_updates(gaps, UPDATE_GAP[name])


# -- (b) against the one-process split step ----------------------------------------


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_two_ranks_match_the_one_process_split_step(runs, name):
    rel, worst = _split_gaps(_ran(runs, name), runs["refs"][0][name])
    spread = runs["refs"][0]["spread"].get(name, 0.0)
    print(f"two ranks against one process on data:8, {name}: losses rel "
          f"{rel:.3e}, leaves max {worst:.3e}" + (
              f" (the one process over row orders: {spread:.3e})"
              if spread else ""))
    assert rel <= SPLIT_LOSS_RTOL
    assert worst <= max(SPLIT_LEAF_ATOL, spread)


@pytest.mark.parametrize("case", ["sgd", "adam", "adamw", "model",
                                  "across_sgd", "across_adam",
                                  "across_adamw", "hybrid", "mixed",
                                  "nudged"])
def test_the_ranks_leaves_are_bit_equal(runs, case):
    (l0, t0), (l1, t1) = _ran(runs, case, 0), _ran(runs, case, 1)
    assert l0 == l1
    pairs = list(_pairs(t0, t1))
    assert len(pairs) == 5 + 13 * 2 * 5 + 2
    for path, a, b in pairs:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


# -- (c) planted faults ------------------------------------------------------------


@pytest.mark.parametrize("fault", ["no_grad_reduce", "rank_stats"])
def test_planted_faults_fail_the_split_check(runs, fault):
    rel, worst = _split_gaps(_ran(runs, fault), runs["refs"][0]["sgd"])
    print(f"planted {fault}: losses rel {rel:.3e}, leaves max {worst:.3e}")
    assert rel > SPLIT_LOSS_RTOL or worst > SPLIT_LEAF_ATOL
    assert worst > 10 * SPLIT_LEAF_ATOL


# -- (d) model groups inside each rank ---------------------------------------------


def test_model_groups_inside_ranks_match_one_process(runs):
    assert runs["port"][0]["runs"]["model"]["split"]
    got, want = _ran(runs, "model"), runs["refs"][0]["model"]
    rel, worst = _split_gaps(got, want)
    print(f"two ranks on data:4,model:2 against one process: losses rel "
          f"{rel:.3e}, leaves max {worst:.3e}")
    assert got[0][0] == pytest.approx(want[0][0], rel=MODEL_FIRST_LOSS_RTOL)
    assert rel <= SPLIT_LOSS_RTOL
    assert worst <= MODEL_LEAF_ATOL


# -- (g)-(j) model groups across the ranks -----------------------------------------


def _across_limits(got, want):
    """(d)'s limits: the first loss, the later losses, the leaves."""
    rel, worst = _split_gaps(got, want)
    return (abs(got[0][0] - want[0][0]) / abs(want[0][0])
            <= MODEL_FIRST_LOSS_RTOL and rel <= SPLIT_LOSS_RTOL
            and worst <= MODEL_LEAF_ATOL), rel, worst


@pytest.mark.parametrize("case,ref", [("across_sgd", "across"),
                                      ("hybrid", "across"),
                                      ("mixed", "mixed"),
                                      ("nudged", "across")])
def test_model_groups_across_ranks_match_one_process(runs, case, ref):
    """(g): every model group across the two ranks (``model:2,data:4``;
    the same shape from ``hybrid_mesh`` with ``model`` its DCN axis;
    ``model:4,data:2``, two records of each group on each rank; (i)'s
    nudged gradient on rank 1) against the one-process step on the same
    mesh shape, at (d)'s limits."""
    r = runs["port"][0]["runs"][case]
    assert r["split"] and r["peers"] == [0]
    got, want = _ran(runs, case), runs["refs"][0][ref]
    ok, rel, worst = _across_limits(got, want)
    print(f"two ranks, {case}, against one process: first loss rel "
          f"{abs(got[0][0] - want[0][0]) / abs(want[0][0]):.3e}, losses rel "
          f"{rel:.3e}, leaves max {worst:.3e}")
    assert ok


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_model_groups_across_ranks_match_the_data_split(runs, name):
    """(g): against the one-process replicated ``data:8`` step at (b)'s
    limits (adam/adamw: (b)'s spread rule)."""
    rel, worst = _split_gaps(_ran(runs, "across_" + name),
                             runs["refs"][0][name])
    spread = runs["refs"][0]["spread"].get(name, 0.0)
    print(f"two ranks on model:2,data:4 against one process on data:8, "
          f"{name}: losses rel {rel:.3e}, leaves max {worst:.3e}")
    assert rel <= SPLIT_LOSS_RTOL
    assert worst <= max(SPLIT_LEAF_ATOL, spread)


def test_model_groups_across_ranks_match_the_jax_step(runs):
    """(h): against the JAX step on two processes over ``data:-1`` at
    (a)'s limits: by SPMD's contract the same function."""
    jl, jp = runs["jax"][0]["losses"], runs["jax"][0]["tree"]
    tl, got = _ran(runs, "across_sgd")
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    assert tl == pytest.approx(jl, rel=5e-3)
    gaps = _update_gaps(_step_tree(), jp, got)
    print(f"two ranks on model:2,data:4 against the two-process JAX step "
          f"on data:-1: largest leaf update gap {max(gaps.values()):.3e}")
    _hold_updates(gaps, UPDATE_GAP["sgd"])


def test_the_jax_step_across_processes_on_a_model_axis(runs):
    """(h): the JAX step on the cross-process ``model:2,data:4`` mesh,
    its gap from its own ``data:-1`` step printed and not held (ROADMAP
    queue C: the reference scales the depthwise gradients by M), or the
    error it raised."""
    got = runs["jax"][0]["model"]
    if "error" in got:
        print(f"the JAX step on model:2,data:4 across two processes raised "
              f"{got['error']}")
        assert got["error"]
        return
    jl, jp = runs["jax"][0]["losses"], runs["jax"][0]["tree"]
    gaps = _update_gaps(_step_tree(), jp, got["tree"])
    dw = max(g for p, g in gaps.items() if "/dw/w" in p)
    print(f"the JAX step on model:2,data:4 across two processes against "
          f"its data:-1 step: losses {got['losses']} vs {jl}, largest leaf "
          f"update gap {max(gaps.values()):.3e}, depthwise weights "
          f"{dw:.3e}")
    assert got["losses"][0] == pytest.approx(jl[0], rel=1e-5)


def test_each_rank_holds_only_its_slices(runs):
    """(i): on ``model:2,data:4`` each rank holds its own slice of each
    split leaf (slice index = rank) on its own record; ``gather=False``
    gives that slice, equal to its part of the gathered tree, and the
    gathered trees are equal on both ranks (the bit-equality test)."""
    from nnstreamer_tpu_torch.parallel.sharded import ShardedLeaf

    for rank in (0, 1):
        r = runs["port"][rank]["runs"]["across_sgd"]
        assert len(r["held"]) == 14, r["held"]   # 13 pointwise + head
        assert all(index == [rank] and len(shapes) == 1
                   for _, index, shapes in r["held"]), r["held"]
        assert r["peers"] == [rank]
        assert all(f"index=[{rank}] of 2, ranks=[0, 1]" in m
                   for m in r["models"]), r["models"]
        n = 0
        for path, whole in _leaves(r["tree"]):
            part = _at(r["local"], path)
            if not isinstance(part, ShardedLeaf):
                assert part.tobytes() == whole.tobytes(), path
                continue
            n += 1
            assert list(part.index) == [rank] and part.count == 2
            (mine,) = part.slices
            k = whole.shape[part.split_dim] // 2
            want = np.take(whole, range(rank * k, (rank + 1) * k),
                           axis=part.split_dim)
            assert mine.tobytes() == np.ascontiguousarray(want).tobytes()
        assert n == 14


def test_a_step_built_again_forms_no_new_group(runs):
    """(i): the subgroups live with the process group: the four of
    ``model:2,data:4`` (one a data shard, each both ranks) serve every
    later step on those sets, and building one again forms none."""
    for rank in (0, 1):
        assert runs["port"][rank]["groups"] == 4
        assert runs["port"][rank]["formed_again"] == 0


# -- (l) four ranks: model groups and data peers both across ranks -----------------


def test_four_ranks_run_their_shards_over_their_peers(runs):
    """``model:2,data:4`` over four ranks of two records: ranks 0 and 2
    hold data shards 0 and 1 (model coordinates 0 and 1), ranks 1 and 3
    shards 2 and 3; the data peers are {0, 1} and {2, 3}."""
    quad = runs["quad"]
    assert [q["index"] for q in quad] == [[0, 1], [2, 3], [0, 1], [2, 3]]
    assert [q["peers"] for q in quad] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    for rank, q in enumerate(quad):
        mates = [0, 2] if rank % 2 == 0 else [1, 3]
        assert all(f"index=[{rank // 2}] of 2, ranks={mates}" in m
                   for m in q["models"]), q["models"]


def test_four_ranks_match_one_process(runs):
    """(l) against the one-process ``model:2,data:4`` step at (g)'s
    limits."""
    q = runs["quad"][0]
    got, want = (q["losses"], q["tree"]), runs["refs"][0]["across"]
    ok, rel, worst = _across_limits(got, want)
    print(f"four ranks on model:2,data:4 against one process: first loss "
          f"rel {abs(got[0][0] - want[0][0]) / abs(want[0][0]):.3e}, losses "
          f"rel {rel:.3e}, leaves max {worst:.3e}")
    assert ok


def test_four_ranks_leaves_are_bit_equal(runs):
    quad = runs["quad"]
    for q in quad[1:]:
        assert q["losses"] == quad[0]["losses"]
        for path, a, b in _pairs(quad[0]["tree"], q["tree"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("fault", ["no_input_reduce", "every_rank_grads",
                                   "both_write_moments"])
def test_planted_faults_fail_the_across_check(runs, fault):
    """(j): the input-gradient sum removed, replicated gradients summed
    over every rank (each shard counted twice), a shard's moments written
    by both ranks of its group: each fails (g)."""
    got, want = _ran(runs, fault), runs["refs"][0]["across"]
    ok, rel, worst = _across_limits(got, want)
    gaps = _update_gaps(_step_tree(), want[1], got[1])
    print(f"planted {fault}: losses rel {rel:.3e}, leaves max {worst:.3e}, "
          f"largest leaf update gap {max(gaps.values()):.3e}")
    assert not ok
    assert max(gaps.values()) > UPDATE_GAP["sgd"]


# -- (e) refusals ------------------------------------------------------------------


@pytest.mark.parametrize("case,match", [
    ("layout", r"model group of data shard 1 \(cpu:1, cpu:2\) on processes "
     r"\[0\]: process 0 holds model coordinates \[0, 1\] of it and \[0\] "
     r"of data shard 0's"),
    ("rows_differ", r"data shard 2's rows differ between the ranks \[0, 1\] "
     r"of its model group"),
    ("unequal_rows", r"unequal count .*\[\(8, 4\), \(4, 4\)\]"),
    ("batch_not_split", r"batch of rank 0 \(6 rows\) does not split over "
     r"its 4 data shards"),
    ("row_shape", r"differ in shape \(row shape by rank: \[\[32, 32, 3\], "
     r"\[16, 16, 3\]\]\)")])
def test_refusals_raise_on_every_rank(runs, case, match):
    import re

    for rank in (0, 1):
        msg, took = runs["port"][rank]["refusals"][case]
        assert msg is not None, f"rank {rank} was not refused"
        assert re.search(match, msg), msg
        assert took < REFUSAL_S


# -- (f) the trainer element trains each rank alone --------------------------------


def test_the_trainer_element_trains_each_rank_alone(runs):
    init, per_rank = _toy()
    got = []
    for rank in (0, 1):
        tr = runs["port"][rank]["trainer"]
        assert tr["records"] == [rank] * 4 and tr["ranks"] is None
        assert tr["shards"] == 4
        # a one-process trainer on this rank's rows, on 4 records
        tmesh.set_virtual_devices(4, "cpu")
        sp = torch_optim.TorchOptimTrainer()
        sp.configure(TrainerProps(
            model_config={"apply": lambda p, x, train=False:
                          x @ p["w"] + p["b"], "init": init,
                          "batch_size": 8, "lr": 0.1, "mesh": "data:-1"},
            num_training_samples=TOY_SAMPLES, num_epochs=1, device="cpu"),
            lambda ev, data: None)
        sp.start()
        try:
            for x, y in per_rank[rank]:
                sp.push_data([x], [y])
            assert sp.finished.wait(60) and sp.error is None
            want = sp.trained_params()
        finally:
            sp.stop()
            tmesh.set_virtual_devices(8, "cpu")
        for k in ("w", "b"):
            np.testing.assert_allclose(tr["params"][k], want[k], rtol=0,
                                       atol=1e-6, err_msg=k)
        got.append(tr["params"])
    assert not np.allclose(got[0]["w"], got[1]["w"], atol=1e-3)


def test_rank_exchange_fills_its_rows_and_keeps_their_gradient(monkeypatch):
    """``RankExchange`` with a stand-in all-reduce that adds what the
    other rank would: forward, a zero buffer with this rank's rows at
    their global indices plus the other's; backward, the summed gradient
    buffer's rows of this rank."""
    from nnstreamer_tpu_torch.parallel import multihost, syncbn

    monkeypatch.setattr(multihost, "process_info", lambda: (1, 2))
    ranks = syncbn.RankShards([2, 3], 4)
    assert (ranks.rank, ranks.world, ranks.size) == (1, 2, 4)
    g = torch.Generator().manual_seed(0)
    other_fwd = torch.zeros(4, 6)
    other_fwd[:2] = torch.randn(2, 6, generator=g)
    other_bwd = torch.randn(4, 6, generator=g)
    seen = []

    def all_reduce(t):
        seen.append(t.clone())
        t.add_(other_fwd if len(seen) == 1 else other_bwd)

    monkeypatch.setattr(ranks, "all_reduce", all_reduce)
    local = torch.randn(2, 6, generator=g, requires_grad=True)
    out = ranks.exchange(local)
    assert torch.equal(seen[0][:2], torch.zeros(2, 6))
    assert torch.equal(out[:2], other_fwd[:2])
    assert torch.equal(out[2:], local.detach())
    w = torch.randn(4, 6, generator=g)
    (out * w).sum().backward()
    assert len(seen) == 2 and torch.equal(seen[1], w)
    assert torch.equal(local.grad, (w + other_bwd)[2:])
    assert ranks.exchange_s > 0


def _records(owners):
    return [tmesh.Device("cpu", i, p, torch.device("cpu"))
            for i, p in enumerate(owners)]


def test_data_shards_of_ranks_outside_the_group_are_refused():
    """In a one-process world a mesh holding another process's data
    shards has no group to reduce over: refused, naming the owners."""
    from nnstreamer_tpu_torch.parallel import sharded

    mesh = tmesh.make_mesh("data:-1", _records([0, 0, 1, 1]))
    with pytest.raises(ValueError, match=r"data shards of processes "
                       r"\[0, 1\]; the step runs over every rank of the "
                       r"process group \(1 here, this one 0\)"):
        sharded.train_step(mesh, lambda p, x, train=False: x @ p["w"],
                           {"w": np.zeros((6, 4), np.float32)})


@pytest.mark.parametrize("who", ["ShardedModel", "shard_params"])
def test_a_sharded_invoke_refuses_a_model_group_across_processes(who):
    """A sharded invoke runs each model group in one process: on a mesh
    whose group lies partly on another process both refuse, naming the
    group and its owners (no remote slice placed here, no IndexError)."""
    from nnstreamer_tpu_torch.parallel import sharded

    mesh = tmesh.make_mesh("model:2,data:2", _records([0, 0, 1, 1]))
    params = {"w": np.zeros((6, 4), np.float32)}
    with pytest.raises(ValueError, match=rf"{who}: the model group "
                       r"\(cpu:0, cpu:2\) lies on processes \[0, 1\]"):
        if who == "ShardedModel":
            sharded.ShardedModel(mesh, lambda p, x: x @ p["w"], params)
        else:
            sharded.shard_params(mesh, params)


def test_a_sharded_invoke_refuses_a_mesh_without_this_process():
    from nnstreamer_tpu_torch.parallel import sharded

    mesh = tmesh.make_mesh("data:2", _records([1, 1]))
    with pytest.raises(ValueError, match=r"holds no data shard of "
                       r"process 0"):
        sharded.ShardedModel(mesh, lambda x: x)


def test_gather_slices_fills_the_others_and_keeps_its_gradient(
        monkeypatch):
    """``_GatherSlices`` with a stand-in subgroup that adds what rank 0
    would: forward, this rank's slice (index 1 of 2) at its place in a
    zero buffer, the other's added; backward, this rank's part of the
    output gradient, no collective."""
    from nnstreamer_tpu_torch.parallel import sharded
    from nnstreamer_tpu_torch.parallel.multihost import Subgroup

    g = torch.Generator().manual_seed(0)
    other = torch.randn(3, 2, 5, generator=g)
    seen = []

    class Stand(Subgroup):
        def all_reduce(self, t):
            seen.append(t.clone())
            t[:, :2] += other

    model = sharded.ModelGroup(0, [1], 2, Stand([0, 1]))
    local = torch.randn(3, 2, 5, generator=g, requires_grad=True)
    out = sharded._GatherSlices.apply(local, model, 1)
    assert torch.equal(seen[0][:, :2], torch.zeros(3, 2, 5))
    assert torch.equal(out[:, :2], other)
    assert torch.equal(out[:, 2:], local.detach())
    w = torch.randn(3, 4, 5, generator=g)
    (out * w).sum().backward()
    assert len(seen) == 1 and torch.equal(local.grad, w[:, 2:])
    # a copy elsewhere keeps which slices, not the subgroup
    import pickle

    copy = pickle.loads(pickle.dumps(model))
    assert (copy.index, copy.count, copy.sub) == ((1,), 2, None)
    with pytest.raises(ValueError, match="no subgroup"):
        copy.all_reduce(torch.zeros(1), "gather")


def test_row_digests_see_a_swap_within_a_shard_and_any_dtype():
    from nnstreamer_tpu_torch.parallel.sharded import _row_digests

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 3, 4)).astype(np.float32))
    d = _row_digests(x, 2)
    assert d.shape == (2, 3) and d.dtype == torch.int64
    y = x.clone()
    y[[4, 5]] = y[[5, 4]]
    e = _row_digests(y, 2)
    assert torch.equal(d[0], e[0]) and not torch.equal(d[1], e[1])
    for dt in (torch.uint8, torch.bfloat16, torch.float64, torch.bool):
        a = _row_digests(x.to(dt), 4)
        assert torch.equal(a, _row_digests(x.to(dt).clone(), 4))


def test_orbax_refuses_a_leaf_split_over_ranks(tmp_path):
    """A rank-local leaf (``trained_tree(gather=False)`` across ranks) is
    not written: the writer names it and the gather to call first."""
    from nnstreamer_tpu_torch.parallel import sharded
    from nnstreamer_tpu_torch.trainers import orbax_write

    leaf = sharded.ShardedLeaf([np.zeros((4, 2), np.float32)], 1,
                               sharded.P(None, "model"), (4, 4),
                               sharded.ModelGroup(0, [1], 2, None))
    with pytest.raises(ValueError, match=r"head.w holds slices \[1\] of 2 "
                       r"on this rank"):
        orbax_write.tree_values({"head": {"w": leaf}})


# -- orbax steps written across processes ------------------------------------------


def _hold_bit_equal(got, want, where):
    """Every leaf of ``got`` bit-equal to ``want``'s, the trained tree's
    137 leaves."""
    pairs = list(_pairs(want, got))
    assert len(pairs) == 5 + 13 * 2 * 5 + 2, where
    for path, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == b.tobytes(), (where, path)


def _process_stores(path):
    return sorted(d for d in os.listdir(path)
                  if d.startswith("ocdbt.process_"))


def _once(path, tree):
    """The once-check of a step written across ranks: (the keys found in
    more than one process store, the chunk bytes decoded over every
    process store, the leaves' bytes), and the chunk bytes by store."""
    from nnstreamer_tpu_torch.nativelib import zstd_decompress
    from nnstreamer_tpu_torch.trainers.ocdbt import Ocdbt

    seen, by_store = {}, {}
    for name in _process_stores(path):
        db = Ocdbt(os.path.join(path, name))
        try:
            by_store[name] = 0
            for k in db.list():
                seen.setdefault(k, []).append(name)
                if not k.endswith(".zarray"):
                    by_store[name] += zstd_decompress(db.read(k)).nbytes
        finally:
            db.close()
    twice = {k: v for k, v in seen.items() if len(v) > 1}
    want = sum(a.nbytes for _, a, _ in _pairs(tree, tree))
    return twice, sum(by_store.values()), want, by_store


def _saved(runs, case):
    """(the step path, the tree the ranks saved, the ranks' results)."""
    if case == "quad":
        return runs["quad"][0]["saved"], runs["quad"][0]["tree"], runs["quad"]
    ranks = [r["runs"][case] for r in runs["port"]]
    return ranks[0]["saved"], ranks[0]["tree"], ranks


@pytest.mark.parametrize("case", ["sgd", "across_sgd", "quad"])
def test_a_step_saved_across_ranks_reads_bit_equal_in_both_packages(runs,
                                                                    case):
    """(a)-(c): the ranks' step on ``data:-1`` (two ranks), on
    ``model:2,data:4`` (two ranks, each saving its slices of the split
    leaves) and on four ranks, saved with ``save_step(..., group=)``: one
    step directory with a store a rank, which the JAX package's
    ``load_orbax`` and the port's ``load_dir`` each read bit-equal to the
    gathered tree."""
    from nnstreamer_tpu.trainers.checkpoint import load_orbax as jload
    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir

    path, tree, ranks = _saved(runs, case)
    assert all(r["saved"] == path for r in ranks)
    n = len(ranks)
    assert sorted(os.listdir(path)) == sorted(
        ["_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt"]
        + [f"ocdbt.process_{i}" for i in range(n)])
    assert sorted(os.listdir(os.path.dirname(path))) == ["1"]
    _hold_bit_equal(load_dir(path), tree, f"{case}: load_dir")
    _hold_bit_equal(jload(path), tree, f"{case}: the JAX load_orbax")


@pytest.mark.parametrize("case", ["sgd", "across_sgd", "quad"])
def test_each_chunk_is_written_once(runs, case):
    """(b): no store key lies in two process stores, and the chunk bytes
    over the stores are the leaves' bytes, each written once; every rank
    writes a share."""
    path, tree, ranks = _saved(runs, case)
    twice, total, want, by_store = _once(path, tree)
    print(f"{case}: chunk bytes by process store {by_store}, the leaves "
          f"{want} B; save s by rank "
          f"{[round(r.get('save_s', 0.0), 3) for r in ranks]}")
    assert not twice and total == want
    assert all(b > 0 for b in by_store.values())


@pytest.mark.parametrize("case", ["sgd", "across_sgd", "quad"])
def test_each_rank_builds_the_saved_step_again(runs, case):
    """(f): each rank reads the step back with ``load_dir`` and builds the
    same step from it: its leaves are the saved ones, on every rank."""
    _, tree, ranks = _saved(runs, case)
    for rank, r in enumerate(ranks):
        _hold_bit_equal(r["reloaded"], tree, f"{case}: rank {rank}")


@pytest.mark.parametrize("case", ["data", "model"])
def test_the_port_reads_the_jax_step_saved_from_two_processes(runs, case):
    """(d): the JAX ``save_orbax`` called from both JAX processes (a store
    a process, chunks of the replicated leaves spread over both): the
    port's ``load_dir`` reads every leaf bit-equal to the JAX tree."""
    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir

    res = runs["jax"][0] if case == "data" else runs["jax"][0]["model"]
    assert "error" not in res, res.get("error")
    assert sorted(_process_stores(res["saved"])) == ["ocdbt.process_0",
                                                     "ocdbt.process_1"]
    _hold_bit_equal(load_dir(res["saved"]), res["tree"], case)


def test_the_port_reads_the_jax_zarr3_step_saved_from_two_processes(runs):
    """(n): orbax's ``use_zarr3`` save of the JAX ``model:2,data:4`` step
    from both JAX processes: ``_METADATA`` says zarr v3, each process has
    its store, and the port's ``load_dir`` reads every leaf bit-equal to
    the JAX tree and to orbax's restore of the same step."""
    import jax
    import orbax.checkpoint as ocp
    from jax.sharding import SingleDeviceSharding

    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir
    from nnstreamer_tpu_torch.trainers.ocdbt import Ocdbt

    res = runs["jax"][0]["zarr3"]
    assert "error" not in res, res.get("error")
    path = res["saved"]
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_zarr3"] is True
    assert _process_stores(path) == ["ocdbt.process_0", "ocdbt.process_1"]
    db = Ocdbt(path)
    try:
        keys = db.list()
    finally:
        db.close()
    assert any(k.endswith("/zarr.json") for k in keys)
    assert not any(k.endswith("/.zarray") for k in keys)
    got = load_dir(path)
    _hold_bit_equal(got, res["tree"], "zarr3: load_dir")
    # the step's leaves were sharded over two processes' devices: orbax's
    # restore in one process needs a target placing each on one device
    one = SingleDeviceSharding(jax.devices()[0])
    target = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype,
                                       sharding=one), res["tree"])
    _hold_bit_equal(got, ocp.StandardCheckpointer().restore(path, target),
                    "zarr3: orbax's restore")


def test_the_port_and_jax_steps_across_processes_differ_as_named(runs):
    """(d): the top-level files of the port's and the JAX package's
    two-process ``data:-1`` steps differ only by the JAX step's
    ``_sharding`` and ``array_metadatas/``; their merged stores hold the
    same leaves, each with one ``.zarray`` of one shape and dtype, and
    differ in the chunk grids of the replicated leaves (the JAX step
    splits them over its 8 devices, the port over its 2 ranks)."""
    from nnstreamer_tpu_torch.trainers.ocdbt import Ocdbt

    port, jax_ = runs["port"][0]["runs"]["sgd"]["saved"], \
        runs["jax"][0]["saved"]
    assert set(os.listdir(jax_)) - set(os.listdir(port)) == {
        "_sharding", "array_metadatas"}
    assert set(os.listdir(port)) <= set(os.listdir(jax_))
    zarrays, chunks = {}, {}
    for who, path in (("port", port), ("jax", jax_)):
        db = Ocdbt(path)
        try:
            keys = db.list()
            zarrays[who] = {k: json.loads(db.read(k)) for k in keys
                            if k.endswith(".zarray")}
            chunks[who] = [k for k in keys if not k.endswith(".zarray")]
        finally:
            db.close()
    assert sorted(zarrays["port"]) == sorted(zarrays["jax"])
    grids = 0
    for k, z in zarrays["port"].items():
        j = zarrays["jax"][k]
        assert (z["shape"], z["dtype"]) == (j["shape"], j["dtype"]), k
        grids += z["chunks"] != j["chunks"]
    print(f"merged stores: {len(zarrays['port'])} leaves in both; chunks "
          f"port {len(chunks['port'])}, JAX {len(chunks['jax'])}; chunk "
          f"grids differ in {grids} leaves")
    assert grids > 0


@pytest.mark.parametrize("fault,match", [
    ("store", r"writing each rank's store of \S+ across ranks \[0, 1\] "
     r"failed: rank 1: OSError: planted: the store cannot be written"),
    ("leaf", r"rank 1: ValueError: orbax: chunk \S+/\S+ of \S+ cannot be "
     r"written: OSError: planted: the leaf cannot be copied")])
def test_a_failed_write_raises_on_every_rank_and_keeps_the_older_step(
        runs, fault, match):
    """(e): rank 1 raises before it writes (its store, or a leaf's
    chunk): every rank raises naming rank 1 (and the chunk and its leaf),
    the root holds only the older step, no hidden directory, and that
    step reads as it was written."""
    import re

    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir

    for rank in (0, 1):
        got = runs["port"][rank]["faults"]
        assert got[fault] is not None, f"rank {rank} did not raise"
        assert re.search(match, got[fault]), got[fault]
        assert got[fault + "_listed"] == ["1"]
    root = runs["port"][0]["faults"][fault + "_root"]
    assert sorted(os.listdir(root)) == ["1"]
    _hold_bit_equal(load_dir(os.path.join(root, "1")),
                    runs["port"][0]["runs"]["sgd"]["tree"], fault)


def test_a_rank_whose_slices_are_left_out_fails_the_read(runs):
    """(e): rank 1 leaves its slices of the split leaves out of its store:
    the step is written, and both readers raise on a missing chunk."""
    from nnstreamer_tpu.trainers.checkpoint import load_orbax as jload
    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir
    from nnstreamer_tpu_torch.trainers.orbax_format import OrbaxFormatError

    got = runs["port"][0]["faults"]
    assert got["left_out"] is None and got["left_out_listed"] == ["1"]
    path = os.path.join(got["left_out_root"], "1")
    with pytest.raises(OrbaxFormatError, match=r"chunk '\S+\.1' is missing"):
        load_dir(path)
    with pytest.raises(Exception):
        jload(path)


def test_two_ranks_writing_a_replicated_leaf_fail_the_once_check(runs):
    """(e): rank 1 also writes rank 0's chunks of the replicated leaves:
    (b)'s once-check fails."""
    got = runs["port"][0]["faults"]
    assert got["both_write"] is None
    path = os.path.join(got["both_write_root"], "1")
    twice, total, want, _ = _once(path, runs["port"][0]["runs"]["sgd"]["tree"])
    print(f"both write: {len(twice)} keys in two stores, chunk bytes "
          f"{total} against the leaves' {want}")
    assert twice and total > want
