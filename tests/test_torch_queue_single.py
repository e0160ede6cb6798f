"""``queue prefetch-host=`` and ``FilterSingle`` in the port against the
JAX package, on the CPU.

1. ``prefetch-host=true`` parses in both packages; a stream of two-tensor
   buffers reaches the sink with the same bytes with and without it, in
   both packages; each tensor crosses device→host exactly once (the JAX
   package at its drain, the port at the queue, reason ``prefetch``, and
   not again at ``np()``, ``tobytes()`` or the decoders' packed drain);
   a buffer a ``leaky=upstream`` queue drops is never prefetched; a host
   tensor is a no-op; a donated tensor raises on a read, its copy
   started or not.  The port's seams run on the CPU with ``CARD_TYPES``
   widened to ``cpu`` (the fake card tag of ``test_torch_transfer.py``).
2. ``FilterSingle`` runs the same ViT weights (``params_io`` files written
   by each package from one tree) as the JAX package's ``FilterSingle``:
   atol 1e-4 + rtol 1e-4 at f32, 5e-2 at bf16 (``test_torch_vit.py``'s
   tolerances); its invoke is synchronous and recorded in ``stats``; its
   entry point defaults to the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.elements.filter as jfilter
import nnstreamer_tpu.obs.transfer as jxfer
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.elements.filter as tfilter
import nnstreamer_tpu_torch.obs.transfer as txfer
import nnstreamer_tpu_torch.runtime as truntime
from nnstreamer_tpu.elements.basic import Queue as JQueue
from nnstreamer_tpu.models import params_io as jio
from nnstreamer_tpu_torch.decoders import drain_once
from nnstreamer_tpu_torch.elements.basic import Queue as TQueue
from nnstreamer_tpu_torch.models import params_io as tio
from nnstreamer_tpu_torch.models import vit as tvit
from test_torch_params_io import HEADS, SMALL

PKGS = {
    "jax": (jruntime.parse_launch, jcore, jxfer, JQueue,
            jnp.asarray),
    "port": (functools.partial(truntime.parse_launch, device="cpu"),
             tcore, txfer, TQueue, torch.from_numpy),
}
N = 6


@pytest.fixture(autouse=True)
def _ledgers(monkeypatch):
    """Fresh ledgers; the CPU counts as a card for the port's seams."""
    monkeypatch.setattr(txfer, "CARD_TYPES", ("cuda", "cpu"))
    for x in (jxfer, txfer):
        x.set_enabled(True)
        x.LEDGER.clear()
    yield
    for x in (jxfer, txfer):
        x.LEDGER.clear()


def _frames():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((2, 4)).astype(np.float32),
             rng.integers(0, 255, (3,), dtype=np.uint8)) for _ in range(N)]


def _d2h(xfer):
    return sum(r["count"] for r in xfer.LEDGER.snapshot()
               if r["direction"] == "d2h")


def _stream(pkg, prefetch):
    parse, core, xfer, _, dev = PKGS[pkg]
    p = parse("appsrc name=src ! queue name=q prefetch-host="
              f"{str(prefetch).lower()} ! appsink name=out max-buffers=16")
    p["src"].spec = core.TensorsSpec.parse("4:2,3", "float32,uint8")
    with p:
        for a, b in _frames():
            p["src"].push_buffer(core.Buffer.of(dev(a), dev(b)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
        return [p["out"].pull(timeout=5) for _ in range(N)]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_prefetch_host_parses(pkg):
    parse = PKGS[pkg][0]
    p = parse("appsrc ! queue prefetch-host=true ! appsink")
    q = [e for e in p.elements.values() if e.FACTORY == "queue"][0]
    assert q.prefetch_host is True


def test_prefetch_sink_bytes_equal_across_packages_and_settings():
    want = b"".join(a.tobytes() + b.tobytes() for a, b in _frames())
    for pkg in PKGS:
        for prefetch in (False, True):
            bufs = _stream(pkg, prefetch)
            got = b"".join(t.tobytes() for b in bufs for t in b.tensors)
            assert got == want, (pkg, prefetch)
            assert _d2h(PKGS[pkg][2]) == 2 * N, (pkg, prefetch)
            PKGS[pkg][2].LEDGER.clear()


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("prefetch", [False, True])
def test_one_crossing_per_tensor(pkg, prefetch):
    xfer = PKGS[pkg][2]
    bufs = _stream(pkg, prefetch)
    for b in bufs:
        for t in b.tensors:
            t.np()
    assert _d2h(xfer) == 2 * N


def test_port_prefetch_is_counted_at_the_queue_and_only_there():
    bufs = _stream("port", True)
    rows = [r for r in txfer.LEDGER.snapshot() if r["direction"] == "d2h"]
    assert [(r["source"], r["reason"], r["count"]) for r in rows] == \
        [("q", "prefetch", 2 * N)]
    assert rows[0]["bytes"] == N * (2 * 4 * 4 + 3)
    # the reads found the started copies: nothing crossed again
    for b in bufs:
        drain_once(b.tensors)
        for t in b.tensors:
            assert not t.prefetching
            t.np()
    assert _d2h(txfer) == 2 * N


def test_port_prefetched_tensor_reads_once_through_np_and_drain():
    t = tcore.Tensor(torch.arange(6, dtype=torch.float32))
    t.prefetch_host()
    assert t.prefetching
    t.prefetch_host()  # in flight already: no second copy
    np.testing.assert_array_equal(drain_once([t])[0], np.arange(6))
    assert not t.prefetching
    assert _d2h(txfer) == 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_prefetched_then_donated_tensor_raises(pkg):
    """Donation wins over a started host copy, in both packages: the
    copy holds the bytes from before the donation, so no read returns
    them."""
    _, core, _, _, dev = PKGS[pkg]
    t = core.Tensor(dev(np.arange(6, dtype=np.float32)))
    t.prefetch_host()
    t.mark_donated()
    with pytest.raises(core.DonatedTensorError):
        t.np()
    with pytest.raises(core.DonatedTensorError):
        t.tobytes()


def test_port_prefetch_of_a_host_tensor_is_a_noop():
    t = tcore.Tensor(np.arange(4, dtype=np.float32))
    t.prefetch_host()
    assert not t.prefetching and _d2h(txfer) == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_leaky_upstream_drop_is_never_prefetched(pkg, monkeypatch):
    _, core, _, Queue, dev = PKGS[pkg]
    seen = []
    real = core.Tensor.prefetch_host

    def counting(self):
        seen.append(self)
        return real(self)

    monkeypatch.setattr(core.Tensor, "prefetch_host", counting)
    q = Queue(name="q", max_size_buffers=1, leaky="upstream",
              prefetch_host=True)
    q._running = True  # enqueue without the loop thread draining
    kept = core.Buffer.of(dev(np.ones(4, np.float32)))
    dropped = core.Buffer.of(dev(np.zeros(4, np.float32)))
    q.chain(q.sinkpad, kept)
    q.chain(q.sinkpad, dropped)
    assert list(q._dq) == [kept]
    assert seen == list(kept.tensors)


# -- 2. FilterSingle ------------------------------------------------------------

SHAPES = [[2, 32, 32, 3]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_single_matches_jax_filter_single(tmp_path, dtype):
    tree = tvit.vit_tree(3, **SMALL)
    x = np.random.default_rng(7).standard_normal(SHAPES[0]).astype(
        np.float32)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    japply = "test_torch_params_io:jax_vit_f32" if dtype == "float32" \
        else "nnstreamer_tpu.models.vit:vit_apply"
    jio.save_npz(jpath, tree, apply=japply, in_shapes=SHAPES,
                 in_dtypes=np.float32)
    tio.save_npz(tpath, tree, apply="nnstreamer_tpu_torch.models.vit:"
                 "vit_tree_apply", in_shapes=SHAPES, in_dtypes=np.float32,
                 apply_kwargs={"heads": HEADS, "dtype": dtype})
    with jfilter.FilterSingle(framework="jax-xla", model=jpath) as jf:
        want = np.asarray(jf.invoke([x])[0], np.float32)
    with tfilter.FilterSingle(framework="auto", model=f"file://{tpath}@v1",
                              device="cpu") as tf:
        assert tf.in_spec.tensors[0].shape == tuple(SHAPES[0])
        assert tf.out_spec.tensors[0].shape == (2, 5)
        out = tf.invoke([x])
        again = tf.invoke([torch.from_numpy(x)])
        assert tf.stats.total_invoke_num == 2
        assert tf.stats.snapshot()["latency_us"] > 0
    got = out[0].float().numpy()
    assert isinstance(out[0], torch.Tensor)
    np.testing.assert_array_equal(got, again[0].float().numpy())
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_filter_single_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tfilter.FilterSingle(framework="custom-easy", model="nothing")


def test_filter_single_set_input_info_and_host_filter():
    """A host framework through FilterSingle: numpy in, the model's
    arrays out, and a reshape through set_input_info."""
    from nnstreamer_tpu_torch.filters import (register_custom_easy,
                                              unregister_custom_easy)

    spec = tcore.TensorsSpec.parse("4", "float32")
    register_custom_easy("_t_single_twice", lambda xs: [xs[0] * 2],
                         in_spec=spec, out_spec=spec)
    try:
        with tfilter.FilterSingle(framework="custom-easy",
                                  model="_t_single_twice",
                                  device="cpu") as fs:
            out = fs.invoke([np.arange(4, dtype=np.float32)])
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          [0.0, 2.0, 4.0, 6.0])
            assert fs.in_spec == spec
    finally:
        unregister_custom_easy("_t_single_twice")

