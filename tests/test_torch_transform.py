"""The port's ``tensor_transform`` against the JAX package's, on the CPU.

1. Golden replay: the eight committed ``transform_*`` goldens
   (arithmetic, typecast, clamp, stand, transpose, dimchg, padding,
   per_channel) run their own case code from ``tests/golden_cases.py``
   through the port's ``parse_launch(device="cpu")`` and reproduce the
   committed files byte for byte — ``stand`` included, which the JAX
   package misses by one ulp (ROADMAP.md queue C).
2. Every mode against the JAX package's op chain on numpy-seeded inputs:
   output shape and type equal, values equal exactly, except ``stand``
   within rtol 1e-6 + atol 1e-6 (the port accumulates its statistics in
   float64 and multiplies by the reciprocal; the JAX package divides by
   float32 statistics, so the two differ in the last bits).
3. The window-aware chain (``fn_for(spec, lead=1)``) on a stacked window
   equals the per-frame chain frame by frame, exactly.
4. ``donate=true``: a shape- and type-preserving chain runs in place on a
   device payload no one else can see, and a re-read of the input raises
   ``DonatedTensorError``.
5. ``mode=transpose`` + ``mode=stand`` fused before a ``batch=4`` filter
   (the prologue runs on the stacked window) equal the JAX package's
   fused, vmapped window within the stand tolerance above.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_cases
import nnstreamer_tpu.core as jcore
from nnstreamer_tpu.elements import transform as jtransform
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.runtime import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.core import TensorSpec as TSpec
from nnstreamer_tpu_torch.core.buffer import DonatedTensorError
from nnstreamer_tpu_torch.elements import transform as ttransform
from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.runtime import NegotiationError, parse_launch

GOLDEN = ["transform_arithmetic", "transform_typecast", "transform_clamp",
          "transform_stand", "transform_transpose", "transform_dimchg",
          "transform_padding", "transform_per_channel"]


@pytest.mark.parametrize("case", GOLDEN)
def test_golden_replay_byte_exact(case, tmp_path, monkeypatch):
    monkeypatch.setattr(golden_cases, "parse_launch",
                        lambda desc: parse_launch(desc, device="cpu"))
    monkeypatch.setattr(golden_cases, "TensorsSpec", TensorsSpec)
    monkeypatch.setattr(golden_cases, "Buffer", Buffer)
    out = str(tmp_path / f"{case}.out")
    golden_cases.run_case(case, out)
    got = open(out, "rb").read()
    want = open(os.path.join(golden_cases.GOLDEN_DIR, f"{case}.golden"),
                "rb").read()
    assert got == want, f"{case}: {len(got)}B differs from golden"


# (mode, option, frame shape, numpy dtype)
CASES = [
    ("typecast", "int16", (3, 4), np.float32),
    ("typecast", "float32", (2, 3, 4), np.uint8),
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5", (2, 4, 4, 3),
     np.uint8),
    ("arithmetic", "mul:2,pow:2,sub:1", (3, 4), np.float32),
    ("arithmetic", "per-channel-mul:1;2;3,add:0.5", (4, 3), np.float32),
    ("transpose", "1:0:2:3", (1, 2, 3, 4), np.float32),
    ("transpose", "0:2:1", (2, 3, 4), np.uint8),
    ("transpose", "1:0", (5, 3, 4), np.float32),
    ("dimchg", "0:2", (1, 2, 3, 4), np.float32),
    ("dimchg", "2:0", (2, 3, 4), np.int32),
    ("stand", "default", (3, 4), np.float32),
    ("stand", "dc-average", (3, 4), np.float32),
    ("stand", "default:per-channel", (2, 5, 3), np.float32),
    ("stand", "default", (4, 4, 3), np.uint8),
    ("clamp", "-0.5:0.5", (3, 4), np.float32),
    ("clamp", "10:100", (2, 8), np.uint8),
    ("padding", "1:2,value:0.5", (3, 4), np.float32),
    ("padding", "0:1,2:0", (2, 3, 4), np.int32),
    ("padding", "1:1,1:1,value:-1", (2, 3), np.float32),
]
IDS = [f"{m}-{o}-{np.dtype(d).name}" for m, o, _, d in CASES]


def _data(shape, dtype, seed=0, frames=None):
    rng = np.random.default_rng(seed)
    full = shape if frames is None else (frames,) + shape
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(full) * 3).astype(dtype)
    return rng.integers(0, 200, full).astype(dtype)


def _assert_close(mode, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode == "stand":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,option,shape,dtype", CASES, ids=IDS)
def test_mode_matches_jax(mode, option, shape, dtype):
    x = _data(shape, dtype)
    jspec = jcore.TensorSpec.from_shape(shape, dtype)
    want = np.asarray(jtransform._OpChain(mode, option).fn_for(jspec)(
        jnp.asarray(x)))
    tspec = TSpec.from_shape(shape, dtype)
    chain = ttransform._OpChain(mode, option)
    got = chain.fn_for(tspec)(torch.from_numpy(x)).numpy()
    _assert_close(mode, got, want)
    out = chain.out_spec_of(tspec)
    assert (out.shape, out.dtype.np_dtype) == (got.shape, got.dtype)


@pytest.mark.parametrize("mode,option,shape,dtype", CASES, ids=IDS)
def test_window_aware_chain_equals_per_frame(mode, option, shape, dtype):
    xs = _data(shape, dtype, seed=1, frames=3)
    xs[1] *= 2  # frames with other statistics (stand reduces per frame)
    spec = TSpec.from_shape(shape, dtype)
    chain = ttransform._OpChain(mode, option)
    want = np.stack([chain.fn_for(spec)(torch.from_numpy(x)).numpy()
                     for x in xs])
    got = chain.fn_for(spec, lead=1)(torch.from_numpy(xs)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_every_mode_is_ported():
    assert set(ttransform._MODES) == {"typecast", "arithmetic", "transpose",
                                     "dimchg", "stand", "clamp", "padding"}
    assert not hasattr(ttransform, "_UNPORTED_MODES")


def test_bad_option_fails_negotiation():
    p = parse_launch("appsrc name=src ! tensor_transform mode=padding "
                     "option=1:1,1:1,1:1 ! appsink", device="cpu")
    p["src"].spec = TensorsSpec.parse("4:3", "float32")
    with pytest.raises(NegotiationError, match="padding"):
        p.start()
    p.stop()


# -- donate= -----------------------------------------------------------------


def _donate_run(option, x: torch.Tensor, types="float32"):
    p = parse_launch("appsrc name=src ! tensor_transform name=t "
                     f"mode=arithmetic option={option} donate=true ! "
                     "appsink name=out", device="cpu")
    p["src"].spec = TensorsSpec.parse("4:3", types)
    buf = Buffer.of(x)
    with p:
        p["src"].push_buffer(buf)
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=30)
    return buf, p["out"].pull(timeout=1)


def test_donate_runs_in_place_and_rereads_raise():
    x = torch.from_numpy(_data((3, 4), np.float32))
    want = x * 2.0 + 1.0
    ptr = x.data_ptr()
    buf, out = _donate_run("mul:2,add:1", x)
    y = out.tensors[0].torch()
    assert y.data_ptr() == ptr  # written into the donated input
    assert torch.equal(y, want)
    assert buf.tensors[0].is_donated
    with pytest.raises(DonatedTensorError):
        buf.tensors[0].np()
    with pytest.raises(DonatedTensorError):
        buf.tensors[0].torch()


def test_donate_of_a_view_or_a_cast_is_not_in_place():
    base = torch.from_numpy(_data((6, 4), np.float32))
    view = base[:3]
    keep = base.clone()
    buf, out = _donate_run("mul:2,add:1", view)
    assert torch.equal(base, keep)  # the rest of the storage untouched
    assert torch.equal(out.tensors[0].torch(), keep[:3] * 2.0 + 1.0)
    with pytest.raises(DonatedTensorError):
        buf.tensors[0].np()
    u8 = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    buf, out = _donate_run("typecast:float32,add:1", u8, types="uint8")
    assert out.tensors[0].torch().dtype == torch.float32
    with pytest.raises(DonatedTensorError):
        buf.tensors[0].torch()


def test_inplace_chain_equals_plain_bitwise():
    spec = TSpec.from_shape((2, 5, 3), np.float32)
    for mode, option in (("arithmetic", "mul:2,per-channel-add:1;2;3,pow:2"),
                         ("stand", "default"),
                         ("stand", "dc-average:per-channel"),
                         ("clamp", "-1:1")):
        chain = ttransform._OpChain(mode, option)
        x = torch.from_numpy(_data((2, 5, 3), np.float32, seed=4))
        want = chain.fn_for(spec)(x.clone())
        got = chain.inplace_fn_for(spec)(x)
        assert torch.equal(got, want) and got.data_ptr() == x.data_ptr()
    assert ttransform._OpChain("padding", "1:1").inplace_fn_for(spec) is None
    assert ttransform._OpChain("transpose", "1:0:2").inplace_fn_for(
        spec) is None


# -- fused before a micro-batched filter --------------------------------------

FUSED = ("appsrc name=src ! queue ! "
         "tensor_transform name=tr mode=transpose option=1:0:2 ! "
         "tensor_transform name=st mode=stand option=default ! "
         "tensor_filter name=net framework={fw} model=torch_fused_window "
         "batch=4 batch-timeout-ms=60000 ! appsink name=out max-buffers=16")


def test_fused_transpose_and_stand_before_batched_filter_match_jax():
    frame = (2, 3, 4)   # transposed per frame: (2, 4, 3)
    jax_xla.register_model("torch_fused_window", lambda x: x * 2.0 + 1.0,
                           in_shapes=[(2, 4, 3)], in_dtypes=np.float32)
    register_model("torch_fused_window", lambda x: x * 2.0 + 1.0,
                   in_shapes=[(2, 4, 3)], in_dtypes=np.float32)
    xs = _data(frame, np.float32, seed=2, frames=6)
    xs[3] += 5.0
    out = {}
    for pkg, launch, fw, core in (
            ("jax", jax_parse_launch, "jax-xla", jcore),
            ("port", lambda d: parse_launch(d, device="cpu"), "torch-cuda",
             None)):
        p = launch(FUSED.format(fw=fw))
        spec_cls = core.TensorsSpec if core else TensorsSpec
        buf_cls = core.Buffer if core else Buffer
        p["src"].spec = spec_cls.from_shapes([frame], np.float32)
        with p:
            for i, x in enumerate(xs):
                p["src"].push_buffer(buf_cls.of(x, pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=120)
            if pkg == "port":
                assert [(s.transforms, s.filter) for s in
                        p.fused_segments] == [(("tr", "st"), "net")]
                assert p["net"].invoke_stats.total_invoke_num == 2  # 4 + 2
        out[pkg] = [np.asarray(p["out"].pull(timeout=1).tensors[0].np())
                    for _ in xs]
    for i, x in enumerate(xs):
        t = x.transpose(0, 2, 1)
        alone = (t - t.mean()) / t.std() * 2.0 + 1.0
        np.testing.assert_allclose(out["port"][i], out["jax"][i],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["port"][i], alone, rtol=1e-5,
                                   atol=1e-5)
    jax_xla.unregister_model("torch_fused_window")
    unregister_model("torch_fused_window")


def test_flexible_stream_caches_per_schema_fns():
    from nnstreamer_tpu_torch.runtime import Pipeline

    el = ttransform.TensorTransform(name="t", mode="stand", option="default")
    Pipeline(device="cpu").add(el)
    for shape in ((3, 4), (2, 2), (3, 4)):
        x = _data(shape, np.float32, seed=sum(shape))
        got = el.transform(Buffer.of(x)).tensors[0].np()
        np.testing.assert_allclose(got, (x - x.mean()) / x.std(),
                                   rtol=1e-5, atol=1e-6)
    # one entry per schema, the most recent last
    assert [k[0] for k in el._flex_cache] == [(2, 2), (3, 4)]
