"""The port's cost capture, the scrape-time MFU join and the H100 peaks.

- The count is pinned exactly against a hand count on a small model: a
  convolution, a linear layer, one ``flash_attention`` call and one
  ``scale_bias_cast`` (FlopCounterMode counts matmuls and convolutions
  as 2·MAC; the kernels add their analytic counts; on the CPU the
  attention's plain version is counted instead, to the same number).
- Through ``torch-cuda``: bucket 0 captured on the call on zeros, a
  window bucket on its first dispatch only, the fold check's two lone
  runs not counted, ``bytes`` = weights + inputs + outputs.
- The join is the JAX package's: the same rows and the same device-time
  observations under one pinned peak give the same executables table and
  utilization samples; ``nns_mfu`` by hand, delta windows, the bucket-1
  series joined to the bucket-0 program, intensity only on the CPU.
- The ratio of the port's count to the JAX package's XLA count on the
  same model, stated: 0.9869 on a small ViT (XLA also counts the
  elementwise work the counter leaves out) and 1.0264 on a small
  SSD-MobileNetV2 (the same convolutions; XLA counts them a little
  lower).
- ``hwspec``: the H100 rows by card name, unknown cards and the CPU
  with no peak, no price unless ``NNS_TPU_TORCH_CHIP_HOUR_USD`` sets one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nnstreamer_tpu.obs.hwspec as jhw
import nnstreamer_tpu.obs.metrics as jmetrics
import nnstreamer_tpu.obs.xlacost as jxc
from nnstreamer_tpu_torch.filters import TorchCudaFilter, register_model
from nnstreamer_tpu_torch.filters.api import FilterProps
from nnstreamer_tpu_torch.obs import hwspec
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import xlacost as txc
from nnstreamer_tpu_torch.obs.metrics import REGISTRY, observe_invoke_phases
from nnstreamer_tpu_torch.obs.xlacost import XLA_COST
from nnstreamer_tpu_torch.ops import kernels

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_hwspec_override():
    prev = hwspec.set_override(None)
    yield
    hwspec.set_override(prev)


def _fam_samples(snap, name):
    return snap["metrics"].get(name, {}).get("samples", [])


# -- the hand count ------------------------------------------------------------

B, H, W, CIN, COUT, D, S = 2, 8, 8, 3, 4, 128, 64


def _small(p, x):
    """uint8 (B,8,8,3) → scale_bias_cast → conv 3x3 → linear → attention."""
    y = kernels.scale_bias_cast(x, 1 / 127.5, -127.5)
    h = F.conv2d(y.permute(0, 3, 1, 2), p["w"], padding=1)    # (B,4,8,8)
    t = F.linear(h.flatten(2).transpose(1, 2), p["lw"])        # (B,64,128)
    q = t.reshape(-1, 1, S, D)
    return kernels.flash_attention(q, q, q)


def _params():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(COUT, CIN, 3, 3, generator=g),
            "lw": torch.randn(D, COUT, generator=g)}


HAND = (2 * B * H * W * CIN                      # scale_bias_cast
        + 2 * B * COUT * H * W * CIN * 3 * 3     # conv, 2·MAC
        + 2 * B * S * COUT * D                   # linear, 2·MAC
        + 4 * B * 1 * S * S * D)                 # attention 4·B·H·S²·D


def test_count_equals_hand_count():
    x = torch.randint(0, 256, (B, H, W, CIN), dtype=torch.uint8)
    with torch.inference_mode():
        out, flops = txc.count(_small, _params(), x)
    assert tuple(out.shape) == (B, 1, S, D)
    assert flops == HAND


def test_kernel_flops_only_inside_a_count():
    txc.add_kernel_flops(1e12)  # no count running: dropped
    x = torch.zeros(4, 8)
    _, flops = txc.count(lambda t: kernels.scale_bias_cast(t, 1.0, 0.0), x)
    assert flops == 2 * 32


def test_filter_captures_bucket0_and_first_window_only():
    name = register_model("xc_small", _small, params=_params(),
                          in_shapes=[(B, H, W, CIN)], in_dtypes=np.uint8)
    XLA_COST.reset()
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda", model=name,
                             device=CPU))
    try:
        row0 = XLA_COST.get(name, 0)
        assert row0["flops"] == HAND and row0["compiles"] == 1
        assert row0["platform"] == "cpu" and row0["placement"] == "host"
        w_bytes = sp.weight_bytes()["bytes"]
        assert w_bytes == sum(t.numel() * 4 for t in _params().values())
        assert row0["bytes"] == w_bytes + B * H * W * CIN + B * S * D * 4
        rng = np.random.default_rng(1)
        frames = [[rng.integers(0, 256, (B, H, W, CIN), dtype=np.uint8)]
                  for _ in range(3)]
        for _ in range(3):  # the first window probes; the rest reuse
            sp.invoke_batched(frames, 4)
        row4 = XLA_COST.get(name, 4)
        # the folded window of 4 runs 4x the frame's work; the fold
        # check's lone runs of the first and last frame are not counted
        assert row4["flops"] == 4 * HAND
        assert row4["compiles"] == 1
    finally:
        sp.close()


# -- the join: the JAX package's arithmetic ------------------------------------

ROWS = [("m_a", 0, 3.2e9, 1.0e6), ("m_a", 8, 2.56e10, 8.0e6),
        ("m_b", 0, 5e8, 4e8)]
OBS = [("element", "el_a", 1, 2e-3), ("element", "el_a", 1, 3e-3),
       ("pool", "pool_a", 8, 9e-3), ("element", "el_b", 1, 1e-3),
       ("element", "el_c", 1, 1e-3)]


@pytest.mark.parametrize("peak", [(989.4e12, 3.35e12), (197e12, 819e9)])
def test_join_same_as_jax(peak):
    out = []
    for xc, metrics, hw in ((jxc, jmetrics, jhw), (txc, tmetrics, hwspec)):
        prev = hw.set_override(hw.HwSpec("pinned", *peak))
        try:
            st = xc.XlaCostStats()
            for src, bucket, flops, nbytes in ROWS:
                st.record(src, bucket, "device", "x",
                          {"flops": flops, "bytes accessed": nbytes})
            st.map_source("el_a", "m_a")
            st.map_source("pool_a", "m_a")
            st.map_source("el_b", "m_b")
            reg = metrics.MetricsRegistry()
            h = reg.histogram("dev", "", labelnames=("kind", "source",
                                                     "bucket"),
                              buckets=metrics.INVOKE_PHASE_BUCKETS)
            for kind, src, bucket, secs in OBS:
                h.labels(kind=kind, source=src,
                         bucket=str(bucket)).observe(secs)
            first = st.join(h._hist_rows())
            h.labels(kind="element", source="el_a",
                     bucket="1").observe(4e-3)
            second = st.join(h._hist_rows())
            out.append((first, second))
        finally:
            hw.set_override(prev)
    assert out[0] == out[1]


def test_mfu_gauge_matches_hand_computation():
    hwspec.set_override(hwspec.H100_SXM)
    flops = 3.2e9
    XLA_COST.record("txc_handmodel", 0, "cuda", "cuda",
                    {"flops": flops, "bytes accessed": 1.0e6})
    XLA_COST.map_source("txc_handelem", "txc_handmodel")
    for _ in range(5):
        observe_invoke_phases("element", "txc_handelem", 1,
                              prep_s=1e-4, device_s=2e-3, drain_s=5e-5)
    snap = REGISTRY.snapshot()
    mfu = [s for s in _fam_samples(snap, "nns_mfu")
           if s["labels"].get("source") == "txc_handelem"]
    expected = flops * 5 / (5 * 2e-3 * 989.4e12)
    assert mfu[0]["value"] == pytest.approx(expected, rel=1e-9)
    bw = [s for s in _fam_samples(snap, "nns_hbm_bw_util")
          if s["labels"].get("source") == "txc_handelem"]
    assert bw[0]["value"] == pytest.approx(
        1.0e6 * 5 / (5 * 2e-3 * 3.35e12), rel=1e-9)
    row = [r for r in snap["executables"]
           if r["source"] == "txc_handmodel"][0]
    assert row["mfu"] == pytest.approx(expected, rel=1e-9)
    assert row["bound"] == "compute"


def test_join_windows_deltas_between_scrapes():
    hwspec.set_override(hwspec.H100_SXM)
    XLA_COST.record("txc_winmodel", 0, "cuda", "cuda",
                    {"flops": 1e9, "bytes accessed": 1e6})
    XLA_COST.map_source("txc_winelem", "txc_winmodel")
    observe_invoke_phases("element", "txc_winelem", 1, 0.0, 1e-3, 0.0)
    REGISTRY.snapshot()
    observe_invoke_phases("element", "txc_winelem", 1, 0.0, 4e-3, 0.0)
    snap = REGISTRY.snapshot()
    mfu = [s for s in _fam_samples(snap, "nns_mfu")
           if s["labels"].get("source") == "txc_winelem"][0]
    assert mfu["value"] == pytest.approx(1e9 / (4e-3 * 989.4e12),
                                         rel=1e-9)


def test_single_frame_hist_bucket_maps_to_bucket0_program():
    hwspec.set_override(hwspec.H100_SXM)
    XLA_COST.record("txc_b0model", 0, "cuda", "cuda",
                    {"flops": 5e8, "bytes accessed": 5e5})
    XLA_COST.map_source("txc_b0elem", "txc_b0model")
    observe_invoke_phases("element", "txc_b0elem", 1, 0.0, 1e-3, 0.0)
    row = [r for r in REGISTRY.snapshot()["executables"]
           if r["source"] == "txc_b0model"][0]
    assert row.get("dispatches_window", 0) >= 1
    assert "mfu" in row


def test_cpu_exports_intensity_only():
    XLA_COST.record("txc_cpumodel", 0, "host", "cpu",
                    {"flops": 1e9, "bytes accessed": 1e6})
    XLA_COST.map_source("txc_cpuelem", "txc_cpumodel")
    observe_invoke_phases("element", "txc_cpuelem", 1, 0.0, 1e-3, 0.0)
    snap = REGISTRY.snapshot()
    row = [r for r in snap["executables"]
           if r["source"] == "txc_cpumodel"][0]
    assert row["intensity_flops_per_byte"] == pytest.approx(1e3)
    assert "mfu" not in row and "hbm_bw_util" not in row
    assert not any(s["labels"].get("source") == "txc_cpuelem"
                   for s in _fam_samples(snap, "nns_mfu"))
    assert any(s["labels"].get("source") == "txc_cpumodel"
               for s in _fam_samples(snap, "nns_executable_flops"))
    fam = snap["metrics"]["nns_executable_bytes"]
    assert "lower bound" in fam["help"]


def test_capture_inert_under_kill_switch(monkeypatch):
    monkeypatch.setattr(txc, "ACTIVE", False)
    XLA_COST.reset()
    out = txc.capture("txc_off", lambda x: x + 1, torch.ones(3))
    assert out.tolist() == [2.0, 2.0, 2.0]
    assert XLA_COST.get("txc_off", 0) is None


# -- the ratio to the JAX package's XLA count ----------------------------------

VIT = dict(image_size=64, patch=16, dim=256, depth=2, mlp_dim=512,
           num_classes=10, heads=2, seed=0)
SSD = dict(num_classes=5, batch=1, size=64, max_out=10, seed=2)


@pytest.mark.parametrize("family,ratio", [("vit", 0.9869), ("ssd", 1.0264)])
def test_ratio_to_jax_count(family, ratio):
    from nnstreamer_tpu.filters.api import FilterProps as JProps
    from nnstreamer_tpu.filters.jax_xla import JaxXlaFilter
    from nnstreamer_tpu.models import ssd as jssd
    from nnstreamer_tpu.models import vit as jvit
    from nnstreamer_tpu_torch.models import ssd as tssd
    from nnstreamer_tpu_torch.models import vit as tvit

    name = f"xc_ratio_{family}"
    if family == "vit":
        jvit.register_vit(name, batch=2, **VIT)
        tvit.register_vit(name, batch=2, **VIT)
    else:
        jssd.register_ssd(name, **SSD)
        tssd.register_ssd(name, **SSD)
    jsp = JaxXlaFilter()
    jsp.configure(JProps(framework="jax-xla", model=name))
    tsp = TorchCudaFilter()
    tsp.configure(FilterProps(framework="torch-cuda", model=name,
                              device=CPU))
    try:
        got = XLA_COST.get(name, 0)["flops"] / \
            jxc.XLA_COST.get(name, 0)["flops"]
    finally:
        jsp.close()
        tsp.close()
    assert got == pytest.approx(ratio, abs=5e-4)


# -- hwspec ------------------------------------------------------------------


@pytest.mark.parametrize("name,spec", [
    ("NVIDIA H100 80GB HBM3", "H100_SXM"), ("NVIDIA H100 PCIe", "H100_PCIE"),
    ("NVIDIA H100 SXM5 80GB", "H100_SXM"), ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None), ("", None)])
def test_hwspec_resolution(name, spec):
    want = getattr(hwspec, spec) if spec else None
    assert hwspec.spec_for_platform(name) is want


def test_hwspec_rows():
    assert (hwspec.H100_SXM.peak_flops, hwspec.H100_SXM.hbm_bw) == \
        (989.4e12, 3.35e12)
    assert (hwspec.H100_PCIE.peak_flops, hwspec.H100_PCIE.hbm_bw) == \
        (756e12, 2.0e12)
    assert hwspec.H100_SXM.ridge == pytest.approx(989.4e12 / 3.35e12)
    assert hwspec.spec_for_platform("tpu") is hwspec.V5E
    prev = hwspec.set_override(hwspec.H100_PCIE)
    try:
        assert hwspec.spec_for_platform("cpu") is hwspec.H100_PCIE
    finally:
        hwspec.set_override(prev)
    assert hwspec.device_platform("cpu") == "cpu"


def test_no_price_unless_set(monkeypatch):
    monkeypatch.delenv("NNS_TPU_TORCH_CHIP_HOUR_USD", raising=False)
    monkeypatch.setenv("NNS_TPU_CHIP_HOUR_USD", "3.0")  # the JAX key
    assert hwspec.chip_hour_price() == 0.0
    assert hwspec.chip_hour_price("NVIDIA H100 80GB HBM3") == 0.0
    monkeypatch.setenv("NNS_TPU_TORCH_CHIP_HOUR_USD", "2.5")
    assert hwspec.chip_hour_price() == 2.5
    monkeypatch.setenv("NNS_TPU_TORCH_CHIP_HOUR_USD", "nope")
    assert hwspec.chip_hour_price() == 0.0
