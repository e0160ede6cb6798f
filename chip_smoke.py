#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and passed over):

1. environment: torch version, the card's name and power limit; requires
   CUDA and compute capability 9.0 (Hopper);
2. build: compiles every kernel of the port from ``nnstreamer_tpu_torch/
   ops/csrc`` with nvcc (sm_90a) into ``build/nnstreamer_tpu_torch/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and on ragged shapes and other input types
   (0 difference expected, at most 1 ulp accepted), and its time (CUDA
   events, median of 30 single launches after warm-up) beside its bound;
4. main path: the composite detection pipeline through ``parse_launch`` at
   full width — SSD-MobileNetV2, 91 classes, 300x300, max_out=10, batch
   256 — with the transform on the CUDA kernel (``backend=cuda``); the
   kernel's launch count must show the run went through it.  The same
   frames through ``backend=torch`` must give byte-equal canvases
   (cuDNN set deterministic for the comparison);
5. profile: one short run of the main path under torch.profiler — the
   kernels by device time and the device's busy share;
6. reference check: a small input (batch 2, f32 compute, TF32 off) through
   the same pipeline on the card and on the CPU must agree;
7. prints a ``{"kernels": [...]}`` line, then, last, the ``ok`` line.

Without a usable card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

BATCH = 256
SIZE = 300
NUM_CLASSES = 91
MAX_OUT = 10
NUM_BUFFERS = 8
POOL = 4
SEED = 0
NORM = "typecast:float32,add:-127.5,div:127.5"

#: spec-sheet HBM bandwidth by card name (NVIDIA data sheets)
HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,   # H100 SXM
    "H100 SXM": 3.35e12,
    "H100 NVL": 3.9e12,
    "H100 PCIe": 2.0e12,
    "H200": 4.8e12,
}

COMPOSITE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend={backend} ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} "
    "option7=device ! appsink name=out max-buffers={sink}")


def hbm_bandwidth(name: str) -> float:
    for key, bw in HBM_BYTES_PER_S.items():
        if key in name:
            return bw
    raise RuntimeError(f"no spec-sheet memory bandwidth known for {name!r}")


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` single calls, each timed by a pair of CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between two float
    tensors of the same dtype."""
    import torch

    iv = torch.int32 if a.dtype == torch.float32 else torch.int16
    return int((a.contiguous().view(iv).long()
                - b.contiguous().view(iv).long()).abs().max())


def register_detector(name: str, model, anchors, batch: int, dtype) -> None:
    """The in-model detector the pipeline's filter runs: SSD + decode +
    NMS, outputs in the postprocess wire order (boxes, classes, scores,
    num) the bounding_boxes decoder consumes."""
    import torch

    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import ssd_detect_apply

    def detect(p, x):
        boxes, scores, classes = ssd_detect_apply(
            p["model"], x, p["anchors"], max_out=MAX_OUT, dtype=dtype)
        num = (scores > 0.25).sum(dim=-1).to(torch.int32)
        return boxes, classes, scores, num

    register_model(name, detect,
                   params={"model": model,
                           "anchors": torch.from_numpy(anchors)},
                   in_shapes=[(batch, SIZE, SIZE, 3)], in_dtypes=np.float32)


def run_pipeline(model: str, backend: str, frames, n: int, device="cuda"):
    """One run of the composite pipeline; returns (pipeline, buffers,
    host seconds from start to EOS)."""
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch(COMPOSITE.format(n=n, norm=NORM, backend=backend,
                                      model=model, s=SIZE, sink=n + 4),
                     device=device)
    p["src"].frames = frames
    p["src"].pool_size = len(frames)
    t0 = time.perf_counter()
    p.start()
    try:
        if not p.wait_eos(timeout=900):
            raise RuntimeError(f"{model}/{backend}: no EOS within 900 s")
    finally:
        p.stop()
    secs = time.perf_counter() - t0
    bufs = []
    while True:
        b = p["out"].pull(timeout=0)
        if b is None:
            break
        bufs.append(b)
    if len(bufs) != n:
        raise RuntimeError(f"{model}/{backend}: {len(bufs)} of {n} buffers")
    return p, bufs, secs


def phase_kernels(card: str, power: str):
    import torch

    from nnstreamer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    cases = [
        ("u8 main", (BATCH, SIZE, SIZE, 3), torch.uint8, torch.float32),
        ("u8 main", (BATCH, SIZE, SIZE, 3), torch.uint8, torch.bfloat16),
        ("u8 ragged", (3, 5), torch.uint8, torch.float32),
        ("u8 ragged", (1, 299, 299, 3), torch.uint8, torch.float32),
        ("i8", (1, 299, 299, 3), torch.int8, torch.float32),
        ("i16", (1, 299, 299, 3), torch.int16, torch.bfloat16),
        ("f32", (1, 299, 299, 3), torch.float32, torch.float32),
        ("f32", (2, 224, 224, 3), torch.float32, torch.bfloat16),
        ("bf16", (1, 299, 299, 3), torch.bfloat16, torch.float32),
        ("bf16", (3, 5), torch.bfloat16, torch.bfloat16),
    ]
    scale, bias = 1.0 / 127.5, -127.5
    worst = 0.0
    for label, shape, idt, odt in cases:
        if idt == torch.uint8:
            x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
        elif idt.is_floating_point:
            x = (torch.randn(shape, generator=g) * 200).to(idt)
        else:
            info = torch.iinfo(idt)
            x = torch.randint(info.min, info.max, shape, generator=g,
                              dtype=torch.int32).to(idt)
        x = x.to(dev)
        y = kernels.scale_bias_cast(x, scale, bias, odt)
        r = kernels.scale_bias_cast_reference(x, scale, bias, odt)
        torch.cuda.synchronize()
        ulps = ulp_diff(y, r)
        diff = float((y.float() - r.float()).abs().max())
        print(f"kernel scale_bias_cast {label} {tuple(shape)} {idt} -> "
              f"{odt}: max_abs_diff={diff} ulps={ulps}", flush=True)
        if ulps > 1:
            raise RuntimeError(f"scale_bias_cast {label}: {ulps} ulp off "
                               "its plain version")
        worst = max(worst, diff)
    # time at the main path's shape and types
    x = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g,
                      dtype=torch.uint8).to(dev)
    n = x.numel()
    bw = hbm_bandwidth(card)
    rows = {}
    for odt in (torch.float32, torch.bfloat16):
        out_bytes = torch.empty((), dtype=odt).element_size()
        ms = time_ms(lambda: kernels.scale_bias_cast(x, scale, bias, odt))
        plain = time_ms(
            lambda: kernels.scale_bias_cast_reference(x, scale, bias, odt))
        bound = n * (1 + out_bytes) / bw * 1e3
        ops_bound = 2 * n / 67e12 * 1e3   # f32 outside the tensor cores
        rows[odt] = (ms, plain, max(bound, ops_bound))
        print(f"kernel scale_bias_cast u8->{odt} {tuple(x.shape)}: "
              f"ms={ms:.6f} plain_ms={plain:.6f} bound_ms={bound:.6f} "
              f"(bytes; {n * (1 + out_bytes)} B at {bw / 1e12} TB/s) "
              f"share_of_bound={bound / ms:.3f} [{card}, {power}]",
              flush=True)
    return worst, rows[torch.float32]


def phase_main_path(card: str, power: str):
    import torch

    from nnstreamer_tpu_torch.core import DType
    from nnstreamer_tpu_torch.elements.transform import (
        _fold_affine,
        parse_arith_ops,
    )
    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        ssd_mobilenet_v2_init,
    )
    from nnstreamer_tpu_torch.ops import kernels

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print("main path: torch.backends.cudnn.deterministic=True, "
          "benchmark=False (a cuDNN algorithm that sums with atomics could "
          "flip a bf16 tie in NMS between the two runs compared)",
          flush=True)
    t0 = time.perf_counter()
    model = ssd_from_jax(ssd_mobilenet_v2_init(SEED, NUM_CLASSES))
    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    register_detector("ssd_mobilenet_v2", model, anchors, BATCH,
                      torch.bfloat16)
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(POOL)]
    print(f"main path: weights + {POOL} frame batches ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.scale_bias_cast.launches = 0
    p, bufs, secs = run_pipeline("ssd_mobilenet_v2", "cuda", frames,
                                 NUM_BUFFERS)
    launches = kernels.scale_bias_cast.launches
    peak = torch.cuda.max_memory_allocated()
    segs = p.fused_segments
    if len(segs) != 1 or (segs[0].transforms, segs[0].filter,
                          segs[0].decoder) != (("norm",), "net", "overlay"):
        raise RuntimeError(f"expected one fused segment norm→net→overlay, "
                           f"got {segs}")
    if launches < NUM_BUFFERS:
        raise RuntimeError(f"scale_bias_cast launched {launches} times for "
                           f"{NUM_BUFFERS} buffers")
    print(f"main path: fused {p.fused_segments[0]}; scale_bias_cast "
          f"launches={launches} for {NUM_BUFFERS} buffers", flush=True)
    for b in bufs:
        canvas = b.tensors[0].torch()
        if tuple(canvas.shape) != (BATCH, SIZE, SIZE, 4) or \
                canvas.dtype != torch.uint8:
            raise RuntimeError(f"canvas {tuple(canvas.shape)} {canvas.dtype}")
        det = b.meta["detections_device"]
        for k in ("boxes", "scores"):
            if not bool(torch.isfinite(det[k]).all()):
                raise RuntimeError(f"non-finite {k} in the detections")
        if det["num"].dtype != torch.int32 or \
                det["classes"].dtype != torch.int32:
            raise RuntimeError("classes/num must be int32")
        if int(det["num"].max()) > MAX_OUT or \
                int(det["classes"].max()) >= NUM_CLASSES:
            raise RuntimeError("num/classes out of range")
    # windows timed on the card: the sink's completion events
    evs = [b.meta["device_done"] for b in bufs]
    gaps = [evs[i - 1].elapsed_time(evs[i]) for i in range(1, len(evs))]
    span = evs[0].elapsed_time(evs[-1])
    fps = (len(evs) - 1) * BATCH / (span / 1e3)
    p50 = statistics.median(gaps)
    print(f"main path (backend=cuda): {fps:.1f} frames/s over windows "
          f"2..{NUM_BUFFERS}, p50 window {p50:.3f} ms, host start→EOS "
          f"{secs:.2f} s, peak device memory {peak / 2**30:.2f} GiB "
          f"[{card}, {power}]", flush=True)
    dets = bufs[-1].meta["detections_device"]
    print("main path: last window, frame 0: num="
          f"{int(dets['num'][0])} classes={dets['classes'][0].tolist()}",
          flush=True)

    _, bufs_plain, secs_plain = run_pipeline("ssd_mobilenet_v2", "torch",
                                             frames, NUM_BUFFERS)
    for i, (a, b) in enumerate(zip(bufs, bufs_plain)):
        if not torch.equal(a.tensors[0].torch(), b.tensors[0].torch()):
            raise RuntimeError(f"window {i}: canvases differ between "
                               "backend=cuda and backend=torch")
        for k in ("boxes", "scores", "classes", "num"):
            if not torch.equal(a.meta["detections_device"][k],
                               b.meta["detections_device"][k]):
                raise RuntimeError(f"window {i}: {k} differ between "
                                   "backend=cuda and backend=torch")
    evs = [b.meta["device_done"] for b in bufs_plain]
    fps_plain = (len(evs) - 1) * BATCH / (evs[0].elapsed_time(evs[-1]) / 1e3)
    print(f"main path (backend=torch): {fps_plain:.1f} frames/s, host "
          f"start→EOS {secs_plain:.2f} s; canvases and detections "
          f"byte-equal to backend=cuda in all {NUM_BUFFERS} windows "
          f"[{card}, {power}]", flush=True)

    # the kernel's prologue output against the plain version, exactly
    a, b, _ = _fold_affine(parse_arith_ops(NORM), DType.UINT8)
    x = torch.from_numpy(frames[0]).cuda()
    k_out = kernels.scale_bias_cast(x, a, b / a, torch.float32)
    r_out = kernels.scale_bias_cast_reference(x, a, b / a, torch.float32)
    if not torch.equal(k_out, r_out):
        raise RuntimeError("prologue: kernel and plain version differ")
    print("main path: prologue kernel output equals the plain version "
          "exactly", flush=True)
    return {"fps": fps, "p50_window_ms": p50, "fps_plain_prologue":
            fps_plain, "host_s": secs, "launches": launches,
            "peak_gib": peak / 2**30, "model": model, "anchors": anchors,
            "frames": frames}


def phase_profile(frames, card: str, power: str, windows: int = 3,
                  top: int = 12):
    """Where the device time goes: one short run of the main path (its
    start included: negotiation runs the filter's program once on zeros
    for the model's declared input and once for the fused one) under
    torch.profiler; prints the kernels by self device time and the
    device's busy share of the run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pipeline("ssd_mobilenet_v2", "cuda", frames[:windows], windows)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if not rows or busy_ms <= 0:
        print("profile: torch.profiler recorded no device kernels here; "
              "device breakdown not measured", flush=True)
        return
    print(f"profile: {windows} windows + 2 negotiation forwards: device "
          f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (busy share "
          f"{busy_ms / wall_ms:.3f}) [{card}, {power}]", flush=True)
    for e in sorted(rows, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]:
        print(f"profile: {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / 1e3 / busy_ms:6.1%} "
              f"n={e.count:5d} {e.key[:100]}", flush=True)


def phase_reference(model, anchors):
    """Small input through the same pipeline on the card and on the CPU
    (f32 compute, TF32 off): the CPU path is the one the CPU tests hold
    against the JAX package."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("reference check: TF32 off (cudnn.allow_tf32=False, "
          "cuda.matmul.allow_tf32=False), f32 compute", flush=True)
    register_detector("ssd_small_f32", model, anchors, 2, torch.float32)
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)]
    _, gpu, _ = run_pipeline("ssd_small_f32", "cuda", frames, 1)
    _, cpu, _ = run_pipeline("ssd_small_f32", "cuda", frames, 1,
                             device="cpu")
    dg, dc = gpu[0].meta["detections_device"], cpu[0].meta[
        "detections_device"]
    for k in ("classes", "num"):
        if not torch.equal(dg[k].cpu(), dc[k]):
            raise RuntimeError(f"reference check: {k} differ card vs CPU: "
                               f"{dg[k].tolist()} vs {dc[k].tolist()}")
    for k in ("boxes", "scores"):
        err = float((dg[k].cpu() - dc[k]).abs().max())
        print(f"reference check: {k} max_abs_diff card vs CPU = {err}",
              flush=True)
        if err > 1e-3:
            raise RuntimeError(f"reference check: {k} differ by {err}")
    same = float((gpu[0].tensors[0].torch().cpu()
                  == cpu[0].tensors[0].torch()).all(dim=-1).float().mean())
    print(f"reference check: canvases agree on {same:.6f} of pixels",
          flush=True)
    if same < 0.999:
        raise RuntimeError("reference check: canvases differ")


def main() -> int:
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card, _, power = (s.strip() for s in smi.partition(","))
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")

    from nnstreamer_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"into {build.BUILD_DIR}", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")

    worst, (ms, plain_ms, bound_ms) = phase_kernels(card, power)
    main_path = phase_main_path(card, power)
    phase_profile(main_path.pop("frames"), card, power)
    phase_reference(main_path.pop("model"), main_path.pop("anchors"))

    print(json.dumps({"main_path": main_path, "card": card,
                      "power_limit": power}))
    print(json.dumps({"kernels": [{
        "name": "scale_bias_cast",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/ops/csrc/scale_bias_cast.cu",
        "replaces": "nnstreamer_tpu/ops/kernels.py:92",
        "launches": main_path["launches"],
        "max_abs_err": worst,
        "max_abs_diff": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "card": card,
        "power_limit": power,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
