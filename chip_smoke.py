#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-per-forward DIR   # one count, see below
    python3 chip_smoke.py --serving-legs DIR          # phase 8's legs only

It drives the port's paths — the composite detection pipeline, the ViT
classification pipeline, shared-model serving at the ViT's width and the
model lifecycle of that pool (hot swap, canary, the kernel cache) —
through ``parse_launch`` at full width.
Phases, each of which raises on failure (nothing is caught and passed over):

1. environment: torch version, the card's name and power limit; requires
   CUDA and compute capability 9.0 (Hopper);
2. build: compiles every kernel of the port from ``nnstreamer_tpu_torch/
   ops/csrc`` with nvcc (sm_90a) into ``build/nnstreamer_tpu_torch/``,
   one nvcc per source, all started together, and prints ptxas's report
   per kernel (registers, spills, warnings such as C7508 ``setmaxnreg``
   ignored); the bf16 attention kernel must show no spill and no warning;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the paths' shapes and on ragged shapes and other input types, and its
   device time beside its bound (``time_ms``: 30 calls back to back
   between two CUDA events behind a spin kernel, so the host's launch
   time drops out; median of 5 such groups).  ``scale_bias_cast``: 0
   difference expected, at most 1 ulp accepted.  ``flash_attention``:
   bf16 within atol 1e-2 + rtol 1e-2 and at most 16 bf16 ulps where
   |plain| >= 1/64 (the kernel rounds p to bf16 for p·v), f32 within atol
   1e-5 + rtol 1e-4, on contiguous inputs and on the ViT's head-split
   views of one qkv projection ("vit qkv views"); timed on both layouts
   beside ``scaled_dot_product_attention`` as a yardstick;
4. detection path: the composite detection pipeline through ``parse_launch`` at
   full width — SSD-MobileNetV2, 91 classes, 300x300, max_out=10, batch
   256 — with the transform on the CUDA kernel (``backend=cuda``); the
   kernel's launch count must show the run went through it.  The same
   frames through ``backend=torch`` must give byte-equal canvases
   (cuDNN set deterministic for the comparison);
5. profile: one short run of the main path under torch.profiler — the
   kernels by device time and the device's busy share;
6. reference check: a small input (batch 2, f32 compute, TF32 off) through
   the same pipeline on the card and on the CPU must agree;
7. ViT path: the classification pipeline (``device_src`` → transform with
   ``backend=cuda`` → ViT filter [→ ``tensor_decoder
   mode=image_labeling``]) at the JAX package's benchmark width — batch
   64, 256x256, patch 16, dim 512, depth 6, 4 heads, MLP 2048, 1000
   classes, bf16 compute.
   (a) without the decoder: one fused segment, ``flash_attention`` run at
   least 6 times a window, finite (64, 1000) logits, frames/s and p50
   window; one window's logits with the plain attention swapped in agree
   with the kernel's within atol 5e-2 + rtol 5e-2, same argmax; (b) with
   the decoder: the label is the argmax of (a)'s logits; (c) batch 2, f32,
   TF32 off: card against CPU within 1e-3, labels equal; then a profile,
   and the number of CUDA kernels one forward queues;
8. serving: the JAX package's bench_serving topology at the ViT's width
   — 8 closed-loop streams (8 frames in flight each) of uint8
   (1,256,256,3) frames staged on the card, each ``appsrc ! queue !
   tensor_transform backend=cuda ! tensor_filter`` on the ViT per frame
   ``batch=64 batch-timeout-ms=2 batch-buckets=8,16,32,64 ! tensor_decoder
   mode=image_labeling ! appsink``; two legs, ``share-model=true`` (one
   pool, one cross-stream adaptive window) and ``share-model=false``
   (eight element-level windows), each a warm-up round and then 64 timed
   frames per stream: frames/s, push→pull p50/p99, dispatches, frames and
   streams per dispatch, flushes by reason, kernel launches and peak
   memory.  Every stream's pts come back in order, none lost; the pooled
   logits of every staged frame within 5e-2 (bf16) of the frame run alone
   through a batch-1 pipeline, and every timed label equal to the alone
   argmax wherever its top-2 margin exceeds 5e-2.  Then the non-pooled
   ``batch=16`` path (the prologue fused and run once a window),
   ``flash_attention`` timed at every bucket, and each new transform mode
   on the card against the CPU at (64,256,256,3): byte for byte, ``stand``
   within 1 ulp (float64 sums in another order);
9. lifecycle: the serving topology above (no decoder: the logits are
   checked) with ``is-updatable=true``, the ViT loaded from weights files
   the port's ``params_io`` wrote (v0 from numpy seed 0, v1 from seed 1)
   as ``file://…/vit_v0.safetensors@v0``.  (a) Hot swap: RELOAD_MODEL to
   ``@v1`` while 8 closed-loop streams run, every window timed to the
   card: no frame lost, pts in order, every frame's logits within 1e-4 of
   the frame alone on v0 or v1, each stream v0 then v1 once, every window
   one version, one swap with its ``@v1`` provenance, no fold verdict
   taken after the flip; prints the staging seconds, the flip stall, the
   first v1 window against the steady one, frames/s before, during and
   after staging.  (b) Canary: a pool declaring ``canary=next:1/4``;
   twice RELOAD_MODEL to v1: streams 3 and 7 (``attach_seq % 4 == 3``)
   read v1, the others v0; promote refused before 16 canary frames; the
   first canary rolled back (v0 only at once), the second promoted (v1
   only); dispatches by bucket per version.  (c) A weights-only swap
   from a params dict (seed 2): every frame on the new weights, no
   verdict taken anew.  (d) The kernel cache: three processes on one
   fresh ``NNS_TPU_COMPILE_CACHE_DIR`` — cold (misses and stores), warm
   (hits, no nvcc), after a truncated entry (an error, one rebuild) —
   each launching both kernels against their plain versions.  (e)
   ``flash_attention`` at every bucket the canary's groups reached;
10. prints a ``{"kernels": [...]}`` line, then, last, the ``ok`` line.

Without a usable card it exits non-zero and prints no result.

``--kernels-per-forward DIR`` runs nothing but one full-width ViT forward
with the port found in the checkout DIR and prints how many CUDA kernels
it queued: the same count phase 7 prints, for another tree on the same
card.  ``--serving-legs DIR`` runs nothing but phase 8's shared and
unshared legs with the port in DIR: run it for two trees in one call, in
the order parent, change, change, parent, to compare them.
"""

from __future__ import annotations

import json
import os
import re
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

#: the ViT path: the JAX package's benchmark configuration (bench.py)
VIT_BATCH = 64
VIT_SIZE = 256
VIT = dict(patch=16, dim=512, depth=6, heads=4, mlp_dim=2048,
           num_classes=1000)
LABELS = os.path.join(HERE, "tests", "golden", "labels.txt")
#: spec-sheet dense bf16 tensor-core rate of an H100 SXM
BF16_FLOPS = 989e12
#: the spin ahead of each timed group: about 10 ms at the H100's clocks
SPIN_CYCLES = 20_000_000
#: bf16 ulps (where |plain| >= 1/64) the attention kernel may be off:
#: p is rounded to bf16 (2^-9 relative) before p·v, and o once more
FA_BF16_ULPS = 16

VIT_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "{dec}appsink name=out max-buffers={sink}")
LABEL_DEC = ("tensor_decoder name=label mode=image_labeling "
             f"option1={LABELS} ! ")

#: the serving phase: the JAX package's bench_serving topology
#: (nnstreamer_tpu/bench.py:2139-2156) with the ViT above, per frame
SERVE_STREAMS = 8
SERVE_DEPTH = 8        # frames each closed-loop client keeps in flight
SERVE_WARMUP = 16      # frames per stream before the timed region
SERVE_FRAMES = 64      # timed frames per stream
SERVE_POOL = 16        # distinct frames per stream, staged on the card
SERVE_BUCKETS = (8, 16, 32, 64)
#: pooled logits against the same frame run alone: a window's rows are
#: computed as they are alone, up to the order of a few f32 sums (read
#: 2.9e-6 on an H100); any two different frames' logits must lie more
#: than twice this apart, so a frame swapped or split wrongly fails
SERVE_TOL = 1e-4
SERVE_PIPE = (
    "appsrc name=src max-buffers=32 ! queue max-size-buffers=32 ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} "
    "share-model={share} batch={batch} batch-timeout-ms=2 "
    "batch-buckets={buckets}{sample} ! {dec}appsink name=out "
    "max-buffers=128")

#: the lifecycle phase: the serving topology above with hot reload; no
#: decoder, so every frame's logits can be held against its version alone
LC_PIPE = (
    "appsrc name=src max-buffers=32 ! queue max-size-buffers=32 ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} "
    "share-model=true batch=64 batch-timeout-ms=2 batch-buckets={buckets} "
    "is-updatable=true{canary} ! appsink name=out max-buffers=128")
LC_BEFORE = 256        # frames served (all streams) before the reload
LC_AFTER = 512         # frames served after the flip
LC_ROUND = 16          # frames per stream in each canary round
#: the lifecycle phase's device; its logic also runs on "cpu" at a small
#: width, as a dry run before a call to the card
LC_DEVICE = "cuda"
#: what a kernel-cache probe process runs: load every kernel (building
#: what the cache misses), launch each once against its plain version
CACHE_PROBE = """
import json, sys, time
sys.path.insert(0, {here!r})
import torch
from nnstreamer_tpu_torch.ops import build, kernels
from nnstreamer_tpu_torch.runtime import compilecache
t0 = time.perf_counter()
build.build_all()
for name in build.SOURCES:
    build.load(name)
load_s = time.perf_counter() - t0
x = torch.arange(256, dtype=torch.uint8, device="cuda")
ok = torch.equal(kernels.scale_bias_cast(x, 0.5, 1.0),
                 kernels.scale_bias_cast_reference(x, 0.5, 1.0))
q, k, v = (torch.randn(1, 2, 17, 128, device="cuda").bfloat16()
           for _ in range(3))
ok = ok and torch.allclose(kernels.flash_attention(q, k, v).float(),
                           kernels.flash_attention_reference(q, k, v).float(),
                           atol=1e-2, rtol=1e-2)
print(json.dumps({{"load_s": load_s, "nvcc_runs": build.nvcc_runs,
                  "stats": compilecache.CACHE_STATS.snapshot(),
                  "ok": bool(ok)}}))
"""

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


def time_ms(fn, reps: int = 30, warmup: int = 5, groups: int = 5) -> float:
    """Device time of one call: ``reps`` calls queued back to back between
    one pair of CUDA events, divided by ``reps``; the median of ``groups``
    such groups, after ``warmup`` calls.  A spin kernel queued ahead of
    the start event keeps the card busy while the host queues the group,
    so the host's launch time drops out.  A group whose queueing outlasted
    its spin is discarded and repeated behind a spin lengthened to twice
    the host's time; raises if that still fails ``retries`` times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, retries, times = SPIN_CYCLES, 6, []
    while len(times) < groups:
        e0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(spin)
        s.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        e.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        e.synchronize()
        spin_ms = e0.elapsed_time(s)
        if host_ms < spin_ms:
            times.append(s.elapsed_time(e) / reps)
            continue
        if retries == 0:
            raise RuntimeError(f"time_ms: the host took {host_ms:.3f} ms to "
                               f"queue {reps} calls, the spin only "
                               f"{spin_ms:.3f} ms: host time would count")
        retries -= 1
        spin = int(spin * 2 * host_ms / spin_ms) + 1
        print(f"time_ms: the host took {host_ms:.3f} ms to queue {reps} "
              f"calls, the spin {spin_ms:.3f} ms: group repeated behind "
              f"{spin} spin cycles", flush=True)
    return statistics.median(times)


def bf16_ulps(o, r, floor: float = 2 ** -6) -> float:
    """Largest ``|o - r|`` in bf16 units in the last place of ``r``'s
    binade, over elements with ``|r| >= floor``; nearer zero an ulp says
    nothing and the absolute tolerance governs."""
    import torch

    r = r.float()
    mask = r.abs() >= floor
    if not bool(mask.any()):
        return 0.0
    rr = r[mask]
    ulp = torch.exp2(torch.floor(torch.log2(rr.abs())) - 7)
    return float(((o.float()[mask] - rr).abs() / ulp).max())


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


def composite(model: str, backend: str, n: int) -> str:
    return COMPOSITE.format(n=n, norm=NORM, backend=backend, model=model,
                            s=SIZE, sink=n + 4)


def vit_pipe(model: str, n: int, decoder: bool = False) -> str:
    return VIT_PIPE.format(n=n, norm=NORM, model=model, sink=n + 4,
                           dec=LABEL_DEC if decoder else "")


def run_pipeline(desc: str, frames, n: int, device="cuda"):
    """One run of a pipeline description; returns (pipeline, buffers,
    host seconds from start to EOS)."""
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch(desc, device=device)
    p["src"].frames = frames
    p["src"].pool_size = len(frames)
    t0 = time.perf_counter()
    p.start()
    try:
        if not p.wait_eos(timeout=900):
            raise RuntimeError(f"{desc}: no EOS within 900 s")
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
        raise RuntimeError(f"{desc}: {len(bufs)} of {n} buffers")
    return p, bufs, secs


def _kernel_name(mangled: str) -> str:
    """``flash_attention_bf16_kernel<Li128>`` from the Itanium-mangled
    name after ``_ZN``: the last of its length-prefixed parts, then its
    template arguments as mangled."""
    i, part = 0, ""
    while i < len(mangled) and mangled[i].isdigit():
        m = re.match(r"\d+", mangled[i:])
        n = int(m.group())
        i += len(m.group())
        part, i = mangled[i:i + n], i + n
    args = re.match(r"I(\w*?)EE", mangled[i:])
    return f"{part}<{args.group(1)}>" if args else part


def ptxas_report(log: str):
    """nvcc's ``-Xptxas -v`` output by kernel: the registers, shared
    memory and spill lines and every warning (for example C7508,
    ``setmaxnreg`` ignored), keyed by the kernel's name."""
    report, kernel = {}, None
    for line in log.splitlines():
        line = line.strip()
        m = re.search(r"entry function '_ZN(\w+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            report[kernel] = []
        elif "warning" in line.lower():
            report.setdefault(kernel or "(no kernel)", []).append(line)
        elif kernel and ("Used" in line or "spill" in line):
            report[kernel].append(line.replace("ptxas info    : ", ""))
    return report


def phase_kernels(card: str, power: str):
    import torch

    from nnstreamer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    cases = [
        ("u8 main", (BATCH, SIZE, SIZE, 3), torch.uint8, torch.float32),
        ("u8 main", (BATCH, SIZE, SIZE, 3), torch.uint8, torch.bfloat16),
        ("u8 vit", (VIT_BATCH, VIT_SIZE, VIT_SIZE, 3), torch.uint8,
         torch.float32),
        # the serving phase: one frame (shared leg), a bucket-8 window
        # (unshared leg) and a batch=16 window, each fused or not
        ("u8 serving frame", (1, VIT_SIZE, VIT_SIZE, 3), torch.uint8,
         torch.float32),
        ("u8 serving window", (8, 1, VIT_SIZE, VIT_SIZE, 3), torch.uint8,
         torch.float32),
        ("u8 serving window", (16, 1, VIT_SIZE, VIT_SIZE, 3), torch.uint8,
         torch.float32),
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


def phase_flash_attention(card: str, power: str):
    """``flash_attention`` against its plain version on the card at the
    ViT path's shape and on the other shapes it must take, then its time
    at the path's shape (bf16) beside the plain version, PyTorch's
    ``scaled_dot_product_attention`` (a yardstick only: the port never
    calls it) and the bound."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # the f32 plain version
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    heads, dh = VIT["heads"], VIT["dim"] // VIT["heads"]
    s = (VIT_SIZE // VIT["patch"]) ** 2
    main = (VIT_BATCH, heads, s, dh)
    cases = [
        ("vit main", main, main),
        ("vit qkv views", main, None),
        ("vit 224px S=196", (VIT_BATCH, 2, 196, 128),
         (VIT_BATCH, 2, 196, 128)),
        ("ragged", (1, 2, 17, 128), (1, 2, 17, 128)),
        ("cross", (1, 128, 128), (1, 512, 128)),
        ("D=64", (2, 3, 100, 64), (2, 3, 100, 64)),
    ]
    tol = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-4)}
    worst = 0.0
    for label, q_shape, kv_shape in cases:
        for dt in (torch.bfloat16, torch.float32):
            if kv_shape is None:
                q, k, v = vit_qkv_views(g, dt)
            else:
                q, k, v = (torch.randn(sh, generator=g).to(dt).to(dev)
                           for sh in (q_shape, kv_shape, kv_shape))
            o = kernels.flash_attention(q, k, v)
            r = kernels.flash_attention_reference(q, k, v)
            torch.cuda.synchronize()
            diff = float((o.float() - r.float()).abs().max())
            ulps = bf16_ulps(o, r) if dt == torch.bfloat16 else 0.0
            print(f"kernel flash_attention {label} q{tuple(q.shape)} "
                  f"kv{tuple(k.shape)} strides {q.stride()} {dt}: "
                  f"max_abs_diff={diff}" +
                  (f" max_bf16_ulps(|plain|>=1/64)={ulps:.2f}"
                   if dt == torch.bfloat16 else ""), flush=True)
            atol, rtol = tol[dt]
            bad = (o.float() - r.float()).abs() > atol + rtol * r.float().abs()
            if bool(bad.any()) or not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"flash_attention {label} {dt}: "
                                   f"{int(bad.sum())} elements off its plain "
                                   f"version (atol {atol}, rtol {rtol})")
            if ulps > FA_BF16_ULPS:
                raise RuntimeError(f"flash_attention {label} {dt}: {ulps} "
                                   f"bf16 ulps off its plain version (at "
                                   f"most {FA_BF16_ULPS})")
            worst = max(worst, diff)
    q, k, v = (torch.randn(main, generator=g).to(torch.bfloat16).to(dev)
               for _ in range(3))
    ms = time_ms(lambda: kernels.flash_attention(q, k, v))
    qv, kv, vv = vit_qkv_views(g, torch.bfloat16)
    views_ms = time_ms(lambda: kernels.flash_attention(qv, kv, vv))
    plain = time_ms(lambda: kernels.flash_attention_reference(q, k, v))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * q.shape[0] * q.shape[1] * s * s * dh
    bytes_ms = nbytes / hbm_bandwidth(card) * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"kernel flash_attention bf16 {main}: ms={ms:.6f} (contiguous) "
          f"views_ms={views_ms:.6f} (the ViT's qkv views) "
          f"plain_ms={plain:.6f} sdpa_ms={sdpa:.6f} bound_ms={bound:.6f} "
          f"({by}; {nbytes} B -> {bytes_ms:.6f} ms, {flops} FLOP -> "
          f"{ops_ms:.6f} ms) share_of_bound={bound / ms:.3f} "
          f"vs_sdpa={ms / sdpa:.2f}x [{card}, {power}]", flush=True)
    return worst, {"ms": ms, "views_ms": views_ms, "plain_ms": plain,
                   "library_ms": sdpa, "bound_ms": bound, "bound_by": by}


def vit_qkv_views(g, dtype, batch: int = VIT_BATCH):
    """q, k, v as the ViT path hands them to the kernel: the head-split
    thirds of one (batch, S, 3·dim) qkv projection, strides (S·3·dim, dh,
    3·dim, 1)."""
    import torch

    b, d, h = batch, VIT["dim"], VIT["heads"]
    s = (VIT_SIZE // VIT["patch"]) ** 2
    qkv = torch.randn((b, s, 3 * d), generator=g).to(dtype).cuda()
    return [t.reshape(b, s, h, d // h).transpose(1, 2)
            for t in qkv.split(d, dim=-1)]


def kernels_per_forward(model, x):
    """CUDA kernels one ViT forward queues (torch.profiler; copies and
    fills by the copy engine excluded): (total, of which copy kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.models import vit_apply

    with torch.inference_mode():
        vit_apply(model, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            vit_apply(model, x)
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]
    return (sum(e.count for e in rows),
            sum(e.count for e in rows if "copy" in e.key.lower()))


def count_forward_kernels(root: str) -> int:
    """``--kernels-per-forward ROOT``: the kernels one full-width ViT
    forward queues with the port found under ROOT (another checkout, to
    compare two trees on one card); prints one line, nothing else runs."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import nnstreamer_tpu_torch
    from nnstreamer_tpu_torch.models import vit_init

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    model = vit_init(SEED, image_size=VIT_SIZE, **VIT).cuda()
    x = torch.rand((VIT_BATCH, VIT_SIZE, VIT_SIZE, 3),
                   generator=torch.Generator().manual_seed(SEED)).cuda()
    n, copies = kernels_per_forward(model, x)
    print(f"vit forward with {os.path.dirname(nnstreamer_tpu_torch.__file__)}"
          f": {n} CUDA kernels queued, {copies} of them copy kernels "
          f"[{torch.cuda.get_device_name(0)}]", flush=True)
    return 0


def serving_legs(root: str) -> int:
    """``--serving-legs ROOT``: the serving phase's shared and unshared
    legs with the port found under ROOT (another checkout, to compare two
    trees on one card in one call); prints the legs' lines, nothing else
    runs."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import nnstreamer_tpu_torch
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    card, _, power = (s.strip() for s in card_and_power().partition(","))
    build.build_all()
    register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED, **VIT)
    g = torch.Generator().manual_seed(SEED + 4)
    pools = [[torch.randint(0, 256, (1, VIT_SIZE, VIT_SIZE, 3), generator=g,
                            dtype=torch.uint8).cuda()
              for _ in range(SERVE_POOL)] for _ in range(SERVE_STREAMS)]
    print(f"serving legs with {os.path.dirname(nnstreamer_tpu_torch.__file__)}",
          flush=True)
    for share in (True, False):
        serve_leg(share, pools, card, power)
    return 0


def card_and_power() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    p, bufs, secs = run_pipeline(
        composite("ssd_mobilenet_v2", "cuda", NUM_BUFFERS), frames,
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

    _, bufs_plain, secs_plain = run_pipeline(
        composite("ssd_mobilenet_v2", "torch", NUM_BUFFERS), frames,
        NUM_BUFFERS)
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


def phase_profile(desc: str, frames, card: str, power: str, windows: int = 3,
                  top: int = 12, label: str = "profile"):
    """Where the device time goes: one short run of a path (its start
    included: negotiation runs the filter's program once on zeros for the
    model's declared input and once for the fused one) under
    torch.profiler; prints the kernels by self device time and the
    device's busy share of the run's wall time.  Returns the rows (name,
    self device ms, calls) and the busy ms, or None when the profiler saw
    no device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pipeline(desc, frames[:windows], windows)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if not rows or busy_ms <= 0:
        print(f"{label}: torch.profiler recorded no device kernels here; "
              "device breakdown not measured", flush=True)
        return None
    print(f"{label}: {windows} windows + 2 negotiation forwards: device "
          f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (busy share "
          f"{busy_ms / wall_ms:.3f}) [{card}, {power}]", flush=True)
    rows = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:top]:
        print(f"{label}: {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / 1e3 / busy_ms:6.1%} "
              f"n={e.count:5d} {e.key[:100]}", flush=True)
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in rows], busy_ms


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
    _, gpu, _ = run_pipeline(composite("ssd_small_f32", "cuda", 1), frames, 1)
    _, cpu, _ = run_pipeline(composite("ssd_small_f32", "cuda", 1), frames, 1,
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


def phase_vit(card: str, power: str):
    """The ViT classification path at full width (see the module doc,
    phase 7)."""
    import torch

    import nnstreamer_tpu_torch.models.vit as vit_module
    from nnstreamer_tpu_torch.core import DType
    from nnstreamer_tpu_torch.elements.transform import (
        _fold_affine,
        parse_arith_ops,
    )
    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import register_vit, vit_apply, vit_init
    from nnstreamer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    register_vit("vit_b64", batch=VIT_BATCH, image_size=VIT_SIZE, seed=SEED,
                 **VIT)
    model = vit_init(SEED, image_size=VIT_SIZE, **VIT)  # the same weights
    rng = np.random.default_rng(SEED + 2)
    frames = [rng.integers(0, 256, (VIT_BATCH, VIT_SIZE, VIT_SIZE, 3),
                           dtype=np.uint8) for _ in range(POOL)]
    print(f"vit: {sum(p.numel() for p in model.parameters())} parameters "
          f"({VIT}, image {VIT_SIZE}, batch {VIT_BATCH}) + {POOL} frame "
          f"batches ready in {time.perf_counter() - t0:.2f} s", flush=True)

    # (a) the pipeline without the decoder
    torch.cuda.reset_peak_memory_stats()
    kernels.flash_attention.launches = 0
    kernels.scale_bias_cast.launches = 0
    p, bufs, secs = run_pipeline(vit_pipe("vit_b64", NUM_BUFFERS), frames,
                                 NUM_BUFFERS)
    fa_launches = kernels.flash_attention.launches
    sbc_launches = kernels.scale_bias_cast.launches
    peak = torch.cuda.max_memory_allocated()
    segs = [(s.transforms, s.filter, s.decoder) for s in p.fused_segments]
    if segs != [(("norm",), "net", None)]:
        raise RuntimeError(f"vit: expected one fused segment norm→net, got "
                           f"{p.fused_segments}")
    depth = VIT["depth"]
    if fa_launches < depth * NUM_BUFFERS or sbc_launches < NUM_BUFFERS:
        raise RuntimeError(f"vit: flash_attention launched {fa_launches} "
                           f"times, scale_bias_cast {sbc_launches} times, "
                           f"for {NUM_BUFFERS} windows of depth {depth}")
    print(f"vit (a): fused {p.fused_segments[0]}; flash_attention "
          f"launches={fa_launches}, scale_bias_cast launches={sbc_launches} "
          f"for {NUM_BUFFERS} windows", flush=True)
    logits = [b.tensors[0].torch() for b in bufs]
    for y in logits:
        if tuple(y.shape) != (VIT_BATCH, VIT["num_classes"]) or \
                y.dtype != torch.float32 or not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"vit: logits {tuple(y.shape)} {y.dtype} "
                               "not finite (64, 1000) float32")
    evs = [b.meta["device_done"] for b in bufs]
    gaps = [evs[i - 1].elapsed_time(evs[i]) for i in range(1, len(evs))]
    fps = (len(evs) - 1) * VIT_BATCH / (evs[0].elapsed_time(evs[-1]) / 1e3)
    p50 = statistics.median(gaps)
    print(f"vit (a): {fps:.1f} frames/s over windows 2..{NUM_BUFFERS}, p50 "
          f"window {p50:.3f} ms, host start→EOS {secs:.2f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB [{card}, {power}]", flush=True)

    # one window: the kernel's logits against the plain attention's
    a, b, _ = _fold_affine(parse_arith_ops(NORM), DType.UINT8)
    x_u8 = torch.from_numpy(frames[0]).cuda()
    x = kernels.scale_bias_cast(x_u8, a, b / a)
    if not torch.equal(x, kernels.scale_bias_cast_reference(x_u8, a, b / a)):
        raise RuntimeError("vit: prologue kernel and plain version differ")
    model_card = vit_init(SEED, image_size=VIT_SIZE, **VIT).cuda()
    with torch.inference_mode():
        k_logits = vit_apply(model_card, x)
        vit_module.flash_attention = kernels.flash_attention_reference
        try:
            r_logits = vit_apply(model_card, x)
        finally:
            vit_module.flash_attention = kernels.flash_attention
    if not torch.equal(k_logits, logits[0]):
        raise RuntimeError("vit: the direct forward differs from the "
                           "pipeline's window 0")
    err = float((k_logits - r_logits).abs().max())
    k_arg, r_arg = int(k_logits.argmax()), int(r_logits.argmax())
    print(f"vit kernel vs plain attention, window 0: max_abs_diff={err} "
          f"argmax {k_arg} vs {r_arg}; rows whose argmax differ: "
          f"{int((k_logits.argmax(-1) != r_logits.argmax(-1)).sum())} of "
          f"{VIT_BATCH}", flush=True)
    if not torch.allclose(k_logits, r_logits, atol=5e-2, rtol=5e-2) or \
            k_arg != r_arg:
        raise RuntimeError("vit: kernel and plain attention disagree")

    # (b) the same frames with the image_labeling decoder
    _, lbufs, _ = run_pipeline(vit_pipe("vit_b64", 2, decoder=True), frames,
                               2)
    for i, lb in enumerate(lbufs):
        flat = logits[i].reshape(-1)
        idx = int(flat.argmax())
        if (lb.meta["label_index"], lb.meta["score"]) != \
                (idx, float(flat[idx])):
            raise RuntimeError(
                f"vit (b) window {i}: label_index/score "
                f"{lb.meta['label_index']}/{lb.meta['score']} != argmax/max "
                f"{idx}/{float(flat[idx])} of (a)'s logits")
        print(f"vit (b) window {i}: label {lb.meta['label']!r} index "
              f"{idx} score {lb.meta['score']} = argmax/max of (a)",
              flush=True)

    # (c) batch 2, f32, TF32 off: the card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    register_model("vit_small_f32",
                   lambda m, x: vit_apply(m, x, torch.float32),
                   params=model, in_dtypes=np.float32,
                   in_shapes=[(2, VIT_SIZE, VIT_SIZE, 3)])
    small = [np.random.default_rng(SEED + 3).integers(
        0, 256, (2, VIT_SIZE, VIT_SIZE, 3), dtype=np.uint8)]
    ref = {}
    for device in ("cuda", "cpu"):
        _, lg, _ = run_pipeline(vit_pipe("vit_small_f32", 1), small, 1,
                                device=device)
        _, lb, _ = run_pipeline(vit_pipe("vit_small_f32", 1, decoder=True),
                                small, 1, device=device)
        ref[device] = (lg[0].tensors[0].torch().cpu(), lb[0].meta["label"])
    err_c = float((ref["cuda"][0] - ref["cpu"][0]).abs().max())
    print(f"vit (c) reference check, batch 2, f32, TF32 off: logits "
          f"max_abs_diff card vs CPU = {err_c}; labels "
          f"{ref['cuda'][1]!r} vs {ref['cpu'][1]!r}", flush=True)
    if err_c > 1e-3 or ref["cuda"][1] != ref["cpu"][1]:
        raise RuntimeError("vit (c): card and CPU disagree")

    prof = phase_profile(vit_pipe("vit_b64", 3), frames, card, power,
                         label="vit profile")
    n_kernels, n_copies = kernels_per_forward(model_card, x)
    print(f"vit profile: one forward queues {n_kernels} CUDA kernels, "
          f"{n_copies} of them copy kernels", flush=True)
    share = per_launch = None
    if prof is not None:
        rows, busy = prof
        fa = [(ms, n) for key, ms, n in rows if "flash_attention" in key]
        fa_ms = sum(ms for ms, _ in fa)
        share = fa_ms / busy
        per_launch = fa_ms / max(1, sum(n for _, n in fa))
        print(f"vit profile: flash_attention kernel {fa_ms:.3f} ms of "
              f"{busy:.3f} ms device busy (share {share:.3f}), "
              f"{per_launch:.6f} ms per launch [{card}, {power}]",
              flush=True)
    return {"fps": fps, "p50_window_ms": p50, "host_s": secs,
            "peak_gib": peak / 2**30, "flash_launches": fa_launches,
            "scale_bias_cast_launches": sbc_launches,
            "kernel_vs_plain_max_abs_diff": err, "card_vs_cpu_f32": err_c,
            "flash_share_of_device": share,
            "kernels_per_forward": n_kernels,
            "copy_kernels_per_forward": n_copies,
            "flash_profile_ms_per_launch": per_launch}


def serve_pipe(model: str, share: bool, batch: int = 64,
               buckets: str = ",".join(map(str, SERVE_BUCKETS)),
               decoder: bool = True, every_dispatch: bool = False) -> str:
    """The serving pipeline; ``every_dispatch`` times every dispatch
    (stat-sample-interval-ms=0: it waits for the card each window)."""
    return SERVE_PIPE.format(
        norm=NORM, model=model, share=str(share).lower(), batch=batch,
        buckets=buckets, dec=LABEL_DEC if decoder else "",
        sample=" stat-sample-interval-ms=0" if every_dispatch else "")


def closed_loop(pipes, pools, first_pts: int, n: int, depth: int):
    """Each pipeline gets a client thread that pushes frames of its pool
    (frame ``pts`` is ``pool[pts % len(pool)]``, already on the card),
    keeps ``depth`` of them in flight and pulls every result.  Returns
    (buffers by stream, push→pull seconds of every frame, wall seconds
    from the first push to the last pull)."""
    import threading

    from nnstreamer_tpu_torch.core import Buffer, Tensor

    outs = [[] for _ in pipes]
    lats = [[] for _ in pipes]
    errors = []

    def client(s):
        src, sink, pool = pipes[s]["src"], pipes[s]["out"], pools[s]
        pushed, sent = {}, 0
        try:
            while len(outs[s]) < n:
                while sent < n and sent - len(outs[s]) < depth:
                    pts = first_pts + sent
                    pushed[pts] = time.perf_counter()
                    src.push_buffer(Buffer(
                        tensors=[Tensor(pool[pts % len(pool)])], pts=pts))
                    sent += 1
                b = sink.pull(timeout=120)
                if b is None:
                    raise RuntimeError(f"stream {s}: no result within 120 s "
                                       f"after {len(outs[s])} of {n}")
                lats[s].append(time.perf_counter() - pushed[b.pts])
                outs[s].append(b)
        except Exception as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,), name=f"client{s}")
               for s in range(len(pipes))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"closed loop failed: {errors or 'client hung'}")
    for p in pipes:
        if p.error is not None:
            raise RuntimeError(f"pipeline error: {p.error}")
    return outs, [x for per in lats for x in per], wall


def serve_leg(share: bool, pools, card: str, power: str, decoder=True,
              warmup: int = SERVE_WARMUP, n: int = SERVE_FRAMES,
              profile: bool = False):
    """One leg of the serving phase: SERVE_STREAMS pipelines on the
    per-frame ViT, a warm-up round, then ``n`` timed frames per stream.
    Returns the leg's numbers and its buffers by stream (timed only).

    ``profile``: every dispatch waits for the card and is split into
    host prep, device and host drain (the pool's InvokeStats), and the
    timed region runs under torch.profiler for the device's busy share."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from nnstreamer_tpu_torch.runtime import parse_launch

    label = ("shared" if share else "unshared") + \
        (", profiled" if profile else "")
    pipes = [parse_launch(serve_pipe("vit_serve", share, decoder=decoder,
                                     every_dispatch=profile))
             for _ in range(SERVE_STREAMS)]
    try:
        from nnstreamer_tpu_torch.core import TensorsSpec

        for p in pipes:
            p["src"].spec = TensorsSpec.parse(
                f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
            p.start()
        nets = [p["net"] for p in pipes]
        if share and len({id(f.pool) for f in nets}) != 1:
            raise RuntimeError("shared leg: the filters are not one pool")
        if share and any(p.fused_segments for p in pipes):
            raise RuntimeError("shared leg: a share-model filter was fused")
        if not share and any(
                [(s.transforms, s.filter) for s in p.fused_segments]
                != [(("norm",), "net")] for p in pipes):
            raise RuntimeError("unshared leg: expected norm fused into net")
        if warmup:
            closed_loop(pipes, pools, 0, warmup, SERVE_DEPTH)
        torch.cuda.synchronize()

        def batchers():
            return [nets[0].pool.batcher] if share else \
                [f._batcher for f in nets]

        def counts():
            sts = [nets[0].pool.stats] if share else \
                [f.invoke_stats for f in nets]
            c = {"dispatches": sum(st.total_invoke_num for st in sts),
                 "frames": sum(st.total_frame_num for st in sts),
                 "streams": sum(st.total_stream_num for st in sts)}
            for why in ("full", "deadline", "adaptive", "forced"):
                c[f"flush_{why}"] = sum(getattr(b, f"flushes_{why}")
                                        for b in batchers())
            return c

        before = counts()
        phase0 = dict(nets[0].pool.stats.snapshot()["phase"]) if share \
            else None
        torch.cuda.reset_peak_memory_stats()
        ctx = profiler(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if profile \
            else contextlib.nullcontext()
        with ctx as prof:
            outs, lats, wall = closed_loop(pipes, pools, warmup, n,
                                           SERVE_DEPTH)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = counts()
        phase1 = dict(nets[0].pool.stats.snapshot()["phase"]) if share \
            else None
        for p in pipes:
            p["src"].end_of_stream()
        for p in pipes:
            if not p.wait_eos(timeout=120):
                raise RuntimeError(f"{label} leg: no EOS")
    finally:
        for p in pipes:
            p.stop()
    d = {k: after[k] - before[k] for k in after}
    for s, bufs in enumerate(outs):
        if [b.pts for b in bufs] != list(range(warmup, warmup + n)):
            raise RuntimeError(f"{label} leg, stream {s}: pts out of order "
                               f"or lost: {[b.pts for b in bufs]}")
    lats.sort()
    res = {
        "frames_per_s": SERVE_STREAMS * n / wall,
        "wall_s": wall,
        "p50_ms": lats[len(lats) // 2] * 1e3,
        "p99_ms": lats[min(int(0.99 * len(lats)), len(lats) - 1)] * 1e3,
        "dispatches": d["dispatches"],
        "frames_per_dispatch": d["frames"] / max(d["dispatches"], 1),
        "streams_per_dispatch": (d["streams"] / max(d["dispatches"], 1))
        if share else 1.0,
        "flushes": {k[len("flush_"):]: v for k, v in d.items()
                    if k.startswith("flush_")},
        "peak_gib": peak / 2**30,
    }
    if d["frames"] != SERVE_STREAMS * n:
        raise RuntimeError(f"{label} leg: {d['frames']} frames dispatched "
                           f"for {SERVE_STREAMS * n} pushed")
    if profile and share:
        k = phase1["samples"] - phase0["samples"]
        per = {ph: (phase1[f"{ph}_s"] - phase0[f"{ph}_s"]) / max(k, 1) * 1e3
               for ph in ("host_prep", "device", "host_drain")}
        cycle = wall * 1e3 / max(d["dispatches"], 1)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        res["profile"] = {"sampled_dispatches": k, "window_cycle_ms": cycle,
                          **{f"{ph}_ms": v for ph, v in per.items()},
                          "between_dispatches_ms": cycle - sum(per.values()),
                          "device_busy_ms": busy,
                          "busy_share": busy / (wall * 1e3)}
        print(f"serving profile (shared, every dispatch timed): {k} "
              f"dispatches, window cycle {cycle:.3f} ms = host prep "
              f"{per['host_prep']:.3f} + device {per['device']:.3f} + host "
              f"drain (demux, decoder, sinks) {per['host_drain']:.3f} + "
              f"between dispatches {cycle - sum(per.values()):.3f} ms; "
              f"device busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall "
              f"(share {busy / (wall * 1e3):.3f}) [{card}, {power}]",
              flush=True)
        rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in rows[:8]:
            print(f"serving profile: {e.self_device_time_total / 1e3:9.3f} "
                  f"ms n={e.count:6d} {e.key[:90]}", flush=True)
    print(f"serving {label}: {res['frames_per_s']:.1f} frames/s "
          f"({SERVE_STREAMS} streams x {n} frames, {SERVE_DEPTH} in flight "
          f"each, {wall:.3f} s), push->pull p50 {res['p50_ms']:.3f} ms "
          f"p99 {res['p99_ms']:.3f} ms, {d['dispatches']} dispatches, "
          f"{res['frames_per_dispatch']:.2f} frames and "
          f"{res['streams_per_dispatch']:.2f} streams per dispatch, flushes "
          f"{res['flushes']}, peak device memory {res['peak_gib']:.3f} GiB "
          f"[{card}, {power}]", flush=True)
    return res, outs


def run_alone(pools):
    """Every pool frame through a batch-1 pipeline, one at a time: the
    logits each frame gets alone, by stream."""
    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    n = sum(len(p) for p in pools)
    p = parse_launch(
        "appsrc name=src max-buffers=4 ! tensor_transform mode=arithmetic "
        f"option={NORM} backend=cuda ! tensor_filter framework=torch-cuda "
        f"model=vit_serve ! appsink name=out max-buffers={n + 4}")
    p["src"].spec = TensorsSpec.parse(f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
    with p:
        for i, x in enumerate(x for pool in pools for x in pool):
            p["src"].push_buffer(Buffer(tensors=[Tensor(x)], pts=i))
        p["src"].end_of_stream()
        if not p.wait_eos(timeout=300):
            raise RuntimeError("alone: no EOS")
    flat = [p["out"].pull(timeout=1).tensors[0].torch() for _ in range(n)]
    return [flat[s * len(pools[0]):(s + 1) * len(pools[0])]
            for s in range(len(pools))]


def window_by_bucket(pools, alone):
    """One window of every bucket through a pooled instance's
    ``invoke_batched``, each row against its frame run alone: the fold
    verdict must come out True at every bucket and each row within
    SERVE_TOL.  Returns max_abs_diff by bucket."""
    import torch

    from nnstreamer_tpu_torch.core import DType, TensorSpec
    from nnstreamer_tpu_torch.elements.transform import _OpChain
    from nnstreamer_tpu_torch.filters import TorchCudaFilter
    from nnstreamer_tpu_torch.filters.api import FilterProps

    norm = _OpChain("arithmetic", NORM, backend="cuda").fn_for(
        TensorSpec.from_shape((1, VIT_SIZE, VIT_SIZE, 3), DType.UINT8))
    xs = [norm(x) for pool in pools for x in pool]
    ref = [y for a in alone for y in a]
    sp = TorchCudaFilter.open_shared(FilterProps(
        framework="torch-cuda", model="vit_serve",
        device=torch.device("cuda")))
    diffs = {}
    try:
        for bucket in SERVE_BUCKETS:
            outs = sp.invoke_batched([[x] for x in xs[:bucket]], bucket)
            if sp._batch_fold.get((sp._program.in_spec, bucket)) is not True:
                raise RuntimeError(f"serving: bucket {bucket} does not fold "
                                   "into one call")
            diffs[bucket] = max(float((o[0] - r).abs().max())
                                for o, r in zip(outs, ref))
    finally:
        TorchCudaFilter.close_shared(sp)
    print(f"serving: one window per bucket against its frames alone, "
          f"max_abs_diff by bucket {diffs} (limit {SERVE_TOL})", flush=True)
    if max(diffs.values()) > SERVE_TOL:
        raise RuntimeError(f"serving: a window's logits off alone: {diffs}")
    return diffs


def phase_serving(card: str, power: str):
    """Shared-model serving at the ViT's width: the two legs of the JAX
    package's bench_serving (one pool and its cross-stream window against
    eight element-level windows), the pooled logits against each frame
    run alone, the non-pooled ``batch=16`` path with the fused prologue on
    the window, ``flash_attention`` at every bucket, and the new
    transform modes on the card against the CPU."""
    import torch

    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED, **VIT)
    g = torch.Generator().manual_seed(SEED + 4)
    pools = [[torch.randint(0, 256, (1, VIT_SIZE, VIT_SIZE, 3), generator=g,
                            dtype=torch.uint8).cuda()
              for _ in range(SERVE_POOL)] for _ in range(SERVE_STREAMS)]
    print(f"serving: per-frame ViT ({VIT}, image {VIT_SIZE}) and "
          f"{SERVE_STREAMS}x{SERVE_POOL} frames on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the two legs, each path's kernel counts from 0
    launches = {}
    legs = {}
    for share in (True, False):
        kernels.flash_attention.launches = 0
        kernels.scale_bias_cast.launches = 0
        legs[share], outs = serve_leg(share, pools, card, power)
        launches["shared" if share else "unshared"] = {
            "flash_attention": kernels.flash_attention.launches,
            "scale_bias_cast": kernels.scale_bias_cast.launches}
        if share:
            shared_outs = outs
    frames = SERVE_STREAMS * (SERVE_WARMUP + SERVE_FRAMES)
    sh = launches["shared"]
    if sh["scale_bias_cast"] < frames or \
            sh["flash_attention"] < VIT["depth"] * legs[True]["dispatches"]:
        raise RuntimeError(f"serving: launches {sh} for {frames} frames and "
                           f"{legs[True]['dispatches']} timed dispatches")
    profiled, _ = serve_leg(True, pools, card, power, profile=True)
    ratio = legs[True]["frames_per_s"] / legs[False]["frames_per_s"]
    print(f"serving: shared/unshared frames/s {ratio:.3f}; kernel launches "
          f"{launches} [{card}, {power}]", flush=True)

    # correctness: pooled logits (a leg without the decoder) and the
    # timed leg's labels against every frame run alone
    alone = run_alone(pools)
    _, logit_outs = serve_leg(True, pools, card, power, decoder=False,
                              warmup=0, n=SERVE_POOL)
    worst, checked, labels_checked = 0.0, 0, 0
    for s in range(SERVE_STREAMS):
        for b in logit_outs[s]:
            y, ref = b.tensors[0].torch(), alone[s][b.pts % SERVE_POOL]
            if tuple(y.shape) != (1, VIT["num_classes"]) or \
                    not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"serving: logits {tuple(y.shape)}")
            worst = max(worst, float((y - ref).abs().max()))
            if not torch.allclose(y, ref, atol=SERVE_TOL, rtol=SERVE_TOL):
                raise RuntimeError(f"serving: stream {s} frame {b.pts}: "
                                   "pooled logits differ from alone")
            checked += 1
        for b in shared_outs[s]:
            ref = alone[s][b.pts % SERVE_POOL].reshape(-1)
            top2 = torch.topk(ref, 2).values
            if float(top2[0] - top2[1]) > SERVE_TOL:
                labels_checked += 1
                if b.meta["label_index"] != int(ref.argmax()):
                    raise RuntimeError(f"serving: stream {s} frame {b.pts}: "
                                       "label differs from the frame alone")
    flat = torch.stack([y.reshape(-1) for a in alone for y in a])
    apart = (flat[:, None] - flat[None]).abs().amax(-1)
    apart.fill_diagonal_(float("inf"))
    nearest = float(apart.min())
    del flat, apart
    if nearest <= 2 * SERVE_TOL:
        raise RuntimeError(f"serving: two different frames' logits lie only "
                           f"{nearest} apart: a limit of {SERVE_TOL} could "
                           "not tell a swapped frame")
    print(f"serving: pooled logits of {checked} frames within "
          f"{SERVE_TOL} of each frame alone (max_abs_diff {worst}); the "
          f"nearest two different frames' logits lie {nearest} apart (what "
          f"a frame swapped between streams would read); labels of "
          f"{labels_checked} timed frames (top-2 margin > {SERVE_TOL}) "
          f"equal to alone", flush=True)
    by_bucket_diff = window_by_bucket(pools, alone)

    # the non-pooled batch=16 path: the prologue fused, run on the window
    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    n16 = 64
    p = parse_launch(serve_pipe("vit_serve", False, batch=16, buckets="16",
                                decoder=False))
    p["src"].spec = TensorsSpec.parse(f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
    kernels.flash_attention.launches = 0
    kernels.scale_bias_cast.launches = 0
    with p:
        for i in range(n16):
            p["src"].push_buffer(Buffer(
                tensors=[Tensor(pools[0][i % SERVE_POOL])], pts=i))
        p["src"].end_of_stream()
        if not p.wait_eos(timeout=300):
            raise RuntimeError("batch=16: no EOS")
        windows = p["net"].invoke_stats.total_invoke_num
    b16 = {"windows": windows,
           "scale_bias_cast": kernels.scale_bias_cast.launches,
           "flash_attention": kernels.flash_attention.launches}
    bufs = [p["out"].pull(timeout=1) for _ in range(n16)]
    if [b.pts for b in bufs] != list(range(n16)) or \
            [(x.transforms, x.filter) for x in p.fused_segments] != \
            [(("norm",), "net")]:
        raise RuntimeError("batch=16: pts or fusion wrong")
    # negotiation runs the program on zeros twice (the model's declared
    # input, then the fused one): one prologue and two forwards more; the
    # fold verdict runs the first window's first and last frame alone:
    # two prologues and two forwards more
    if b16["scale_bias_cast"] != windows + 1 + 2 or \
            b16["flash_attention"] != VIT["depth"] * (windows + 2 + 2):
        raise RuntimeError(f"batch=16: launches {b16} for {windows} "
                           "windows")
    worst16 = max(float((b.tensors[0].torch()
                         - alone[0][b.pts % SERVE_POOL]).abs().max())
                  for b in bufs)
    if worst16 > SERVE_TOL:
        raise RuntimeError(f"batch=16: logits {worst16} off alone")
    print(f"serving batch=16 (fused prologue on the window): {n16} frames in "
          f"{windows} windows, scale_bias_cast launches "
          f"{b16['scale_bias_cast']} (one a window + one at negotiation + "
          f"two for the fold verdict), flash_attention "
          f"{b16['flash_attention']}; logits within {worst16} of alone",
          flush=True)

    # flash_attention at every bucket, at the path's qkv views: against
    # its plain version at phase_flash_attention's limits, then timed
    by_bucket, fa_worst = flash_at_buckets(SERVE_BUCKETS, g, card, power)

    modes = phase_transform_modes(card, power)
    print(f"serving phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return {"shared": legs[True], "unshared": legs[False],
            "shared_profiled": profiled,
            "shared_over_unshared": ratio, "launches": launches,
            "pooled_vs_alone_max_abs_diff": worst,
            "nearest_other_frame_max_abs_diff": nearest,
            "window_vs_alone_by_bucket": by_bucket_diff,
            "labels_checked": labels_checked, "batch16": b16,
            "batch16_vs_alone_max_abs_diff": worst16,
            "flash_attention_by_bucket": by_bucket,
            "flash_attention_worst": fa_worst,
            "transform_modes": modes}


def flash_at_buckets(buckets, g, card: str, power: str):
    """``flash_attention`` at each bucket, at the ViT path's qkv views:
    against its plain version at phase_flash_attention's limits, then
    timed beside its bound.  Returns (rows by bucket, worst difference)."""
    import torch

    from nnstreamer_tpu_torch.ops import kernels

    bw = hbm_bandwidth(card)
    heads, dh = VIT["heads"], VIT["dim"] // VIT["heads"]
    s_len = (VIT_SIZE // VIT["patch"]) ** 2
    by_bucket, fa_worst = {}, 0.0
    for bucket in buckets:
        q, k, v = vit_qkv_views(g, torch.bfloat16, batch=bucket)
        o = kernels.flash_attention(q, k, v)
        r = kernels.flash_attention_reference(q, k, v).float()
        torch.cuda.synchronize()
        diff = float((o.float() - r).abs().max())
        ulps = bf16_ulps(o, r)
        bad = int(((o.float() - r).abs() > 1e-2 + 1e-2 * r.abs()).sum())
        if bad or ulps > FA_BF16_ULPS or not bool(torch.isfinite(o).all()):
            raise RuntimeError(f"flash_attention bucket {bucket}: {bad} "
                               f"elements off its plain version (atol/rtol "
                               f"1e-2), {ulps} bf16 ulps (at most "
                               f"{FA_BF16_ULPS})")
        fa_worst = max(fa_worst, diff)
        ms = time_ms(lambda: kernels.flash_attention(q, k, v))
        nbytes = 4 * q.numel() * q.element_size()
        flops = 4 * bucket * heads * s_len * s_len * dh
        bound = max(nbytes / bw * 1e3, flops / BF16_FLOPS * 1e3)
        by_bucket[bucket] = {"ms": ms, "bound_ms": bound,
                             "share_of_bound": bound / ms,
                             "max_abs_diff": diff, "max_bf16_ulps": ulps}
        print(f"kernel flash_attention bf16 ({bucket},{heads},{s_len},{dh}) "
              f"qkv views: max_abs_diff={diff} max_bf16_ulps={ulps:.2f} "
              f"ms={ms:.6f} bound_ms={bound:.6f} "
              f"share_of_bound={bound / ms:.3f} [{card}, {power}]",
              flush=True)
    return by_bucket, fa_worst


def phase_transform_modes(card: str, power: str):
    """Each transform mode this slice ported, on the card at
    (64,256,256,3) against the CPU: byte for byte, and ``stand`` within
    1 ulp (its float64 sums run in another order on the card)."""
    import torch

    from nnstreamer_tpu_torch.core import DType, TensorSpec
    from nnstreamer_tpu_torch.elements.transform import _OpChain

    shape = (VIT_BATCH, VIT_SIZE, VIT_SIZE, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 5))
    spec = TensorSpec.from_shape(shape, DType.FLOAT32)
    xc = x.cuda()
    rows = {}
    for mode, option in (("transpose", "1:0:2:3"), ("dimchg", "0:2"),
                         ("stand", "default"),
                         ("stand", "dc-average:per-channel"),
                         ("clamp", "-0.5:0.5"),
                         ("padding", "1:1,2:2,value:0.5")):
        fn = _OpChain(mode, option).fn_for(spec)
        want = fn(x)
        got = fn(xc).cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{mode} {option}: {got.shape} {got.dtype} on "
                               f"the card, {want.shape} {want.dtype} on CPU")
        ulps = ulp_diff(got, want)
        rows[f"{mode}:{option}"] = ulps
        print(f"transform {mode} option={option} {tuple(shape)} -> "
              f"{tuple(got.shape)}: card vs CPU "
              f"{'byte-equal' if ulps == 0 else f'{ulps} ulp apart'}",
              flush=True)
        if ulps > (1 if mode == "stand" else 0):
            raise RuntimeError(f"{mode} {option}: card and CPU {ulps} ulp "
                               "apart")
    return rows


def write_vit_file(path: str, seed: int) -> str:
    """A ViT weights file at the benchmark width: the JAX package's tree
    (numpy seed ``seed``), applied by the port's ``vit_tree_apply``."""
    from nnstreamer_tpu_torch.models import params_io, vit_tree

    widths = {k: v for k, v in VIT.items() if k != "heads"}
    params_io.save_safetensors(path, vit_tree(seed, image_size=VIT_SIZE,
                                              **widths), {
        "apply": "nnstreamer_tpu_torch.models.vit:vit_tree_apply",
        "apply_kwargs": json.dumps({"heads": VIT["heads"]}),
        "in_shapes": json.dumps([[1, VIT_SIZE, VIT_SIZE, 3]]),
        "in_dtypes": "float32"})
    return path


def alone_logits(model, pools):
    """Every pool frame through a lone instance of ``model`` (a path or a
    ModelDef), one at a time: (16, classes) logits by stream."""
    import torch

    from nnstreamer_tpu_torch.core import DType, TensorSpec
    from nnstreamer_tpu_torch.elements.transform import _OpChain
    from nnstreamer_tpu_torch.filters import TorchCudaFilter
    from nnstreamer_tpu_torch.filters.api import FilterProps

    norm = _OpChain("arithmetic", NORM, backend="cuda").fn_for(
        TensorSpec.from_shape((1, VIT_SIZE, VIT_SIZE, 3), DType.UINT8))
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda", model=model,
                             device=torch.device(LC_DEVICE)))
    try:
        return [torch.cat([sp.invoke([norm(x)])[0] for x in pool])
                for pool in pools]
    finally:
        sp.close()


def classify(outs, refs):
    """The version (a key of ``refs``) whose alone logits each frame's
    logits match within SERVE_TOL; raises for a frame that matches none
    or has the wrong shape.  Returns ({(stream, pts): version}, versions
    by stream in pts order, worst difference to the matched version)."""
    import torch

    names, by_frame, by_stream, worst = list(refs), {}, [], 0.0
    for s, bufs in enumerate(outs):
        y = torch.cat([b.tensors[0].torch() for b in bufs])
        if tuple(y.shape) != (len(bufs), VIT["num_classes"]) or \
                not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"lifecycle: stream {s} logits "
                               f"{tuple(y.shape)}")
        idx = torch.tensor([b.pts % SERVE_POOL for b in bufs],
                           device=y.device)
        dist = torch.stack([(y - refs[v][s][idx]).abs().amax(-1)
                            for v in names])
        best, which = (t.tolist() for t in dist.min(0))
        for b, d, w in zip(bufs, best, which):
            if d > SERVE_TOL:
                raise RuntimeError(f"lifecycle: stream {s} frame {b.pts}: "
                                   f"logits {d} from its nearest version's "
                                   f"alone (limit {SERVE_TOL})")
            by_frame[s, b.pts] = names[w]
        worst = max(worst, max(best))
        by_stream.append([names[w] for w in which])
    return by_frame, by_stream, worst


def run_until(pipes, pools, stop, served, first_pts: int = 0):
    """Closed-loop clients (SERVE_DEPTH frames in flight each) that push
    until ``stop`` is set, then drain.  ``served[0]`` counts pulled
    frames.  Returns a join function giving (buffers by stream, pull
    times)."""
    import threading

    from nnstreamer_tpu_torch.core import Buffer, Tensor

    outs, stamps, errors = [[] for _ in pipes], [], []
    lock = threading.Lock()

    def client(s):
        src, sink, pool = pipes[s]["src"], pipes[s]["out"], pools[s]
        sent = 0
        try:
            while True:
                while not stop.is_set() and sent - len(outs[s]) < SERVE_DEPTH:
                    pts = first_pts + sent
                    src.push_buffer(Buffer(
                        tensors=[Tensor(pool[pts % len(pool)])], pts=pts))
                    sent += 1
                if len(outs[s]) == sent:
                    break
                b = sink.pull(timeout=120)
                if b is None:
                    raise RuntimeError(f"stream {s}: no result within 120 s")
                outs[s].append(b)
                with lock:
                    stamps.append(time.perf_counter())
                    served[0] += 1
        except Exception as e:  # noqa: BLE001 - re-raised by join
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=client, args=(s,), name=f"lc{s}")
               for s in range(len(pipes))]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"lifecycle clients failed: "
                               f"{errors or 'client hung'}")
        return outs, sorted(stamps)

    return join


def wait_for(cond, what: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"lifecycle: {what} within {timeout} s")
        time.sleep(0.002)


def lc_pipes(model: str, canary: str = ""):
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    pipes = [parse_launch(LC_PIPE.format(
        norm=NORM, model=model, buckets=",".join(map(str, SERVE_BUCKETS)),
        canary=f" canary={canary}" if canary else ""), device=LC_DEVICE)
        for _ in range(SERVE_STREAMS)]
    for p in pipes:
        p["src"].spec = TensorsSpec.parse(f"3:{VIT_SIZE}:{VIT_SIZE}:1",
                                          "uint8")
        p.start()
    if len({id(p["net"].pool) for p in pipes}) != 1:
        raise RuntimeError("lifecycle: the filters are not one pool")
    return pipes


def check_pipes(pipes) -> None:
    for p in pipes:
        if p.error is not None:
            raise RuntimeError(f"lifecycle: pipeline error {p.error}")


def lc_hot_swap(pools, refs, files, card: str, power: str):
    """Part 1: RELOAD_MODEL to v1 on 8 running streams."""
    import threading

    import torch

    from nnstreamer_tpu_torch.runtime.batching import pick_bucket
    from nnstreamer_tpu_torch.runtime.events import Event

    pipes = lc_pipes(f"file://{files[0]}@v0")
    try:
        entry = pipes[0]["net"].pool
        sp = entry.subplugin
        stream_of = {id(p["net"]): s for s, p in enumerate(pipes)}
        windows = []
        batcher = entry.batcher
        flush = batcher._flush_fn

        def timed(items):
            # every window waits for the card, so its time is the
            # window's own: host prep + device + demux
            t0 = time.perf_counter()
            flush(items)
            if LC_DEVICE == "cuda":
                torch.cuda.synchronize()
            windows.append((t0, time.perf_counter(),
                            [(stream_of[id(it[0])], it[1].pts)
                             for it in items]))

        batcher._flush_fn = timed
        stop, served = threading.Event(), [0]
        join = run_until(pipes, pools, stop, served)
        wait_for(lambda: served[0] >= LC_BEFORE or stop.is_set(),
                 f"{LC_BEFORE} frames before the reload")
        t_stage0 = time.perf_counter()
        pipes[0]["net"].handle_event(None, Event.reload_model(
            f"file://{files[1]}@v1"))
        t_stage1 = time.perf_counter()
        misses_at_flip = sp.batch_cache_misses
        at_swap = served[0]
        wait_for(lambda: served[0] >= at_swap + LC_AFTER or stop.is_set(),
                 f"{LC_AFTER} frames after the flip")
        stop.set()
        outs, stamps = join()
        check_pipes(pipes)
        lc = entry.lifecycle
        misses_after = sp.batch_cache_misses - misses_at_flip
    finally:
        for p in pipes:
            p.stop()
    if lc.swaps != 1 or lc.baseline.tag != "v1" or not any(
            ev["event"] == "swap" and ev["source"].endswith("@v1")
            for ev in lc.history):
        raise RuntimeError(f"lifecycle: swaps {lc.swaps}, history "
                           f"{lc.history}")
    by_frame, by_stream, worst = classify(outs, refs)
    for s, (bufs, vers) in enumerate(zip(outs, by_stream)):
        if [b.pts for b in bufs] != list(range(len(bufs))):
            raise RuntimeError(f"lifecycle: stream {s} pts lost or out of "
                               f"order")
        k = vers.index("v1") if "v1" in vers else len(vers)
        if k == 0 or k == len(vers) or vers != ["v0"] * k + ["v1"] * (
                len(vers) - k):
            raise RuntimeError(f"lifecycle: stream {s} did not switch from "
                               f"v0 to v1 once: {vers}")
    mixed = [w for w in windows
             if len({by_frame[it] for it in w[2]}) != 1]
    if mixed:
        raise RuntimeError(f"lifecycle: {len(mixed)} windows mix versions")
    if misses_after:
        raise RuntimeError(f"lifecycle: {misses_after} fold verdicts taken "
                           "after the flip (the shadow was not warm)")
    windows.sort()
    first = next(i for i, w in enumerate(windows)
                 if by_frame[w[2][0]] == "v1")
    fb = pick_bucket(len(windows[first][2]), SERVE_BUCKETS)

    def median_ms(ws):
        ts = [(t1 - t0) * 1e3 for t0, t1, it in ws
              if pick_bucket(len(it), SERVE_BUCKETS) == fb]
        return statistics.median(ts) if ts else float("nan")

    first_ms = (windows[first][1] - windows[first][0]) * 1e3
    steady_v0 = median_ms([w for w in windows[:first] if w[1] < t_stage0])
    steady_v1 = median_ms(windows[first + 1:])

    def rate(t0, t1):
        n = sum(1 for t in stamps if t0 <= t < t1)
        return n / (t1 - t0) if t1 > t0 else float("nan")

    res = {
        "frames": sum(len(b) for b in outs), "windows": len(windows),
        "stage_s": t_stage1 - t_stage0, "load_s": lc.baseline.load_s,
        "swap_stall_s": lc.last_swap_stall_s,
        "first_window_ms": first_ms, "first_window_bucket": fb,
        "steady_window_ms_v0": steady_v0, "steady_window_ms_v1": steady_v1,
        "frames_per_s_before": rate(stamps[0], t_stage0),
        "frames_per_s_during": rate(t_stage0, t_stage1),
        "frames_per_s_after": rate(t_stage1, stamps[-1]),
        "max_abs_diff": worst, "verdict_misses_after_flip": misses_after,
    }
    print(f"lifecycle hot swap: {res['frames']} frames of {SERVE_STREAMS} "
          f"streams in {len(windows)} windows, none lost, pts in order, "
          f"each stream v0 then v1 once, every window one version, logits "
          f"within {worst} of their version alone (limit {SERVE_TOL}); "
          f"staging {res['stage_s']:.6f} s (load+place+warm "
          f"{res['load_s']:.6f} s), flip stall {res['swap_stall_s'] * 1e3:.6f}"
          f" ms under the flush lock; first v1 window (bucket {fb}) "
          f"{first_ms:.3f} ms against steady {steady_v0:.3f} ms (v0) / "
          f"{steady_v1:.3f} ms (v1), {misses_after} verdicts taken after "
          f"the flip; frames/s before {res['frames_per_s_before']:.1f}, "
          f"during staging {res['frames_per_s_during']:.1f}, after "
          f"{res['frames_per_s_after']:.1f} (every window waits for the "
          f"card) [{card}, {power}]", flush=True)
    return res


def lc_canary(pools, refs, files, tree2, card: str, power: str):
    """Part 2: ``canary=next:1/4`` on 8 streams — routing, rollback,
    promote refused then done — and part 3: a weights-only swap."""
    from nnstreamer_tpu_torch.runtime.events import Event
    from nnstreamer_tpu_torch.runtime.lifecycle import LifecycleError

    pipes = lc_pipes(f"file://{files[0]}@v0", canary="next:1/4")
    pts = [0]
    canary_streams = [s for s in range(SERVE_STREAMS) if s % 4 == 3]

    def round_versions():
        outs, _, _ = closed_loop(pipes, pools, pts[0], LC_ROUND, SERVE_DEPTH)
        pts[0] += LC_ROUND
        check_pipes(pipes)
        _, by_stream, worst = classify(outs, refs)
        return [set(v) for v in by_stream], worst

    try:
        entry = pipes[0]["net"].pool
        lc = entry.lifecycle
        sp = entry.subplugin
        rows, worst = {}, 0.0
        for attempt in ("rollback", "promote"):
            pipes[0]["net"].handle_event(None, Event.reload_model(
                f"file://{files[1]}@v1"))
            check_pipes(pipes)
            if not lc.canary_active or \
                    lc.summary()["canary_streams"] != len(canary_streams):
                raise RuntimeError(f"lifecycle: canary not started: "
                                   f"{lc.summary()}")
            try:
                lc.promote()
                raise RuntimeError("lifecycle: promote before any canary "
                                   "frame was not refused")
            except LifecycleError:
                pass
            vers, w = round_versions()
            worst = max(worst, w)
            want = [{"v1"} if s in canary_streams else {"v0"}
                    for s in range(SERVE_STREAMS)]
            if vers != want:
                raise RuntimeError(f"lifecycle: canary routing {vers}")
            rows[attempt] = {r["version"]: r["buckets"]
                             for r in lc.snapshot_rows()}
            if attempt == "rollback":
                lc.rollback()
                after = "v0"
            else:
                lc.promote()
                after = "v1"
            vers, w = round_versions()
            worst = max(worst, w)
            if vers != [{after}] * SERVE_STREAMS:
                raise RuntimeError(f"lifecycle: after {attempt} {vers}")
        # part 3: a weights-only swap from a params dict (seed 2)
        misses = sp.batch_cache_misses
        lc.stage(tree2)
        lc.swap()
        vers, w = round_versions()
        worst = max(worst, w)
        if vers != [{"w2"}] * SERVE_STREAMS:
            raise RuntimeError(f"lifecycle: weights-only swap {vers}")
        w_misses = sp.batch_cache_misses - misses
        if w_misses:
            raise RuntimeError(f"lifecycle: the weights-only swap took "
                               f"{w_misses} fold verdicts anew")
        summary = lc.summary()
    finally:
        for p in pipes:
            p.stop()
    reached = sorted({int(b) for by_ver in rows.values()
                      for bk in by_ver.values() for b in bk})
    print(f"lifecycle canary next:1/4: streams {canary_streams} on v1, the "
          f"others on v0, in both canaries; promote refused before "
          f"{lc.min_canary_frames} canary frames, then done; rollback "
          f"back to v0 only at once; dispatches by bucket per version "
          f"{rows}; weights-only swap: every frame on the new weights, "
          f"{w_misses} verdicts taken anew; logits within {worst} of their "
          f"version alone; {summary} [{card}, {power}]", flush=True)
    return {"buckets_by_version": rows, "buckets_reached": reached,
            "max_abs_diff": worst, "swaps": summary["swaps"],
            "promotes": summary["promotes"],
            "rollbacks": summary["rollbacks"]}


def lc_cache(root: str, card: str, power: str):
    """Part 4: the persistent kernel cache across processes."""
    import glob
    import shutil

    from nnstreamer_tpu_torch.ops.build import SOURCES

    d = os.path.join(root, "kernel-cache")
    os.makedirs(d)
    code = CACHE_PROBE.format(here=HERE)

    def probe(label):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=900, env=dict(os.environ, NNS_TPU_COMPILE_CACHE_DIR=d))
        if out.returncode != 0:
            raise RuntimeError(f"cache probe ({label}) failed:\n{out.stderr}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        if not r["ok"]:
            raise RuntimeError(f"cache probe ({label}): a kernel disagrees "
                               "with its plain version")
        print(f"kernel cache {label}: {r} [{card}, {power}]", flush=True)
        return r

    try:
        cold = probe("cold")
        warm = probe("warm")
        lib = glob.glob(os.path.join(d, "libscale_bias_cast-*.so"))[0]
        with open(lib, "rb") as f:
            head = f.read(os.path.getsize(lib) // 2)
        with open(lib, "wb") as f:
            f.write(head)
        torn = probe("truncated scale_bias_cast")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n = len(SOURCES)
    if cold["stats"] != {"hits": 0, "misses": n, "stores": n, "errors": 0} \
            or warm["stats"] != {"hits": n, "misses": 0, "stores": 0,
                                 "errors": 0} or warm["nvcc_runs"] \
            or torn["stats"] != {"hits": 1, "misses": 1, "stores": 1,
                                 "errors": 1}:
        raise RuntimeError(f"kernel cache: {cold} / {warm} / {torn}")
    return {"cold_load_s": cold["load_s"], "warm_load_s": warm["load_s"],
            "truncated_load_s": torn["load_s"],
            "cold_nvcc_runs": cold["nvcc_runs"],
            "warm_nvcc_runs": warm["nvcc_runs"]}


def phase_lifecycle(card: str, power: str):
    """Model lifecycle on the shared pool at the ViT's width: a hot swap
    under 8 running streams, a canary on 1 stream in 4 with its rollback
    and promotion, a weights-only swap, the persistent kernel cache
    across processes, and ``flash_attention`` at every bucket the
    canary's groups reached.  Returns the numbers and the path's kernel
    launches."""
    import functools
    import tempfile

    import torch

    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.filters.torch_cuda import ModelDef
    from nnstreamer_tpu_torch.models import vit_tree, vit_tree_apply
    from nnstreamer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    build_root = os.path.join(HERE, "build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        files = [write_vit_file(os.path.join(root, f"vit_v{v}.safetensors"),
                                v) for v in (0, 1)]
        g = torch.Generator().manual_seed(SEED + 6)
        pools = [[torch.randint(0, 256, (1, VIT_SIZE, VIT_SIZE, 3),
                                generator=g, dtype=torch.uint8).to(LC_DEVICE)
                  for _ in range(SERVE_POOL)] for _ in range(SERVE_STREAMS)]
        widths = {k: v for k, v in VIT.items() if k != "heads"}
        tree2 = vit_tree(2, image_size=VIT_SIZE, **widths)
        w2 = ModelDef(functools.partial(vit_tree_apply, heads=VIT["heads"]),
                      tree2, TensorsSpec.from_shapes(
                          [(1, VIT_SIZE, VIT_SIZE, 3)], np.float32), "w2")
        refs = {"v0": alone_logits(files[0], pools),
                "v1": alone_logits(files[1], pools),
                "w2": alone_logits(w2, pools)}
        apart = float(torch.stack([(refs["v0"][s] - refs["v1"][s]).abs()
                                   .amax(-1) for s in range(SERVE_STREAMS)])
                      .min())
        if apart <= 2 * SERVE_TOL:
            raise RuntimeError(f"lifecycle: v0 and v1 logits of one frame "
                               f"lie only {apart} apart")
        print(f"lifecycle: two ViT files ({VIT}, image {VIT_SIZE}) written "
              f"and {SERVE_STREAMS}x{SERVE_POOL} frames run alone on v0, v1 "
              f"and the seed-2 weights in {time.perf_counter() - t0:.2f} s; "
              f"one frame's v0 and v1 logits lie at least {apart} apart",
              flush=True)
        kernels.flash_attention.launches = 0
        kernels.scale_bias_cast.launches = 0
        swap = lc_hot_swap(pools, refs, files, card, power)
        canary = lc_canary(pools, refs, files, tree2, card, power)
        launches = {"flash_attention": kernels.flash_attention.launches,
                    "scale_bias_cast": kernels.scale_bias_cast.launches}
        frames = swap["frames"] + SERVE_STREAMS * LC_ROUND * 5
        if launches["scale_bias_cast"] < frames or \
                launches["flash_attention"] < VIT["depth"] * swap["windows"]:
            raise RuntimeError(f"lifecycle: launches {launches} for {frames} "
                               f"frames and {swap['windows']} windows")
        cache = lc_cache(root, card, power)
    by_bucket, fa_worst = flash_at_buckets(canary["buckets_reached"], g,
                                           card, power)
    print(f"lifecycle phase: {time.perf_counter() - t0:.2f} s; kernel "
          f"launches {launches}", flush=True)
    return {"hot_swap": swap, "canary": canary, "cache": cache,
            "launches": launches, "flash_attention_by_bucket": by_bucket,
            "flash_attention_worst": fa_worst}



def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels-per-forward":
        return count_forward_kernels(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--serving-legs":
        return serving_legs(sys.argv[2])
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    smi = card_and_power()
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
    for name in libs:
        report = ptxas_report(build.build_logs.get(name, ""))
        if not report:
            print(f"build {name}: reused from disk, no ptxas report")
        for kernel, lines in report.items():
            print(f"build {name}: {kernel}: {'; '.join(lines)}")
            bad = [ln for ln in lines if "warning" in ln
                   or ("spill" in ln and " 0 bytes spill stores, 0 bytes "
                       "spill loads" not in ln)]
            if "bf16_kernel" in kernel and bad:
                raise RuntimeError(f"{kernel}: ptxas reports {bad}")

    worst, (ms, plain_ms, bound_ms) = phase_kernels(card, power)
    fa_worst, fa = phase_flash_attention(card, power)
    main_path = phase_main_path(card, power)
    phase_profile(composite("ssd_mobilenet_v2", "cuda", 3),
                  main_path.pop("frames"), card, power)
    phase_reference(main_path.pop("model"), main_path.pop("anchors"))
    vit_path = phase_vit(card, power)
    serving = phase_serving(card, power)
    lifecycle = phase_lifecycle(card, power)

    print(json.dumps({"main_path": main_path, "vit_path": vit_path,
                      "serving": serving, "lifecycle": lifecycle,
                      "card": card, "power_limit": power}))
    served = serving["launches"]
    sbc_by_path = {"detection": main_path["launches"],
                   "vit": vit_path["scale_bias_cast_launches"],
                   "serving_shared": served["shared"]["scale_bias_cast"],
                   "serving_unshared": served["unshared"]["scale_bias_cast"],
                   "lifecycle": lifecycle["launches"]["scale_bias_cast"]}
    fa_by_path = {"vit": vit_path["flash_launches"],
                  "serving_shared": served["shared"]["flash_attention"],
                  "serving_unshared": served["unshared"]["flash_attention"],
                  "lifecycle": lifecycle["launches"]["flash_attention"]}
    print(json.dumps({"kernels": [{
        "name": "scale_bias_cast",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/ops/csrc/scale_bias_cast.cu",
        "replaces": "nnstreamer_tpu/ops/kernels.py:92",
        "launches": sum(sbc_by_path.values()),
        "launches_by_path": sbc_by_path,
        "max_abs_err": worst,
        "max_abs_diff": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "card": card,
        "power_limit": power,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "nnstreamer_tpu/ops/kernels.py:180",
        "launches": sum(fa_by_path.values()),
        "launches_by_path": fa_by_path,
        "max_abs_err": max(fa_worst, serving["flash_attention_worst"],
                           lifecycle["flash_attention_worst"]),
        "max_abs_diff": max(fa_worst, serving["flash_attention_worst"],
                            lifecycle["flash_attention_worst"]),
        "ms": fa["ms"],
        "ms_vit_qkv_views": fa["views_ms"],
        "ms_by_bucket": {str(b): r["ms"] for b, r in
                         serving["flash_attention_by_bucket"].items()},
        "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "card": card,
        "power_limit": power,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
