#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-per-forward DIR   # one count, see below
    python3 chip_smoke.py --serving-legs DIR          # phase 8's legs only
    python3 chip_smoke.py --decoders                  # build + phase 12 only
    python3 chip_smoke.py --elements                  # build + phase 13 only
    python3 chip_smoke.py --obs                       # build + phase 14 only

It drives the port's paths — the composite detection pipeline, the ViT
classification pipeline, shared-model serving at the ViT's width, the
model lifecycle of that pool (hot swap, canary, the kernel cache),
MobileNet classification, YOLO detection, the decoders with the
detect → tensor_region → tensor_crop cascade, and the stream elements
(aggregated camera frames into a TorchScript classifier, a gated camera,
two cameras in one window), and the observability layer on the serving
and detection paths — through ``parse_launch`` at full width.
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
   256, bf16-resident weights (``weights_to_bf16``, as the JAX benchmark)
   — with the transform on the CUDA kernel (``backend=cuda``); the
   kernel's launch count must show the run went through it.  The same
   frames through ``backend=torch`` must give byte-equal canvases
   (cuDNN set deterministic for the comparison), and one window with the
   f32 weights cast per call must too;
5. profile: one short run of the main path under torch.profiler — the
   kernels by device time, the device's busy share, and the cast
   (``aten::_to_copy``) and padding (``aten::constant_pad_nd``) copies;
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
   fresh ``NNS_TPU_TORCH_COMPILE_CACHE_DIR`` — cold (misses and stores), warm
   (hits, no nvcc), after a truncated entry (an error, one rebuild) —
   each launching both kernels against their plain versions.  (e)
   ``flash_attention`` at every bucket the canary's groups reached;
10. classification: the JAX package's bench_classify — ``device_src``
   (uint8 512×224×224×3) → transform ``add:-127.5,div:127.5``
   ``backend=cuda`` → MobileNetV1 (1001 classes, bf16-resident weights,
   argmax to int32 in the model) → ``appsink``, 8 windows: one fused
   segment, ``scale_bias_cast`` every window, labels (512,) int32 in
   [0, 1001), frames/s, p50 window, a profile; then batch 2, f32, TF32
   off: logits card vs CPU within 1e-3, labels equal wherever the top-2
   margin exceeds it.  The MobileNetV2 classifier the same way (3
   windows);
11. YOLO: the JAX package's bench_yolo — ``device_src`` (uint8
   64×640×640×3) → transform ``div:255.0`` ``backend=cuda`` → YOLO (width
   64, depth 2, 80 classes, max_out=10, decode + NMS in the model,
   bf16-resident weights) → ``bounding_boxes option7=device`` →
   ``appsink``, 8 windows: canvases (64,640,640,4) uint8, the detection
   contract (scores descending, ymax >= ymin, num <= max_out),
   ``scale_bias_cast`` every window, frames/s, p50 window, a profile;
   ``backend=torch`` byte-equal; batch 2, f32, TF32 off, card vs CPU:
   boxes within 1e-4, scores within 1e-5, classes and num equal.  Then
   the raw variant at batch 1 through the ``yolov8`` scheme: the device
   pre-reduce gives the host decode's detections of the same tensor on
   the CPU (at a threshold at most 512 anchors pass), and window 0 equals
   a direct forward's;
12. decoders and cascade: (a) SSD-MobileNetV2 as phase 4 builds it, at
   batch 1, 256 frames (uint8 1×300×300×3) staged on the card: ``device_src
   ! tee``, one branch ``queue ! tensor_transform backend=cuda ! SSD !
   tensor_decoder mode=tensor_region option1=4 option2=<labels>
   option3=300:300 ! crop.sink_info``, the other ``queue ! crop.sink_raw``,
   ``tensor_crop ! appsink``: every output a flexible buffer of 1–4 uint8
   crops on the card, each byte-equal to its frame's slice at the regions
   the port's CPU decode of the same detections gives, every eighth frame's
   regions equal to a numpy decode written out with the JAX package's
   semantics, ``scale_bias_cast`` once a frame plus negotiation and its
   output equal to its plain version's on a frame; frames/s, then the
   source→sink latency of 64 frames with the source paced at 30 frames/s
   as a camera sends them (beside that of the unthrottled run, which is
   mostly queueing).  (b) Phase 4's composite at batch 256 with
   ``option7=host option2=<91 labels>``, 3 windows: each canvas byte-equal
   to the CPU render of the same detections and differing from the
   box-only render in label pixels only; frames/s.  ``option7=device``
   with option2 warns once and gives the box-only device canvas.  (c)
   ``image_segment`` at DeepLab v3 257's output (1,257,257,21) and
   ``pose_estimation`` at PoseNet MobileNetV1 257's (1,9,9,17) +
   (1,9,9,34) ``heatmap-offset``, staged on the card through ``appsrc``:
   one card→host copy of the (257,257) map or the (17,5) rows a frame,
   results equal to the CPU's.  (d) The cascade filter's 4 outputs from
   the card through ``tensor_decoder mode=protobuf ! tensor_converter !
   tensor_decoder mode=octet_stream``: the bytes come back.  It prints
   which glyph source (PIL or blocks) drew the labels;
13. stream elements, cuDNN deterministic: (a) MobileNetV1 as phase 10
   builds it (224x224, 1001 classes, bf16-resident weights) traced to a
   TorchScript file in a temporary directory: ``device_src`` (2048 uint8
   1×224×224×3 camera frames staged on the card) ``! tensor_aggregator
   frames-in=1 frames-out=512 frames-flush=512 frames-dim=3 !
   tensor_transform backend=cuda ! tensor_filter framework=pytorch !
   tensor_sink``: each window the ``torch.cat`` of its 512 frames, no
   device→host copy before the sink (torch.profiler's copy rows, in one
   forward and in windows 3..7 of an 8-window run, whose busy share it
   prints: the union of the kernels' intervals over the device's span),
   ``scale_bias_cast`` once a window and equal to its plain version on
   one, the logits within 2 bf16 ulps at the logits' largest magnitude
   of the same windows through ``framework=torch-cuda``
   ``register_mobilenet`` (argmax equal where the top-2 margin exceeds
   twice that), while the same module computing at f32 on one window
   must fall outside it; frames/s, the aggregator's host time a window, the out-spec
   inference forward, the kernels of one forward, a profile.  (b) The
   SSD of phase 4 at batch 1: 512 frames stamped at 30 frames/s through
   ``tensor_rate framerate=15/1`` (exactly the frames on that clock reach
   the filter), ``tensor_if A_VALUE 0:0 ge k`` on the top detection's
   ymin (random weights saturate every score, so the detection count is
   the same on every frame; k is the median ymin of those frames run
   alone: the routed set equals theirs, one scalar copy a verdict), the
   kept frames' device overlays through ``tee`` to a dense sink and
   through ``tensor_converter ! tensor_sparse_enc ! tensor_sparse_dec``
   (the overlay is video media; the converter keeps it on the card):
   byte-equal; then two cameras of 512 frames
   through ``tensor_merge option=3 sync-mode=slowest ! tensor_aggregator
   frames-in=2 frames-out=256`` into the SSD at batch 256 and
   ``tensor_demux tensorpick=0:1:2:3,2``: each window the two cameras
   interleaved per instant, overlays byte-equal to phase 4's composite
   on the same windows, the scores on ``tensor_sink`` equal to output 2;
   frames/s per camera;
14. observability, on two full-width paths that run both kernels.
   (a) Phase 8's shared topology (8 closed-loop streams, the ViT per
   frame, ``share-model=true batch=64 batch-timeout-ms=2
   batch-buckets=8,16,32,64``), streams 0–3 ``tenant=a`` and 4–7
   ``tenant=b``, ``slo-ms`` far above a window cycle (admission reads its
   p99 from the registry and sheds nothing), a ``LatencyTracer`` at 1 in
   8, ``serve_metrics`` on an ephemeral port scraped over HTTP
   (``/metrics``, ``/snapshot``, ``/healthz``) during the timed run and
   after it, and ``NNS_TPU_TORCH_CHAOS=seed=7;slow-invoke:ms=2,p=0.05,
   match=pool``: every stream's pts in order, none lost; labels equal to
   each frame alone's argmax where its top-2 margin exceeds 5e-2; every
   traced frame's residencies sum to its end-to-end latency, which is at
   least its window's device time (CUDA events around the window); the
   Chrome trace loads and nests; over a profiled span the transfer
   ledger's copies equal torch.profiler's copy rows; the bucket-64
   program's counted FLOPs within 1% of the ViT's by hand, every
   ``nns_mfu`` in (0, 1.05]; the tenant split exact and a's and b's
   frames 50% ± one window; ``nns_chaos_injected_total`` equal to the
   plan's count and the pool's injected sleep to count × 2 ms; the device
   memory table equal to ``torch.cuda.memory_stats``/``mem_get_info``;
   ``nns_model_weight_bytes`` equal to the ViT's parameter bytes.  (b)
   Phase 4's pipeline, 8 windows, in the order passive obs (in this
   process), ``NNS_TPU_TORCH_OBS_DISABLE=1`` (a child process), passive,
   disabled: the passive cost at most 3% of the p50 window; the ledger
   against the profiler's copy rows over a run, and the crossings between
   source and sink once staged; the counted FLOPs beside a hand count of
   the convolutions, ``nns_mfu`` in (0, 1.05]; with
   ``NNS_TPU_TORCH_FLIGHTREC_DIR`` set, ``chaos=seed=3;fail-invoke:
   every=2,count=1`` on the filter puts a ``ChaosInvokeError`` on the bus
   and the flight recorder writes a trace and a snapshot that load, the
   snapshot counting one injected failure;
15. prints a ``{"kernels": [...]}`` line, then, last, the ``ok`` line.

Without a usable card it exits non-zero and prints no result.

``--kernels-per-forward DIR`` runs nothing but one full-width ViT forward
with the port found in the checkout DIR and prints how many CUDA kernels
it queued: the same count phase 7 prints, for another tree on the same
card.  ``--serving-legs DIR`` runs nothing but phase 8's shared and
unshared legs with the port in DIR: run it for two trees in one call, in
the order parent, change, change, parent, to compare them.
``--decoders`` builds the kernels and runs phase 12 alone (no ``ok``
line); ``--elements`` and ``--obs`` do the same for phases 13 and 14.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

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


#: the ViT path: the JAX package's benchmark configuration (bench.py)
VIT_BATCH = 64
VIT_SIZE = 256
VIT = dict(patch=16, dim=512, depth=6, heads=4, mlp_dim=2048,
           num_classes=1000)
LABELS = os.path.join(HERE, "tests", "golden", "labels.txt")
#: the spin ahead of each timed group: about 10 ms at the H100's clocks
SPIN_CYCLES = 20_000_000
#: bf16 ulps (where |plain| >= 1/64) the attention kernel may be off:
#: p is rounded to bf16 (2^-9 relative) before p·v, and o once more
FA_BF16_ULPS = 16

#: the classification path: the JAX package's bench_classify (bench.py:
#: 66,71,533-586): MobileNetV1, 1001 classes, argmax in the model,
#: bf16-resident weights
CLS_BATCH = 512
CLS_SIZE = 224
CLS_CLASSES = 1001
#: the YOLO path: the JAX package's bench_yolo (bench.py:84-90,862-907)
YOLO_BATCH = 64
YOLO_SIZE = 640
YOLO_CLASSES = 80
YOLO_WIDTH = 64
YOLO_DEPTH = 2
YOLO_NORM = "typecast:float32,div:255.0"
CLS_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "appsink name=out max-buffers={sink}")
YOLO_RAW_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "tensor_decoder name=dec mode=bounding_boxes option1=yolov8 "
    "option4={s}:{s} option5={s}:{s} ! appsink name=out max-buffers={sink}")

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

CASCADE_FRAMES = 256     # camera frames, one at a time (tensor_region
CASCADE_REGIONS = 4      # reads one frame)
CAMERA_FPS = 30          # the paced run's source rate, for the latency
PACED_FRAMES = 64
BATCH_LABELS = 91        # lines of the labels file phase 12 writes
LABELED_WINDOWS = 3
PREREDUCE_FRAMES = 4
WIRE_FRAMES = 8
CASCADE_PIPE = (
    "tensor_crop name=crop ! appsink name=out max-buffers={sink} "
    "device_src name=src num-buffers={n} ! tee name=t "
    "t. ! queue ! tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! tensor_filter name=net framework=torch-cuda "
    "model={model} ! tensor_decoder name=region mode=tensor_region "
    "option1={regions} option2={labels} option3={s}:{s} ! crop.sink_info "
    "t. ! queue ! crop.sink_raw")
LABELED_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess {labels}option4={s}:{s} "
    "option5={s}:{s} option7={render} ! appsink name=out max-buffers={sink}")

COMPOSITE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend={backend} ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} "
    "option7=device ! appsink name=out max-buffers={sink}")


def card_spec(name: str):
    """The card's row of the port's peak table (``obs/hwspec.py``: NVIDIA
    data-sheet dense bf16 rate and HBM bandwidth), the denominator of
    every bound here and of ``nns_mfu``."""
    from nnstreamer_tpu_torch.obs.hwspec import spec_for_device_name

    spec = spec_for_device_name(name)
    if spec is None:
        raise RuntimeError(f"no data-sheet peaks known for {name!r}")
    return spec


def hbm_bandwidth(name: str) -> float:
    return card_spec(name).hbm_bw


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


def composite(model: str, backend: str, n: int, norm: str = NORM,
              size: int = SIZE) -> str:
    return COMPOSITE.format(n=n, norm=norm, backend=backend, model=model,
                            s=size, sink=n + 4)


def vit_pipe(model: str, n: int, decoder: bool = False) -> str:
    return VIT_PIPE.format(n=n, norm=NORM, model=model, sink=n + 4,
                           dec=LABEL_DEC if decoder else "")


def run_pipeline(desc: str, frames, n: int, device="cuda", setup=None):
    """One run of a pipeline description; returns (pipeline, buffers,
    host seconds from start to EOS).  ``setup(p)`` runs on the parsed
    pipeline before it starts."""
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch(desc, device=device)
    p["src"].frames = frames
    p["src"].pool_size = len(frames)
    if setup is not None:
        setup(p)
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


def window_times(bufs, batch: int):
    """frames/s over windows 2..n and the p50 window (ms), from the
    sink's CUDA completion events."""
    evs = [b.meta["device_done"] for b in bufs]
    gaps = [evs[i - 1].elapsed_time(evs[i]) for i in range(1, len(evs))]
    fps = (len(evs) - 1) * batch / (evs[0].elapsed_time(evs[-1]) / 1e3)
    return fps, statistics.median(gaps)


def check_fused(p, decoder, what: str) -> None:
    segs = [(s.transforms, s.filter, s.decoder) for s in p.fused_segments]
    if segs != [(("norm",), "net", decoder)]:
        raise RuntimeError(f"{what}: expected one fused segment "
                           f"norm→net{'→' + decoder if decoder else ''}, got "
                           f"{p.fused_segments}")


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
        # the classification and YOLO paths (div:255 folds to scale
        # 1/255, bias 0; the affine does not change what is compared)
        ("u8 classify", (CLS_BATCH, CLS_SIZE, CLS_SIZE, 3), torch.uint8,
         torch.float32),
        ("u8 yolo", (YOLO_BATCH, YOLO_SIZE, YOLO_SIZE, 3), torch.uint8,
         torch.float32),
        ("u8 yolo raw", (1, YOLO_SIZE, YOLO_SIZE, 3), torch.uint8,
         torch.float32),
        # the cascade: one camera frame at a time
        ("u8 cascade", (1, SIZE, SIZE, 3), torch.uint8, torch.float32),
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
    ops_ms = flops / card_spec(card).peak_flops * 1e3
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
    pools, _ = serve_pools()
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
        weights_to_bf16,
    )
    from nnstreamer_tpu_torch.ops import kernels

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print("main path: torch.backends.cudnn.deterministic=True, "
          "benchmark=False (a cuDNN algorithm that sums with atomics could "
          "flip a bf16 tie in NMS between the two runs compared)",
          flush=True)
    t0 = time.perf_counter()
    tree = ssd_mobilenet_v2_init(SEED, NUM_CLASSES)
    model = ssd_from_jax(tree)           # f32 weights, cast per call
    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    # the JAX benchmark's bf16-resident weights (bench.py:110-115)
    register_detector("ssd_mobilenet_v2",
                      ssd_from_jax(weights_to_bf16(tree)), anchors, BATCH,
                      torch.bfloat16)
    register_detector("ssd_mobilenet_v2_f32w", model, anchors, BATCH,
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
    check_fused(p, "overlay", "main path")
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
    fps, p50 = window_times(bufs, BATCH)
    print(f"main path (backend=cuda): {fps:.1f} frames/s over windows "
          f"2..{NUM_BUFFERS}, p50 window {p50:.3f} ms, host start→EOS "
          f"{secs:.2f} s, peak device memory {peak / 2**30:.2f} GiB "
          f"[{card}, {power}]", flush=True)
    # bf16-resident weights hold the same bf16 numbers as f32 weights
    # cast per call: one window must come out byte for byte the same
    _, bufs_f32w, _ = run_pipeline(
        composite("ssd_mobilenet_v2_f32w", "cuda", 1), frames, 1)
    a, b = bufs[0], bufs_f32w[0]
    if not torch.equal(a.tensors[0].torch(), b.tensors[0].torch()) or any(
            not torch.equal(a.meta["detections_device"][k],
                            b.meta["detections_device"][k])
            for k in ("boxes", "scores", "classes", "num")):
        raise RuntimeError("window 0: bf16-resident weights and f32 weights "
                           "cast per call differ")
    print("main path: window 0 with bf16-resident weights byte-equal to f32 "
          "weights cast per call (canvas and detections)", flush=True)
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
    fps_plain, _ = window_times(bufs_plain, BATCH)
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
                             ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
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
    # the copies by the op that makes them: dtype casts (weights cast per
    # call, the batch-norm vectors, the input) and the SAME padding
    copies = ("aten::_to_copy", "aten::constant_pad_nd")
    for e in prof.key_averages():
        if e.key in copies:
            print(f"{label}: {e.key}: {e.count} calls, "
                  f"{e.device_time_total / 1e3:.3f} ms device "
                  f"({e.device_time_total / 1e3 / busy_ms:.1%})", flush=True)
    by_shape = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                       if e.key in copies),
                      key=lambda e: e.device_time_total, reverse=True)
    for e in by_shape[:4]:
        print(f"{label}:   {e.key} {e.input_shapes}: {e.count} calls, "
              f"{e.device_time_total / 1e3:.3f} ms device", flush=True)
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
    check_fused(p, None, "vit")
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
    fps, p50 = window_times(bufs, VIT_BATCH)
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


def serve_pools():
    """Each stream's SERVE_POOL distinct uint8 frames, staged on the card,
    and the generator that drew them (seeded: phases 8 and 14 draw the
    same frames)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 4)
    pools = [[torch.randint(0, 256, (1, VIT_SIZE, VIT_SIZE, 3), generator=g,
                            dtype=torch.uint8).cuda()
              for _ in range(SERVE_POOL)] for _ in range(SERVE_STREAMS)]
    return pools, g


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
    pools, g = serve_pools()
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
        bound = max(nbytes / bw * 1e3,
                    flops / card_spec(card).peak_flops * 1e3)
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
            timeout=900,
            env=dict(os.environ, NNS_TPU_TORCH_COMPILE_CACHE_DIR=d))
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



def card_vs_cpu(desc: str, frames):
    """One window of ``desc`` on the card and on the CPU (the CPU runs the
    kernels' plain versions); returns both buffers."""
    _, gpu, _ = run_pipeline(desc, frames, 1)
    _, cpu, _ = run_pipeline(desc, frames, 1, device="cpu")
    return gpu[0], cpu[0]


def classify_small_check(family: str, tree, card: str, power: str):
    """Batch 2, f32 compute, f32 weights, TF32 off: the logits on the card
    against the CPU within 1e-3; the labels equal wherever the CPU's top-2
    margin exceeds that tolerance."""
    import torch

    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import (
        mobilenet_v1_apply,
        mobilenet_v1_from_jax,
        mobilenet_v2_apply,
        mobilenet_v2_from_jax,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from_jax, apply = (mobilenet_v1_from_jax, mobilenet_v1_apply) \
        if family == "v1" else (mobilenet_v2_from_jax, mobilenet_v2_apply)
    name = f"mobilenet_{family}_small_f32"
    register_model(name, lambda m, x: apply(m, x, torch.float32),
                   params=from_jax(tree), in_dtypes=np.float32,
                   in_shapes=[(2, CLS_SIZE, CLS_SIZE, 3)])
    small = [np.random.default_rng(SEED + 7).integers(
        0, 256, (2, CLS_SIZE, CLS_SIZE, 3), dtype=np.uint8)]
    g, c = card_vs_cpu(CLS_PIPE.format(n=1, norm=NORM, model=name, sink=5),
                       small)
    lg, lc = g.tensors[0].torch().cpu(), c.tensors[0].torch()
    err = float((lg - lc).abs().max())
    top2 = lc.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    sure = margin > 1e-3
    same = bool((lg.argmax(-1) == lc.argmax(-1))[sure].all())
    print(f"classify {family} batch 2, f32, TF32 off: logits max_abs_diff "
          f"card vs CPU = {err}; logits spread {float(lc.std())}; top-2 "
          f"margins {margin.tolist()}; labels {lg.argmax(-1).tolist()} vs "
          f"{lc.argmax(-1).tolist()} [{card}, {power}]", flush=True)
    if err > 1e-3 or not same:
        raise RuntimeError(f"classify {family}: card and CPU disagree")
    return err


def phase_classify(card: str, power: str):
    """The classification path at the JAX benchmark's width (see the
    module doc, phase 10)."""
    import torch

    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import (
        mobilenet_v1_apply,
        mobilenet_v1_from_jax,
        mobilenet_v1_init,
        mobilenet_v2_apply,
        mobilenet_v2_from_jax,
        mobilenet_v2_init,
        weights_to_bf16,
    )
    from nnstreamer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    res = {}
    rng = np.random.default_rng(SEED + 8)
    frames = [rng.integers(0, 256, (CLS_BATCH, CLS_SIZE, CLS_SIZE, 3),
                           dtype=np.uint8) for _ in range(POOL)]
    for family, init, from_jax, apply, windows in (
            ("v1", mobilenet_v1_init, mobilenet_v1_from_jax,
             mobilenet_v1_apply, NUM_BUFFERS),
            ("v2", mobilenet_v2_init, mobilenet_v2_from_jax,
             mobilenet_v2_apply, 3)):
        tree = init(SEED, CLS_CLASSES)
        model = from_jax(weights_to_bf16(tree))
        if model.stem.weight.dtype != torch.bfloat16:
            raise RuntimeError(f"classify {family}: weights not bf16")

        def classify(m, x, _apply=apply):
            return torch.argmax(_apply(m, x), dim=-1).to(torch.int32)

        name = f"mobilenet_{family}_cls"
        register_model(name, classify, params=model, in_dtypes=np.float32,
                       in_shapes=[(CLS_BATCH, CLS_SIZE, CLS_SIZE, 3)])
        desc = CLS_PIPE.format(n=windows, norm=NORM, model=name,
                               sink=windows + 4)
        torch.cuda.reset_peak_memory_stats()
        kernels.scale_bias_cast.launches = 0
        p, bufs, secs = run_pipeline(desc, frames, windows)
        launches = kernels.scale_bias_cast.launches
        peak = torch.cuda.max_memory_allocated()
        check_fused(p, None, f"classify {family}")
        if launches < windows:
            raise RuntimeError(f"classify {family}: scale_bias_cast launched "
                               f"{launches} times for {windows} windows")
        distinct = set()
        for b in bufs:
            y = b.tensors[0].torch()
            if tuple(y.shape) != (CLS_BATCH,) or y.dtype != torch.int32 or \
                    int(y.min()) < 0 or int(y.max()) >= CLS_CLASSES:
                raise RuntimeError(f"classify {family}: labels "
                                   f"{tuple(y.shape)} {y.dtype} not int32 "
                                   f"({CLS_BATCH},) in [0, {CLS_CLASSES})")
            distinct |= set(y.tolist())
        fps, p50 = window_times(bufs, CLS_BATCH)
        print(f"classify {family}: fused {p.fused_segments[0]}; "
              f"scale_bias_cast launches={launches} for {windows} windows; "
              f"{fps:.1f} frames/s over windows 2..{windows}, p50 window "
              f"{p50:.3f} ms, host start→EOS {secs:.2f} s, peak device "
              f"memory {peak / 2**30:.2f} GiB; {len(distinct)} distinct "
              f"labels [{card}, {power}]", flush=True)
        res[family] = {"fps": fps, "p50_window_ms": p50, "host_s": secs,
                       "launches": launches, "peak_gib": peak / 2**30,
                       "distinct_labels": len(distinct)}
        if family == "v1":
            prof = phase_profile(CLS_PIPE.format(n=3, norm=NORM, model=name,
                                                 sink=7),
                                 frames, card, power, label="classify profile")
            if prof is not None:
                res["v1"]["busy_ms"] = prof[1]
        res[family]["card_vs_cpu_f32"] = classify_small_check(
            family, tree, card, power)
    print(f"classify phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return res


def check_detections(det, batch: int, max_out: int, classes: int,
                     what: str) -> None:
    """The postprocess contract at full width: shapes, finite values,
    scores descending, ymax >= ymin, num <= max_out, classes in range."""
    import torch

    boxes, scores = det["boxes"], det["scores"]
    if tuple(boxes.shape) != (batch, max_out, 4) or \
            tuple(scores.shape) != (batch, max_out):
        raise RuntimeError(f"{what}: boxes {tuple(boxes.shape)} scores "
                           f"{tuple(scores.shape)}")
    if not bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()):
        raise RuntimeError(f"{what}: non-finite detections")
    if bool((scores[:, 1:] > scores[:, :-1]).any()):
        raise RuntimeError(f"{what}: scores not descending")
    if bool((boxes[..., 2] < boxes[..., 0]).any()):
        raise RuntimeError(f"{what}: ymax < ymin")
    if int(det["num"].max()) > max_out or int(det["classes"].min()) < 0 or \
            int(det["classes"].max()) >= classes:
        raise RuntimeError(f"{what}: num or classes out of range")


def _det_keys(dets):
    return sorted((d.class_id, d.score, d.x, d.y, d.w, d.h) for d in dets)


def phase_yolo(card: str, power: str):
    """YOLO end to end and raw at the JAX benchmark's width (see the
    module doc, phase 11)."""
    import torch

    from nnstreamer_tpu_torch.core import Buffer, DType
    from nnstreamer_tpu_torch.decoders.boundingbox import (
        _YOLO_TOPK,
        BoundingBoxes,
    )
    from nnstreamer_tpu_torch.elements.transform import (
        _fold_affine,
        parse_arith_ops,
    )
    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import (
        weights_to_bf16,
        yolo_detect_apply,
        yolo_from_jax,
        yolo_init,
        yolo_raw_apply,
    )
    from nnstreamer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    tree = yolo_init(SEED, num_classes=YOLO_CLASSES, width=YOLO_WIDTH,
                     depth=YOLO_DEPTH)
    model = yolo_from_jax(weights_to_bf16(tree))
    register_model("yolo_e2e",
                   lambda m, x: yolo_detect_apply(m, x, max_out=MAX_OUT),
                   params=model, in_dtypes=np.float32,
                   in_shapes=[(YOLO_BATCH, YOLO_SIZE, YOLO_SIZE, 3)])
    rng = np.random.default_rng(SEED + 9)
    frames = [rng.integers(0, 256, (YOLO_BATCH, YOLO_SIZE, YOLO_SIZE, 3),
                           dtype=np.uint8) for _ in range(POOL)]
    windows = NUM_BUFFERS
    desc = composite("yolo_e2e", "cuda", windows, YOLO_NORM, YOLO_SIZE)
    torch.cuda.reset_peak_memory_stats()
    kernels.scale_bias_cast.launches = 0
    p, bufs, secs = run_pipeline(desc, frames, windows)
    launches = kernels.scale_bias_cast.launches
    peak = torch.cuda.max_memory_allocated()
    check_fused(p, "overlay", "yolo")
    if launches < windows:
        raise RuntimeError(f"yolo: scale_bias_cast launched {launches} times "
                           f"for {windows} windows")
    for i, b in enumerate(bufs):
        canvas = b.tensors[0].torch()
        if tuple(canvas.shape) != (YOLO_BATCH, YOLO_SIZE, YOLO_SIZE, 4) or \
                canvas.dtype != torch.uint8:
            raise RuntimeError(f"yolo: canvas {tuple(canvas.shape)} "
                               f"{canvas.dtype}")
        check_detections(b.meta["detections_device"], YOLO_BATCH, MAX_OUT,
                         YOLO_CLASSES, f"yolo window {i}")
    fps, p50 = window_times(bufs, YOLO_BATCH)
    det = bufs[-1].meta["detections_device"]
    print(f"yolo: fused {p.fused_segments[0]}; scale_bias_cast launches="
          f"{launches} for {windows} windows; {fps:.1f} frames/s over "
          f"windows 2..{windows}, p50 window {p50:.3f} ms, host start→EOS "
          f"{secs:.2f} s, peak device memory {peak / 2**30:.2f} GiB; last "
          f"window frame 0: num={int(det['num'][0])} classes="
          f"{det['classes'][0].tolist()} [{card}, {power}]", flush=True)
    res = {"fps": fps, "p50_window_ms": p50, "host_s": secs,
           "launches": launches, "peak_gib": peak / 2**30}

    # the same frames through the plain prologue: byte-equal
    _, plain, _ = run_pipeline(
        composite("yolo_e2e", "torch", windows, YOLO_NORM, YOLO_SIZE),
        frames, windows)
    for i, (a, b) in enumerate(zip(bufs, plain)):
        if not torch.equal(a.tensors[0].torch(), b.tensors[0].torch()) or \
                any(not torch.equal(a.meta["detections_device"][k],
                                    b.meta["detections_device"][k])
                    for k in ("boxes", "scores", "classes", "num")):
            raise RuntimeError(f"yolo window {i}: backend=cuda and "
                               "backend=torch differ")
    print(f"yolo: canvases and detections byte-equal between backend=cuda "
          f"and backend=torch in all {windows} windows", flush=True)
    prof = phase_profile(
        composite("yolo_e2e", "cuda", 3, YOLO_NORM, YOLO_SIZE), frames, card,
        power, label="yolo profile")
    if prof is not None:
        res["busy_ms"] = prof[1]

    # batch 2, f32 compute, f32 weights, TF32 off: card against CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    register_model("yolo_small_f32",
                   lambda m, x: yolo_detect_apply(m, x, max_out=MAX_OUT,
                                                  dtype=torch.float32),
                   params=yolo_from_jax(tree), in_dtypes=np.float32,
                   in_shapes=[(2, YOLO_SIZE, YOLO_SIZE, 3)])
    small = [np.random.default_rng(SEED + 10).integers(
        0, 256, (2, YOLO_SIZE, YOLO_SIZE, 3), dtype=np.uint8)]
    g, c = card_vs_cpu(composite("yolo_small_f32", "cuda", 1, YOLO_NORM,
                                 YOLO_SIZE), small)
    dg, dc = g.meta["detections_device"], c.meta["detections_device"]
    errs = {k: float((dg[k].cpu() - dc[k]).abs().max())
            for k in ("boxes", "scores")}
    print(f"yolo batch 2, f32, TF32 off: card vs CPU max_abs_diff {errs}; "
          f"classes {dg['classes'].tolist()} vs {dc['classes'].tolist()}; "
          f"num {dg['num'].tolist()} vs {dc['num'].tolist()}", flush=True)
    if errs["boxes"] > 1e-4 or errs["scores"] > 1e-5 or \
            not torch.equal(dg["classes"].cpu(), dc["classes"]) or \
            not torch.equal(dg["num"].cpu(), dc["num"]):
        raise RuntimeError("yolo: card and CPU disagree at f32")
    res["card_vs_cpu_f32"] = errs

    # the raw variant at batch 1: the yolov8 scheme, pre-reduced on the card
    register_model("yolo_raw", lambda m, x: yolo_raw_apply(m, x),
                   params=model, in_dtypes=np.float32,
                   in_shapes=[(1, YOLO_SIZE, YOLO_SIZE, 3)])
    raw_frames = [f[:1] for f in frames]
    kernels.scale_bias_cast.launches = 0
    p, rbufs, rsecs = run_pipeline(YOLO_RAW_PIPE.format(
        n=windows, norm=YOLO_NORM, model="yolo_raw", s=YOLO_SIZE,
        sink=windows + 4), raw_frames, windows)
    raw_launches = kernels.scale_bias_cast.launches
    check_fused(p, None, "yolo raw")
    if raw_launches < windows:
        raise RuntimeError(f"yolo raw: scale_bias_cast launched "
                           f"{raw_launches} times for {windows} windows")
    for b in rbufs:
        if b.tensors[0].np().shape != (YOLO_SIZE, YOLO_SIZE, 4) or \
                not b.meta["detections"] or any(
                    not 0 <= d.class_id < YOLO_CLASSES
                    for d in b.meta["detections"]):
            raise RuntimeError("yolo raw: bad canvas or detections")
    # the pre-reduce against the host decode of the same tensor on the
    # CPU, with the threshold set so at most _YOLO_TOPK anchors pass
    a, b, _ = _fold_affine(parse_arith_ops(YOLO_NORM), DType.UINT8)
    x = kernels.scale_bias_cast(torch.from_numpy(raw_frames[0]).cuda(), a,
                                b / a)
    with torch.inference_mode():
        raw = yolo_raw_apply(model.cuda(), x)
    # random weights saturate many scores to equal values: take the
    # lowest distinct score that at most _YOLO_TOPK anchors reach
    vals, counts = torch.unique(raw[0, 4:].max(dim=0).values,
                                return_counts=True)
    cum = counts.flip(0).cumsum(0)
    fit = torch.nonzero(cum <= _YOLO_TOPK).flatten()
    if fit.numel() == 0:
        raise RuntimeError(f"yolo raw: {int(counts[-1])} anchors tie at the "
                           "top score, more than the pre-reduce keeps")
    thr = float(vals.flip(0)[int(fit.max())])
    kept = int(cum[int(fit.max())])
    dec = BoundingBoxes()
    for i, v in ((0, "yolov8"), (2, f"{thr!r}:0.5"),
                 (3, f"{YOLO_SIZE}:{YOLO_SIZE}"),
                 (4, f"{YOLO_SIZE}:{YOLO_SIZE}")):
        dec.set_option(i, v)
    on_card = dec.decode(Buffer.of(raw), None)
    on_host = dec.decode(Buffer.of(raw.cpu().numpy()), None)
    same = _det_keys(on_card.meta["detections"]) == \
        _det_keys(on_host.meta["detections"])
    pix = float((on_card.tensors[0].torch() == on_host.tensors[0].torch())
                .all(dim=-1).float().mean())
    # window 0 of the pipeline (threshold 0.25) against this forward
    dec0 = BoundingBoxes()
    for i, v in ((0, "yolov8"), (3, f"{YOLO_SIZE}:{YOLO_SIZE}"),
                 (4, f"{YOLO_SIZE}:{YOLO_SIZE}")):
        dec0.set_option(i, v)
    pipe_same = _det_keys(rbufs[0].meta["detections"]) == _det_keys(
        dec0.decode(Buffer.of(raw), None).meta["detections"])
    print(f"yolo raw: scale_bias_cast launches={raw_launches} for {windows} "
          f"windows; {len(rbufs[0].meta['detections'])} detections in window "
          f"0, equal to a direct forward's: {pipe_same}; pre-reduce on the "
          f"card vs host decode on the CPU at threshold {thr!r} ({kept} "
          f"anchors pass): {len(on_card.meta['detections'])} detections, "
          f"equal: {same}, canvas pixels agree {pix:.6f}; host start→EOS "
          f"{rsecs:.2f} s [{card}, {power}]", flush=True)
    if not same or not pipe_same or kept > _YOLO_TOPK:
        raise RuntimeError("yolo raw: the pre-reduce and the host decode "
                           "disagree")
    res["raw"] = {"launches": raw_launches, "host_s": rsecs,
                  "prereduce_threshold": thr, "anchors_passing": kept}
    print(f"yolo phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return res


# -- phase 12: decoders and the detect → region → crop cascade --------------

def decoders_dir() -> str:
    """Files phase 12 writes (the labels file), inside the checkout's
    ignored ``build/``."""
    d = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    return d


def write_labels(n: int) -> str:
    path = os.path.join(decoders_dir(), f"labels_{n}.txt")
    with open(path, "w") as f:
        f.write("".join(f"label {i}\n" for i in range(n)))
    return path


def stamp_times(p, fps: float = 0.0) -> None:
    """Host clock at the source's create and at the sink's render, on
    each buffer's meta (``t_src`` rides through every element that copies
    the meta; ``t_sink`` is set where the buffer arrives).  With ``fps``
    the source makes frame i no earlier than i/fps s after its first, as
    a camera does."""
    src, sink = p["src"], p["out"]
    create, render = src.create, sink.render
    clock = {"n": 0, "t0": None}

    def created():
        if fps:
            now = time.perf_counter()
            if clock["t0"] is None:
                clock["t0"] = now
            wait = clock["t0"] + clock["n"] / fps - now
            if wait > 0:
                time.sleep(wait)
            clock["n"] += 1
        b = create()
        if b is not None:
            b.meta["t_src"] = time.perf_counter()
        return b

    def rendered(b):
        b.meta["t_sink"] = time.perf_counter()
        render(b)

    src.create, sink.render = created, rendered


def record_decodes(dec, keep_device: int = 0):
    """Wrap a decoder's ``decode``: by input offset (or call order), the
    host copies of its input tensors (free: the element drained them), its
    output's first tensor, and for the first ``keep_device`` calls the
    input tensors as they live on the card."""
    rec, orig = {}, dec.decode

    def decode(buf, spec):
        out = orig(buf, spec)
        key = buf.offset if buf.offset is not None else len(rec)
        rec[key] = {"inputs": [t.np().copy() for t in buf.tensors],
                    "output": out.tensors[0].np().copy(),
                    "device": [t.torch() for t in buf.tensors]
                    if len(rec) < keep_device else None}
        return out

    dec.decode = decode
    return rec


def region_reference(boxes, classes, scores, num, n_regions: int,
                     fw: int, fh: int, conf: float = 0.25):
    """The JAX package's tensor_region semantics on numpy, written out:
    detections over ``conf`` among the first ``num``, sorted by score
    (stable), the top ``n_regions`` as pixel (x, y, w, h); the whole
    frame when none passes."""
    boxes = boxes.reshape(-1, 4)
    scores = scores.reshape(-1)
    n = min(int(num.reshape(-1)[0]), len(scores))
    dets = []
    for i in range(n):
        if scores[i] < conf:
            continue
        ymin, xmin, ymax, xmax = boxes[i]
        dets.append((float(xmin), float(ymin), float(xmax - xmin),
                     float(ymax - ymin), float(scores[i])))
    dets.sort(key=lambda d: -d[4])
    dets = dets[:n_regions]
    regions = np.zeros((max(len(dets), 1), 4), np.uint32)
    for i, (x, y, w, h, _) in enumerate(dets):
        regions[i] = (int(np.clip(x, 0, 1) * fw), int(np.clip(y, 0, 1) * fh),
                      max(int(w * fw), 1), max(int(h * fh), 1))
    if not dets:
        regions[0] = (0, 0, fw, fh)
    return regions


def crop_slices(frame, regions):
    """Each region's slice of a (1, H, W, C) frame, clamped as
    tensor_crop clamps it, as bytes."""
    hh, ww = frame.shape[1], frame.shape[2]
    out = []
    for x, y, w, h in regions.astype(np.int64):
        x = max(0, min(int(x), ww - 1))
        y = max(0, min(int(y), hh - 1))
        w = max(1, min(int(w), ww - x))
        h = max(1, min(int(h), hh - y))
        out.append(np.ascontiguousarray(frame[:, y:y + h, x:x + w]))
    return out


def latencies(bufs):
    """p50 and p99 source→sink latency (ms, host clock) of stamped
    buffers."""
    lat = sorted((b.meta["t_sink"] - b.meta["t_src"]) * 1e3 for b in bufs)
    return statistics.median(lat), lat[int(0.99 * (len(lat) - 1))]


def count_card_copies():
    """Count the device→host copies made through ``Tensor.cpu`` (every
    drain of the port goes through it); returns (shapes list, restore)."""
    import torch

    copies, cpu = [], torch.Tensor.cpu

    def counting(self, *a, **kw):
        if self.device.type == "cuda":
            copies.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    torch.Tensor.cpu = counting

    def restore():
        torch.Tensor.cpu = cpu

    return copies, restore


def cascade_phase(tree, card: str, power: str, labels: str):
    """(a) the cascade at full SSD width, batch 1; returns its numbers and
    the first frames' detection tensors as they live on the card."""
    import torch

    from nnstreamer_tpu_torch.core import Buffer, DType, TensorFormat
    from nnstreamer_tpu_torch.decoders.tensorregion import TensorRegion
    from nnstreamer_tpu_torch.elements.transform import (
        _fold_affine,
        parse_arith_ops,
    )
    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        weights_to_bf16,
    )
    from nnstreamer_tpu_torch.ops import kernels

    n = CASCADE_FRAMES
    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    register_detector("ssd_cascade", ssd_from_jax(weights_to_bf16(tree)),
                      anchors, 1, torch.bfloat16)
    rng = np.random.default_rng(SEED + 12)
    frames = [rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(n)]
    rec = {}

    def setup(p):
        stamp_times(p)
        rec.update(src=record_decodes(p["region"]._decoder(),
                                      keep_device=WIRE_FRAMES))

    desc = CASCADE_PIPE.format(sink=n + 4, n=n, norm=NORM,
                               model="ssd_cascade", regions=CASCADE_REGIONS,
                               labels=labels, s=SIZE)
    kernels.scale_bias_cast.launches = 0
    p, bufs, secs = run_pipeline(desc, frames, n, setup=setup)
    launches = kernels.scale_bias_cast.launches
    check_fused(p, None, "cascade")
    if not n <= launches <= n + 2:
        raise RuntimeError(f"cascade: scale_bias_cast launched {launches} "
                           f"times for {n} frames (one a frame expected, "
                           "plus negotiation)")
    # the kernel's prologue output at the cascade's shape, exactly
    a, b, _ = _fold_affine(parse_arith_ops(NORM), DType.UINT8)
    x = torch.from_numpy(frames[0]).cuda()
    if not torch.equal(kernels.scale_bias_cast(x, a, b / a, torch.float32),
                       kernels.scale_bias_cast_reference(x, a, b / a,
                                                         torch.float32)):
        raise RuntimeError("cascade: prologue kernel and plain version "
                           "differ")
    decoded = rec["src"]
    ref = TensorRegion()
    for i, v in enumerate((str(CASCADE_REGIONS), labels, f"{SIZE}:{SIZE}")):
        ref.set_option(i, v)
    n_crops, whole, checked = [], 0, 0
    for b in bufs:
        off = b.offset
        if b.format != TensorFormat.FLEXIBLE or \
                not 1 <= b.num_tensors <= CASCADE_REGIONS or off not in decoded:
            raise RuntimeError(f"cascade: bad output buffer {b}")
        for t in b.tensors:
            x = t.torch()
            if x.device.type != "cuda" or x.dtype != torch.uint8:
                raise RuntimeError(f"cascade: crop {tuple(x.shape)} "
                                   f"{x.dtype} on {x.device}")
        dets = decoded[off]["inputs"]
        regions = ref.decode(Buffer.of(*dets), None).tensors[0].np()
        if not np.array_equal(regions, decoded[off]["output"]):
            raise RuntimeError(f"cascade frame {off}: the card's regions "
                               "differ from the CPU decode's")
        want = crop_slices(frames[off], regions)
        got = [t.np() for t in b.tensors]
        if len(got) != len(want) or any(
                g.shape != w.shape or g.tobytes() != w.tobytes()
                for g, w in zip(got, want)):
            raise RuntimeError(f"cascade frame {off}: crops differ from the "
                               "frame's slices at the CPU decode's regions")
        if off % 8 == 0:
            jref = region_reference(*dets, CASCADE_REGIONS, SIZE, SIZE)
            if not np.array_equal(jref, regions):
                raise RuntimeError(f"cascade frame {off}: regions differ "
                                   "from the JAX-semantics decode")
            checked += 1
        n_crops.append(b.num_tensors)
        whole += int(regions.shape[0] == 1 and
                     tuple(regions[0]) == (0, 0, SIZE, SIZE))
    if sorted(b.offset for b in bufs) != list(range(n)):
        raise RuntimeError("cascade: frames lost or repeated")
    fps, p50_gap = window_times(bufs, 1)
    sat = latencies(bufs)
    # the latency a camera sees: the source paced at CAMERA_FPS, below the
    # cascade's frames/s, so no frame waits behind another in the queues
    _, paced, _ = run_pipeline(
        CASCADE_PIPE.format(sink=PACED_FRAMES + 4, n=PACED_FRAMES, norm=NORM,
                            model="ssd_cascade", regions=CASCADE_REGIONS,
                            labels=labels, s=SIZE),
        frames[:PACED_FRAMES], PACED_FRAMES,
        setup=lambda q: stamp_times(q, CAMERA_FPS))
    if sorted(b.offset for b in paced) != list(range(PACED_FRAMES)):
        raise RuntimeError("cascade (paced): frames lost or repeated")
    lat = latencies(paced)
    slow = sorted(((b.meta["t_sink"] - b.meta["t_src"]) * 1e3, b.offset)
                  for b in paced)[-3:]
    hist = {k: n_crops.count(k) for k in sorted(set(n_crops))}
    print(f"decoders (a) cascade: {n} frames (1x{SIZE}x{SIZE}x3) through "
          f"tee → SSD → tensor_region option1={CASCADE_REGIONS} → "
          f"tensor_crop: fused {p.fused_segments[0]}; scale_bias_cast "
          f"launches={launches}; crops per frame {hist}, whole-frame "
          f"regions {whole}; every crop byte-equal to its frame's slice at "
          f"the CPU decode's regions, {checked} frames equal to the "
          f"JAX-semantics region decode; {fps:.1f} frames/s (CUDA events, "
          f"frames 2..{n}), p50 gap {p50_gap:.3f} ms; source→sink latency "
          f"(host clock) with the source at {CAMERA_FPS} frames/s "
          f"({PACED_FRAMES} frames): p50 {lat[0]:.3f} ms, p99 {lat[1]:.3f} "
          f"ms, slowest (ms, frame) {[(round(t, 3), i) for t, i in slow]}; "
          f"under the unthrottled source (mostly queueing): p50 "
          f"{sat[0]:.3f} ms, p99 {sat[1]:.3f} ms; host start→EOS "
          f"{secs:.2f} s [{card}, {power}]", flush=True)
    fwd = ssd_forward_cost(tree, anchors, frames[0])
    print(f"decoders (a) one batch-1 SSD forward (decode + NMS) alone: "
          f"{fwd['kernels']} CUDA kernels, {fwd['enqueue_ms']:.3f} ms "
          f"of host time to queue them, {fwd['wall_ms']:.3f} ms to the "
          f"end of its device work (medians of 20) [{card}, {power}]",
          flush=True)
    prof = phase_profile(
        CASCADE_PIPE.format(sink=36, n=32, norm=NORM, model="ssd_cascade",
                            regions=CASCADE_REGIONS, labels=labels, s=SIZE),
        frames, card, power, windows=32, label="cascade profile")
    busy = prof[1] if prof is not None else None
    device = [decoded[k]["device"] for k in sorted(decoded)
              if decoded[k]["device"] is not None]
    return {"fps": fps, "busy_ms_32_frames": busy, "forward": fwd,
            "p50_latency_ms": lat[0], "p99_latency_ms": lat[1],
            "p50_latency_saturated_ms": sat[0],
            "p99_latency_saturated_ms": sat[1],
            "launches": launches, "crops_per_frame": hist,
            "whole_frame": whole, "jax_semantics_frames": checked,
            "host_s": secs}, device


def ssd_forward_cost(tree, anchors, frame):
    """One batch-1 SSD forward with its decode and NMS, called directly:
    the CUDA kernels it queues (torch.profiler, copy-engine rows
    excluded), the host time to queue them and the time to the end of
    its device work, medians of 20 after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.models import (
        ssd_detect_apply,
        ssd_from_jax,
        weights_to_bf16,
    )

    model = ssd_from_jax(weights_to_bf16(tree)).cuda()
    anc = torch.from_numpy(anchors).cuda()
    x = (torch.from_numpy(frame).cuda().float() - 127.5) / 127.5

    def forward():
        return ssd_detect_apply(model, x, anc, max_out=MAX_OUT,
                                dtype=torch.bfloat16)

    enq, wall = [], []
    with torch.inference_mode():
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enq.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]
    return {"kernels": sum(e.count for e in rows),
            "enqueue_ms": statistics.median(enq[5:]),
            "wall_ms": statistics.median(wall[5:])}


def text_mask_of(dets, width: int, height: int):
    """The pixels the label text of ``dets`` covers on one canvas."""
    from nnstreamer_tpu_torch.decoders.font import draw_text, label_anchor

    mask = np.zeros((height, width, 4), np.uint8)
    f32 = np.float32
    for d in dets:
        if not d.label:
            continue
        x0 = min(max(int(f32(d.x) * f32(width)), 0), width - 1)
        y0 = min(max(int(f32(d.y) * f32(height)), 0), height - 1)
        lx, ly = label_anchor(x0, y0)
        draw_text(mask, lx, ly, d.label, (1, 1, 1, 1))
    return mask.any(-1)


def labeled_phase(tree, card: str, power: str, labels: str):
    """(b) the SSD composite at batch 256 with label text on the host
    overlay, and option2 with option7=device."""
    import logging

    import torch

    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.decoders.boundingbox import BoundingBoxes
    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        weights_to_bf16,
    )
    from nnstreamer_tpu_torch.ops import kernels

    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    register_detector("ssd_labeled", ssd_from_jax(weights_to_bf16(tree)),
                      anchors, BATCH, torch.bfloat16)
    rng = np.random.default_rng(SEED + 13)
    frames = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(LABELED_WINDOWS)]
    rec = {}

    def setup(p):
        stamp_times(p)
        rec.update(dec=record_decodes(p["overlay"]._decoder()))

    def desc(n, render, with_labels):
        return LABELED_PIPE.format(
            n=n, norm=NORM, model="ssd_labeled", s=SIZE, sink=n + 4,
            render=render,
            labels=f"option2={labels} " if with_labels else "")

    kernels.scale_bias_cast.launches = 0
    p, bufs, secs = run_pipeline(desc(LABELED_WINDOWS, "host", True),
                                 frames, LABELED_WINDOWS, setup=setup)
    launches = kernels.scale_bias_cast.launches
    check_fused(p, None, "labeled overlay")
    plain, host = BoundingBoxes(), BoundingBoxes()
    for d in (plain, host):
        for i, v in ((0, "mobilenet-ssd-postprocess"), (3, f"{SIZE}:{SIZE}"),
                     (4, f"{SIZE}:{SIZE}")):
            d.set_option(i, v)
    host.set_option(1, labels)
    text_px = 0
    for w, b in enumerate(bufs):
        canvas = b.tensors[0].np()
        inputs = list(rec["dec"].values())[w]["inputs"]
        cpu = host.decode(Buffer.of(*inputs), None)
        if canvas.shape != (BATCH, SIZE, SIZE, 4) or \
                canvas.tobytes() != cpu.tensors[0].np().tobytes():
            raise RuntimeError(f"labeled window {w}: the canvas differs from "
                               "the CPU render of the same detections")
        box_only = plain.decode(Buffer.of(*inputs), None).tensors[0].np()
        diff = (canvas != box_only).any(-1)
        for f, dets in enumerate(cpu.meta["detections"]):
            if (diff[f] & ~text_mask_of(dets, SIZE, SIZE)).any():
                raise RuntimeError(f"labeled window {w} frame {f}: pixels "
                                   "outside the label text differ from the "
                                   "box-only render")
        text_px += int(diff.sum())
    if text_px == 0:
        raise RuntimeError("labeled: no label pixel drawn")
    t = [b.meta["t_sink"] for b in bufs]
    fps = (len(t) - 1) * BATCH / (t[-1] - t[0])
    p50 = statistics.median((b - a) * 1e3 for a, b in zip(t, t[1:]))

    # option2 with option7=device: one warning, the box-only device canvas
    msgs = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "label text" in record.getMessage():
                msgs.append(record.getMessage())

    log = logging.getLogger("nnstreamer_tpu_torch")
    catch = Catch()
    log.addHandler(catch)
    try:
        _, dev_l, _ = run_pipeline(desc(2, "device", True), frames[:2], 2)
    finally:
        log.removeHandler(catch)
    _, dev_p, _ = run_pipeline(desc(2, "device", False), frames[:2], 2)
    for a, b in zip(dev_l, dev_p):
        if not torch.equal(a.tensors[0].torch(), b.tensors[0].torch()):
            raise RuntimeError("option7=device with option2: the canvas "
                               "differs from the box-only device canvas")
    if len(msgs) != 1:
        raise RuntimeError(f"option7=device with option2: {len(msgs)} "
                           "warnings, one expected")
    print(f"decoders (b) labeled overlay: SSD batch {BATCH}, "
          f"{LABELED_WINDOWS} windows, option7=host option2=<{BATCH_LABELS} "
          f"labels>: scale_bias_cast launches={launches}; every canvas "
          f"byte-equal to the CPU render of the same detections, {text_px} "
          f"label pixels and nothing else differ from the box-only render; "
          f"{fps:.1f} frames/s (host clock at the sink, windows 2.."
          f"{LABELED_WINDOWS}), p50 window {p50:.3f} ms, host start→EOS "
          f"{secs:.2f} s; option7=device with option2: one warning "
          f"({msgs[0]!r}), canvases equal to the box-only device canvas "
          f"[{card}, {power}]", flush=True)
    return {"fps": fps, "p50_window_ms": p50, "launches": launches,
            "label_pixels": text_px, "host_s": secs}


def prereduce_phase(card: str, power: str):
    """(c) image_segment and pose_estimation pre-reduced on the card at
    DeepLab v3 257's and PoseNet MobileNetV1 257's output shapes, staged
    on the card through ``appsrc``."""
    import torch

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.decoders import find_decoder
    from nnstreamer_tpu_torch.runtime import parse_launch

    rng = np.random.default_rng(SEED + 14)
    res = {}
    cases = (
        ("image_segment", "", [(1, 257, 257, 21)], (257, 257)),
        ("pose_estimation", "option1=257:257 option2=257:257 "
         "option4=heatmap-offset", [(1, 9, 9, 17), (1, 9, 9, 34)], (17, 5)),
    )
    for mode, opts, shapes, rows in cases:
        ins = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
               for _ in range(PREREDUCE_FRAMES)]
        p = parse_launch(f"appsrc name=src ! tensor_decoder name=dec "
                         f"mode={mode} {opts} ! appsink name=out "
                         f"max-buffers={PREREDUCE_FRAMES + 4}",
                         device="cuda")
        p["src"].spec = TensorsSpec.from_shapes(shapes, np.float32)
        staged = [[torch.from_numpy(a).cuda() for a in f]
                  for f in ins]
        copies, restore = count_card_copies()
        try:
            with p:
                for i, f in enumerate(staged):
                    p["src"].push_buffer(Buffer.of(*f, pts=i))
                p["src"].end_of_stream()
                if not p.wait_eos(timeout=300):
                    raise RuntimeError(f"{mode}: no EOS")
        finally:
            restore()
        outs = []
        while (b := p["out"].pull(timeout=0)) is not None:
            outs.append(b)
        if len(outs) != PREREDUCE_FRAMES or \
                copies != [rows] * PREREDUCE_FRAMES:
            raise RuntimeError(f"{mode}: {len(outs)} outputs, card→host "
                               f"copies {copies}; one {rows} copy a frame "
                               "expected")
        ref = find_decoder(mode)()
        for i, tok in enumerate(opts.split()):
            ref.set_option(int(tok[6]) - 1, tok.partition("=")[2])
        for b, f in zip(outs, ins):
            cpu = ref.decode(Buffer.of(*f), None)
            if b.tensors[0].np().tobytes() != cpu.tensors[0].np().tobytes():
                raise RuntimeError(f"{mode}: frame differs from the CPU's")
            if mode == "image_segment":
                same = np.array_equal(b.meta["segment_map"],
                                      cpu.meta["segment_map"])
            else:
                same = b.meta["keypoints"] == cpu.meta["keypoints"]
            if not same:
                raise RuntimeError(f"{mode}: result differs from the CPU's")
        print(f"decoders (c) {mode} {' '.join(str(s) for s in shapes)} on "
              f"the card: {PREREDUCE_FRAMES} frames, one card→host copy of "
              f"{rows} a frame, maps/keypoints and RGBA frames equal to the "
              f"CPU run's [{card}, {power}]", flush=True)
        res[mode] = {"frames": PREREDUCE_FRAMES, "copy_shape": list(rows)}
    return res


def wire_phase(device_dets, card: str, power: str):
    """(d) the cascade filter's 4 output tensors, from the card, through
    protobuf → tensor_converter → octet_stream: the bytes come back."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    first = device_dets[0]
    p = parse_launch(
        "appsrc name=src ! tensor_decoder mode=protobuf ! tensor_converter "
        "! tensor_decoder mode=octet_stream ! appsink name=out "
        f"max-buffers={len(device_dets) + 4}", device="cuda")
    p["src"].spec = TensorsSpec.from_shapes(
        [tuple(t.shape) for t in first],
        [np.dtype(str(t.dtype).replace("torch.", "")) for t in first])
    with p:
        for i, ts in enumerate(device_dets):
            if not all(t.is_cuda for t in ts):
                raise RuntimeError("wire: the detections are not on the card")
            p["src"].push_buffer(Buffer.of(*ts, pts=i))
        p["src"].end_of_stream()
        if not p.wait_eos(timeout=120):
            raise RuntimeError("wire: no EOS")
    n = 0
    for ts in device_dets:
        b = p["out"].pull(timeout=1)
        want = b"".join(t.cpu().numpy().tobytes() for t in ts)
        if b is None or b.tensors[0].np().tobytes() != want:
            raise RuntimeError("wire: protobuf round trip changed the bytes")
        n += len(want)
    print(f"decoders (d) wire: {len(device_dets)} frames of the cascade "
          f"filter's 4 outputs ({', '.join(str(tuple(t.shape)) for t in first)}"
          f") from the card through protobuf → tensor_converter → "
          f"octet_stream: {n} bytes equal [{card}, {power}]", flush=True)
    return {"frames": len(device_dets), "bytes": n}


def phase_decoders(card: str, power: str):
    """Phase 12 (see the module doc)."""
    from nnstreamer_tpu_torch.decoders.font import glyph_source
    from nnstreamer_tpu_torch.models import ssd_mobilenet_v2_init

    t0 = time.perf_counter()
    print(f"decoders: label glyphs from {glyph_source()}", flush=True)
    tree = ssd_mobilenet_v2_init(SEED, NUM_CLASSES)
    labels = write_labels(BATCH_LABELS)
    res, device_dets = cascade_phase(tree, card, power, labels)
    out = {"cascade": res,
           "labeled": labeled_phase(tree, card, power, labels),
           "prereduce": prereduce_phase(card, power),
           "wire": wire_phase(device_dets, card, power),
           "glyphs": glyph_source()}
    print(f"decoders phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


# -- phase 13: the stream elements and the pytorch filter ------------------------

ELEM_FRAMES = 2048        # 13a: camera frames, 4 windows of CLS_BATCH
GATED_FRAMES = 512        # 13b gated: camera frames stamped at GATED_FPS
GATED_FPS = 30
GATED_RATE = "15/1"
TWO_CAM_FRAMES = 512      # 13b two cameras: frames per camera
TWO_CAM_BATCH = 256
#: TorchScript logits against the torch-cuda filter's, both bf16 compute
#: with bf16-rounded logits: at most this many bf16 ulps at the logits'
#: largest magnitude (the H100 reads 1 ulp: 9.77e-4 at magnitudes
#: 0.125-0.25; the same module at f32 compute must fall outside)
TS_ULPS = 2


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at ``|x|``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)

AGG_CLS_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_aggregator name=agg frames-in=1 frames-out={b} "
    "frames-flush={b} frames-dim=3 ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! tensor_filter name=net {fw} ! {sink}")
GATED_PIPE = (
    "device_src name=src num-buffers={n} fps={fps} ! "
    "tensor_rate name=rate framerate={rate} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! tensor_filter name=net framework=torch-cuda "
    "model={model} ! tensor_if name=gate compared-value=A_VALUE "
    "compared-value-option=0:0 operator=ge supplied-value={k!r} "
    "then=PASSTHROUGH else=SKIP "
    "gate.src_then ! tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} "
    "option7=device ! tee name=o "
    "o. ! queue ! appsink name=dense max-buffers={sink} "
    "o. ! queue ! tensor_converter ! tensor_sparse_enc ! "
    "tensor_sparse_dec ! appsink name=roundtrip max-buffers={sink}")
DETECT_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! tensor_filter name=net framework=torch-cuda "
    "model={model} ! appsink name=out max-buffers={sink}")
TWO_CAM_PIPE = (
    "tensor_merge name=m mode=linear option=3 sync-mode=slowest ! "
    "tensor_aggregator name=agg frames-in=2 frames-out={b} "
    "frames-flush={b} frames-dim=3 ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! tensor_filter name=net framework=torch-cuda "
    "model={model} ! tensor_demux name=d tensorpick=0:1:2:3,2 "
    "d.src_0 ! tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} "
    "option7=device ! appsink name=out max-buffers={sink} "
    "d.src_1 ! tensor_sink name=scores "
    "device_src name=cam0 num-buffers={n} fps={fps} ! m.sink_0 "
    "device_src name=cam1 num-buffers={n} fps={fps} ! m.sink_1")


def run_started(p, timeout: float = 900):
    """Start ``p``, wait for EOS, stop it; host seconds start→EOS."""
    t0 = time.perf_counter()
    p.start()
    try:
        if not p.wait_eos(timeout=timeout):
            raise RuntimeError(f"no EOS within {timeout} s")
    finally:
        p.stop()
    return time.perf_counter() - t0


def pull_all(sink):
    out = []
    while (b := sink.pull(timeout=0)) is not None:
        out.append(b)
    return out


def record_pushes(el, keep=lambda b: b):
    """Wrap an element's ``push``: keep ``keep(buf)`` of every buffer it
    pushes, with the host clock at the push."""
    rec, push = [], el.push

    def recording(buf, pad=None):
        rec.append((time.perf_counter(), keep(buf)))
        push(buf, pad)

    el.push = recording
    return rec


def elements_classify(card: str, power: str):
    """13a: camera frames aggregated into MobileNetV1 windows, the model a
    TorchScript file through ``framework=pytorch``."""
    import tempfile

    import torch

    from nnstreamer_tpu_torch.core import DType
    from nnstreamer_tpu_torch.elements.transform import (
        _fold_affine,
        parse_arith_ops,
    )
    from nnstreamer_tpu_torch.filters.pytorch import PyTorchFilter
    from nnstreamer_tpu_torch.models import (
        mobilenet_v1_from_jax,
        mobilenet_v1_init,
        register_mobilenet,
        trace_classifier,
        weights_to_bf16,
    )
    from nnstreamer_tpu_torch.ops import kernels

    n, b, s = ELEM_FRAMES, CLS_BATCH, CLS_SIZE
    windows = n // b
    rng = np.random.default_rng(SEED + 13)
    frames = [rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8)
              for _ in range(n)]
    # phase 10's weights, bf16-resident, traced to TorchScript on the card
    tree = mobilenet_v1_init(SEED, CLS_CLASSES)
    model = mobilenet_v1_from_jax(weights_to_bf16(tree)).to("cuda")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "mobilenet_v1.pt")
    t0 = time.perf_counter()
    trace_classifier(model, (b, s, s, 3)).save(path)
    trace_s = time.perf_counter() - t0
    del model
    fw = (f"framework=pytorch model={path} input=3:{s}:{s}:{b} "
          "inputtype=float32")
    desc = AGG_CLS_PIPE.format(n=n, b=b, norm=NORM, fw=fw,
                               sink="tensor_sink name=out")
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch(desc, device="cuda")
    p["src"].frames, p["src"].pool_size = frames, n
    logits = []
    p["out"].connect(logits.append)
    agg = p["agg"]
    starts, transform = [], agg.transform

    def timed(buf):
        if not agg._window:
            starts.append(time.perf_counter())
        return transform(buf)

    agg.transform = timed
    wins = record_pushes(agg, lambda w: w.tensors[0].torch())
    infer, orig_infer = [], PyTorchFilter._infer_out_spec

    def timed_infer(self, spec):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_infer(self, spec)
        torch.cuda.synchronize()
        infer.append(time.perf_counter() - t)
        return out

    PyTorchFilter._infer_out_spec = timed_infer
    kernels.scale_bias_cast.launches = 0
    try:
        secs = run_started(p)
    finally:
        PyTorchFilter._infer_out_spec = orig_infer
    launches = kernels.scale_bias_cast.launches
    if len(logits) != windows or len(wins) != windows:
        raise RuntimeError(f"elements (a): {len(logits)} logits, "
                           f"{len(wins)} windows for {windows}")
    if not windows <= launches <= windows + 2:
        raise RuntimeError(f"elements (a): scale_bias_cast launched "
                           f"{launches} times for {windows} windows")
    pool = [t[0] for t in p["src"]._pool]
    for w, (_, x) in enumerate(wins):
        if x.device.type != "cuda" or not torch.equal(
                x, torch.cat(pool[w * b:(w + 1) * b])):
            raise RuntimeError(f"elements (a) window {w}: not the "
                               f"torch.cat of its {b} source frames")
    a_, c_, _ = _fold_affine(parse_arith_ops(NORM), DType.UINT8)
    x0 = wins[0][1]
    if not torch.equal(kernels.scale_bias_cast(x0, a_, c_ / a_, torch.float32),
                       kernels.scale_bias_cast_reference(x0, a_, c_ / a_,
                                                         torch.float32)):
        raise RuntimeError("elements (a): scale_bias_cast and its plain "
                           "version differ on a window")
    gather = [(t - s0) * 1e3 for s0, (t, _) in zip(starts, wins)]
    fps, p50 = window_times(logits, b)
    ts = [x.tensors[0].torch() for x in logits]
    # the same windows through framework=torch-cuda register_mobilenet
    register_mobilenet("elements_mobilenet_v1", "v1", CLS_CLASSES, batch=b,
                       size=s, seed=SEED)
    q = parse_launch(AGG_CLS_PIPE.format(
        n=n, b=b, norm=NORM,
        fw="framework=torch-cuda model=elements_mobilenet_v1",
        sink=f"appsink name=out max-buffers={windows + 4}"),
        device="cuda")
    q["src"].frames, q["src"].pool_size = frames, n
    run_started(q)
    ref = [x.tensors[0].torch() for x in pull_all(q["out"])]
    tol = TS_ULPS * bf16_ulp(max(float(r.abs().max()) for r in ref))
    worst, equal, agree = 0.0, 0, True
    for g, r in zip(ts, ref):
        d = (g - r).abs()
        worst = max(worst, float(d.max()))
        equal += int((d == 0).sum())
        if not bool((d <= tol).all()):
            raise RuntimeError(f"elements (a): TorchScript logits differ "
                               f"from torch-cuda's beyond {tol} ({TS_ULPS} "
                               f"bf16 ulps; max {float(d.max())})")
        top2 = r.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree &= bool((g.argmax(-1) == r.argmax(-1))[sure].all())
    if not agree:
        raise RuntimeError("elements (a): argmax differs where the top-2 "
                           "margin exceeds twice the tolerance")
    total = sum(int(t.numel()) for t in ts)
    ts_mod = torch.jit.load(path, map_location="cuda")
    xf = x0.float()
    fwd = kernels_per_call(lambda: ts_mod(xf))
    eager = mobilenet_v1_from_jax(weights_to_bf16(tree)).to("cuda")
    fwd_eager = kernels_per_call(lambda: eager(xf))
    # the gate must see a change of precision: the same module computing
    # at f32 on window 0's filter input falls outside it
    with torch.inference_mode():
        f32 = eager(kernels.scale_bias_cast_reference(
            x0, a_, c_ / a_, torch.float32), torch.float32)
    f32_worst = float((f32 - ref[0]).abs().max())
    if f32_worst <= tol:
        raise RuntimeError(f"elements (a): the module at f32 compute is "
                           f"within {tol} of the bf16 logits (max "
                           f"{f32_worst}): the gate cannot tell them apart")
    del eager, f32
    print(f"elements (a): {n} camera frames (1x{s}x{s}x3) → "
          f"tensor_aggregator frames-out={b} → transform backend=cuda → "
          f"tensor_filter framework=pytorch (MobileNetV1, TorchScript traced "
          f"in {trace_s:.2f} s, bf16-resident weights, {CLS_CLASSES} classes) → "
          f"tensor_sink: {windows} windows, each the torch.cat of its "
          f"{b} frames; scale_bias_cast launches={launches}, equal to its "
          f"plain version on a window; {fps:.1f} frames/s (CUDA events, "
          f"windows 2..{windows}), "
          f"p50 window {p50:.3f} ms; aggregator host time a window "
          f"({b} buffers through device_src → tensor_aggregator) "
          f"{[round(g, 3) for g in gather]} ms; out-spec inference "
          f"(one forward at batch {b}, at negotiation) "
          f"{[round(t * 1e3, 3) for t in infer]} ms; host start→EOS "
          f"{secs:.2f} s [{card}, {power}]", flush=True)
    print(f"elements (a): TorchScript vs framework=torch-cuda "
          f"register_mobilenet on the same windows: max |Δlogit| {worst} "
          f"(gate {tol}: {TS_ULPS} bf16 ulps at the largest |logit|), "
          f"{equal} of {total} logits equal, argmax equal where the margin "
          f"exceeds {2 * tol}; the same module at f32 compute on window 0: "
          f"max |Δlogit| {f32_worst}, outside the gate; one forward at "
          f"batch {b} (medians of 5): "
          f"TorchScript {fwd['kernels']} CUDA kernels, {fwd['d2h']} "
          f"device→host copies, returns after {fwd['enqueue_ms']:.3f} ms, "
          f"device work done at {fwd['wall_ms']:.3f} ms; the eager module "
          f"{fwd_eager['kernels']} kernels, {fwd_eager['d2h']} copies, "
          f"{fwd_eager['enqueue_ms']:.3f} ms, {fwd_eager['wall_ms']:.3f} ms "
          f"[{card}, {power}]", flush=True)
    prof = phase_profile(
        AGG_CLS_PIPE.format(n=2 * b, b=b, norm=NORM, fw=fw,
                            sink="appsink name=out max-buffers=8"),
        frames, card, power, windows=2, label="elements (a) profile")
    # the busy share in steady state: windows 3..7 of an 8-window run
    q = parse_launch(desc.replace(f"num-buffers={n}",
                                  f"num-buffers={8 * b}"),
                     device="cuda")
    q["src"].frames, q["src"].pool_size = frames, n
    busy, span, host_ms, d2h = steady_profile(q, 2, 7)
    print(f"elements (a) steady: while windows 3..7 of 8 reach the sink "
          f"({host_ms:.3f} ms on the host): kernels busy {busy:.3f} ms of a "
          f"{span:.3f} ms device span, first kernel start to last kernel "
          f"end (busy share {busy / span:.4f}, the union of kernel "
          f"intervals), {d2h} device→host copies [{card}, {power}]",
          flush=True)
    if d2h or fwd["d2h"]:
        raise RuntimeError(f"elements (a): {d2h} device→host copies in "
                           f"windows 3..7, {fwd['d2h']} in one TorchScript "
                           "forward (the path must make none before the "
                           "sink)")
    tmp.cleanup()
    return {"fps": fps, "p50_window_ms": p50, "launches": launches,
            "gather_ms": gather, "out_spec_forward_ms":
            [t * 1e3 for t in infer], "torchscript_vs_torch_cuda_max":
            worst, "torchscript_gate": tol, "f32_vs_torch_cuda_max":
            f32_worst, "equal_logits": equal, "logits": total,
            "forward": fwd, "forward_eager": fwd_eager, "host_s": secs,
            "busy_ms_2_windows": prof[1] if prof is not None else None,
            "steady_busy_ms": busy, "steady_span_ms": span,
            "steady_host_ms": host_ms, "steady_busy_share": busy / span,
            "steady_d2h": d2h}


def kernels_per_call(fn):
    """One call of ``fn`` after a warm-up: the CUDA kernels it queues and
    the device→host copies it makes (torch.profiler; copy-engine rows
    apart), the host time until it returns (medians of 5, the card idle
    before each call) and the time to the end of its device work (CUDA
    events).  A call that returns only when its device work is done
    syncs inside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        walls, enqueue = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            s.record()
            fn()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            e.record()
            e.synchronize()
            walls.append(s.elapsed_time(e))
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    return {"kernels": sum(ev.count for ev in rows
                           if not ev.key.startswith(("Memcpy", "Memset"))),
            "d2h": sum(ev.count for ev in rows
                       if ev.key.startswith("Memcpy DtoH")),
            "enqueue_ms": statistics.median(enqueue),
            "wall_ms": statistics.median(walls)}


def device_busy(events):
    """The device's busy share over its own clock, from torch.profiler's
    events: the union of the kernel rows' intervals (overlapping kernels
    counted once; copy-engine rows apart) over the span from the first
    kernel's start to the last kernel's end.  Returns (busy ms, span ms,
    device→host copies).  Neither end of the span is a host time, so work
    queued before the profile started or run after it stopped cannot
    push the share above 1."""
    from torch.autograd import DeviceType

    rows = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in rows
                   if not ev.name.startswith(("Memcpy", "Memset")))
    d2h = sum(1 for ev in rows if ev.name.startswith("Memcpy DtoH"))
    if not spans:
        return 0.0, 0.0, d2h
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo = a
        hi = max(hi, b)
    busy += hi - lo
    span = max(b for _, b in spans) - spans[0][0]
    if busy > span:
        raise RuntimeError(f"device busy {busy} µs over a span of {span} µs")
    return busy / 1e3, span / 1e3, d2h


def steady_profile(p, first: int, last: int):
    """Device busy share of a running pipeline while its sink ``out``
    receives buffers ``first``..``last`` (torch.profiler, device activity
    only, started and stopped at those host arrivals; the share itself is
    :func:`device_busy`'s, on the device's clock).  Returns busy ms, the
    device span ms, the host ms between the two arrivals and the
    device→host copies.  Starts ``p``, and stops it at EOS.

    The profiler starts and stops inside the sink's callback, on the
    pipeline's one streaming thread: stopping it from another thread
    while that thread launches kernels crashed the process (a segfault,
    or glibc's "double free or corruption") in about one run in six."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    seen, t0, host = [0], [0.0], []

    def on_buffer(_buf):
        seen[0] += 1
        if seen[0] == first:
            prof.start()
            t0[0] = time.perf_counter()
        elif seen[0] == last:
            host.append((time.perf_counter() - t0[0]) * 1e3)
            prof.stop()

    p["out"].connect(on_buffer)
    p.start()
    try:
        if not p.wait_eos(timeout=600):
            raise RuntimeError("steady profile: no EOS within 600 s")
    finally:
        p.stop()
    if not host:
        raise RuntimeError(f"steady profile: {seen[0]} buffers reached the "
                           f"sink, not {last}")
    host_ms = host[0]
    busy, span, d2h = device_busy(prof.events())
    if span <= 0:
        raise RuntimeError("steady profile: the profiler saw no kernel")
    return busy, span, host_ms, d2h


def elements_gated(tree, anchors, card: str, power: str):
    """13b, gated: one camera at batch 1 through tensor_rate, the SSD and
    tensor_if, the kept frames' overlays through a sparse round trip."""
    import torch

    from nnstreamer_tpu_torch.models import ssd_from_jax, weights_to_bf16
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch

    n = GATED_FRAMES
    register_detector("elements_ssd_1", ssd_from_jax(weights_to_bf16(tree)),
                      anchors, 1, torch.bfloat16)
    rng = np.random.default_rng(SEED + 14)
    frames = [rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(n)]
    # the frames on the 15/1 clock, computed here from the stamps: for
    # each slot, the first frame whose pts is at or after it
    pts = [int(i * 1_000_000_000 / GATED_FPS) for i in range(n)]
    step = int(1_000_000_000 * 1 / 15)
    slots = range(0, pts[-1] + 1, step)
    on_clock = [next(i for i in range(n) if pts[i] >= t) for t in slots]
    # the frames on the clock alone: the gate's value for each, and k.
    # The random-weight SSD saturates every score (all max_out
    # detections pass, on every frame), so the count cannot split the
    # stream; the gate reads the top detection's ymin (tensor 0, flat
    # index 0), and k is its median over these frames
    _, alone, _ = run_pipeline(DETECT_PIPE.format(
        n=len(on_clock), norm=NORM, model="elements_ssd_1",
        sink=len(on_clock) + 4), [frames[i] for i in on_clock],
        len(on_clock), device="cuda")
    alone = sorted(alone, key=lambda x: x.offset)
    nums = [int(x.tensors[3].torch().reshape(-1)[0]) for x in alone]
    ymin = [float(x.tensors[0].torch().reshape(-1)[0]) for x in alone]
    k = float(np.median(ymin))
    want_then = {t: v >= k for t, v in zip(slots, ymin)}
    if all(want_then.values()) or not any(want_then.values()):
        raise RuntimeError("elements (b): the median takes one branch only")
    p = parse_launch(GATED_PIPE.format(n=n, fps=GATED_FPS, rate=GATED_RATE,
                                       norm=NORM, model="elements_ssd_1",
                                       k=k, s=SIZE, sink=n + 4),
                     device="cuda")
    p["src"].frames, p["src"].pool_size = frames, n
    at_filter = []
    chain = p["net"].chain

    def seen(pad, buf):
        at_filter.append((buf.pts, buf.offset))
        chain(pad, buf)

    p["net"].chain = seen
    kernels.scale_bias_cast.launches = 0
    secs = run_started(p)
    launches = kernels.scale_bias_cast.launches
    if [o for _, o in at_filter] != on_clock or \
            [t for t, _ in at_filter] != list(slots):
        raise RuntimeError(f"elements (b): frames at the filter "
                           f"{at_filter[:6]}… are not those on the "
                           f"{GATED_RATE} clock {on_clock[:6]}…")
    if not len(on_clock) <= launches <= len(on_clock) + 2:
        raise RuntimeError(f"elements (b): scale_bias_cast launched "
                           f"{launches} times for {len(on_clock)} frames")
    dense, round_ = pull_all(p["dense"]), pull_all(p["roundtrip"])
    kept = sorted(x.pts for x in dense)
    if kept != sorted(t for t, v in want_then.items() if v):
        raise RuntimeError("elements (b): the frames routed to then differ "
                           "from those the same outputs run alone give")
    gate = p["gate"]
    if gate.verdict_copies != len(on_clock):
        raise RuntimeError(f"elements (b): {gate.verdict_copies} verdict "
                           f"copies for {len(on_clock)} frames")
    by_pts = {x.pts: x for x in round_}
    for x in dense:
        if x.tensors[0].torch().device.type != "cuda":
            raise RuntimeError("elements (b): the overlay left the card")
        twin = by_pts[x.pts].tensors[0]
        if twin.tobytes() != x.tensors[0].tobytes():
            raise RuntimeError(f"elements (b) frame at {x.pts}: the sparse "
                               "round trip changed the canvas")
    fps, p50 = window_times(sorted(dense, key=lambda x: x.pts), 1)
    print(f"elements (b) gated: {n} frames (1x{SIZE}x{SIZE}x3) stamped at "
          f"{GATED_FPS} frames/s → tensor_rate {GATED_RATE}: "
          f"{len(on_clock)} frames at the filter, exactly those on the "
          f"clock; SSD at batch 1 (detection counts of the frames alone "
          f"{dict(sorted(Counter(nums).items()))}) → tensor_if top ymin >= "
          f"{k!r} (its median over the frames alone): "
          f"kept {len(dense)} of {len(on_clock)} (share "
          f"{len(dense) / len(on_clock):.3f}), the routed set equal to the "
          f"alone run's; {gate.verdict_copies} scalar copies for "
          f"{len(on_clock)} verdicts; every canvas byte-equal after "
          f"tensor_sparse_enc → tensor_sparse_dec; scale_bias_cast "
          f"launches={launches}; kept frames {fps:.1f}/s (CUDA events at "
          f"the dense sink), p50 gap {p50:.3f} ms; {len(on_clock) / secs:.1f} "
          f"frames/s into the filter over host start→EOS {secs:.2f} s "
          f"[{card}, {power}]", flush=True)
    return {"launches": launches, "k": k, "kept": len(dense),
            "at_filter": len(on_clock), "kept_share":
            len(dense) / len(on_clock), "kept_fps": fps,
            "p50_gap_ms": p50, "filter_fps_host": len(on_clock) / secs,
            "host_s": secs, "verdict_copies": gate.verdict_copies}


def elements_two_cameras(tree, anchors, card: str, power: str):
    """13b, two cameras: merged into one 256-frame window, the SSD end to
    end, the outputs fanned out by tensor_demux."""
    import torch

    from nnstreamer_tpu_torch.models import ssd_from_jax, weights_to_bf16
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch

    n, b = TWO_CAM_FRAMES, TWO_CAM_BATCH
    windows = 2 * n // b
    register_detector("elements_ssd_256", ssd_from_jax(weights_to_bf16(tree)),
                      anchors, b, torch.bfloat16)
    rng = np.random.default_rng(SEED + 15)
    cams = [[rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
             for _ in range(n)] for _ in range(2)]
    p = parse_launch(TWO_CAM_PIPE.format(b=b, norm=NORM,
                                         model="elements_ssd_256", s=SIZE,
                                         sink=windows + 4, n=n,
                                         fps=GATED_FPS), device="cuda")
    for c in range(2):
        p[f"cam{c}"].frames, p[f"cam{c}"].pool_size = cams[c], n
    scores = []
    p["scores"].connect(scores.append)
    wins = record_pushes(p["agg"], lambda w: w.tensors[0].torch())
    outs = record_pushes(p["net"], lambda o: o.tensors[2].torch())
    kernels.scale_bias_cast.launches = 0
    secs = run_started(p)
    launches = kernels.scale_bias_cast.launches
    over = pull_all(p["out"])
    if not (len(over) == len(scores) == len(wins) == windows):
        raise RuntimeError(f"elements (b) two cameras: {len(over)} overlays, "
                           f"{len(scores)} score buffers, {len(wins)} "
                           f"windows for {windows}")
    if not windows <= launches <= windows + 2:
        raise RuntimeError(f"elements (b) two cameras: scale_bias_cast "
                           f"launched {launches} times for {windows} windows")
    pools = [[t[0] for t in p[f"cam{c}"]._pool] for c in range(2)]
    half = b // 2
    for w, (_, x) in enumerate(wins):
        want = torch.cat([pools[c][j] for j in range(w * half,
                                                     (w + 1) * half)
                          for c in range(2)])
        if not torch.equal(x, want):
            raise RuntimeError(f"elements (b) window {w}: frames not "
                               "interleaved camera 0, camera 1 per instant")
    for w, (sc, (_, o)) in enumerate(zip(scores, outs)):
        if not torch.equal(sc.tensors[0].torch(), o):
            raise RuntimeError(f"elements (b) window {w}: the scores on "
                               "tensor_sink are not the filter's output 2")
    # the same windows through phase 4's composite (fused, one program)
    _, comp, _ = run_pipeline(
        composite("elements_ssd_256", "cuda", windows, size=SIZE),
        [x.cpu().numpy() for _, x in wins], windows, device="cuda")
    for w, (a, c) in enumerate(zip(over, comp)):
        if not torch.equal(a.tensors[0].torch(), c.tensors[0].torch()):
            raise RuntimeError(f"elements (b) window {w}: the overlays "
                               "differ from the composite's")
    fps, p50 = window_times(over, half)
    print(f"elements (b) two cameras: 2 x {n} frames (1x{SIZE}x{SIZE}x3, "
          f"stamped at {GATED_FPS} frames/s) → tensor_merge option=3 "
          f"sync-mode=slowest → tensor_aggregator frames-out={b} → SSD at "
          f"batch {b} → tensor_demux 0:1:2:3,2: {windows} windows, each "
          f"the two cameras interleaved per instant; overlays byte-equal to "
          f"phase 4's composite on the same windows; the scores on "
          f"tensor_sink equal output 2; scale_bias_cast "
          f"launches={launches}; {fps:.1f} frames/s per camera (CUDA "
          f"events, windows 2..{windows}), p50 window {p50:.3f} ms; host "
          f"start→EOS {secs:.2f} s [{card}, {power}]", flush=True)
    return {"launches": launches, "fps_per_camera": fps,
            "p50_window_ms": p50, "host_s": secs}


def phase_elements(card: str, power: str):
    """Phase 13 (see the module doc)."""
    import torch

    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_mobilenet_v2_init,
    )

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"classify": elements_classify(card, power)}
    tree = ssd_mobilenet_v2_init(SEED, NUM_CLASSES)
    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    out["gated"] = elements_gated(tree, anchors, card, power)
    out["two_cameras"] = elements_two_cameras(tree, anchors, card, power)
    print(f"elements phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


# -- phase 14: the observability layer on two full-width paths ---------------

#: 14a: phase 8's shared topology under observation (see the module doc)
OBS_TRACE_EVERY = 8        # the tracer samples 1 frame in 8
OBS_CHAOS = "seed=7;slow-invoke:ms=2,p=0.05,match=pool"
OBS_SLOW_S = 0.002         # the plan's slow-invoke sleep
#: the pool SLO: far above a window cycle, so admission arms and reads its
#: p99 from the registry's histogram but sheds nothing (a shed frame would
#: never come back to its closed-loop client); the warm-up's first windows
#: (a bucket's first dispatch is counted and fold-checked) can take the
#: p99 past the ramp of a tighter SLO, so the signal is reset after it
OBS_SLO_MS = 5000
OBS_SAMPLE_MS = 0          # every dispatch a blocking stats sample
OBS_MARGIN = 5e-2          # top-2 margin above which a label must be alone's
OBS_PROFILED = 16          # frames per stream of the ledger-vs-profiler span
OBS_MFU_MAX = 1.05
OBS_FLOPS_TOL = 0.01
OBS_SCRAPE_S = 0.25        # the HTTP scraper's period during the timed run
#: 14b: phase 4's pipeline, passive obs against the kill switch
OBS_WINDOWS = 8
OBS_PASSIVE_TOL = 0.03     # the JAX package's own bound (obs/metrics.py)
OBS_FAIL = "seed=3;fail-invoke:every=2,count=1"
#: the device of 14b's hand count; a dry run on "cpu" shrinks the sizes
OBS_DEVICE = "cuda"


def vit_flops_per_frame() -> int:
    """The ViT forward's matmul and convolution FLOPs a frame, by hand
    (2·MAC; attention 4·H·T²·dh): what the port's count covers."""
    t = (VIT_SIZE // VIT["patch"]) ** 2
    dim, mlp, heads = VIT["dim"], VIT["mlp_dim"], VIT["heads"]
    embed = 2 * t * dim * 3 * VIT["patch"] ** 2
    block = (2 * t * dim * 3 * dim                 # qkv
             + 4 * heads * t * t * (dim // heads)  # q·kᵀ and p·v
             + 2 * t * dim * dim                   # output projection
             + 2 * 2 * t * dim * mlp)              # the MLP
    return embed + VIT["depth"] * block + 2 * dim * VIT["num_classes"]


def profiled_copies(fn):
    """(result, {"HtoD": (count, bytes), "DtoH": (count, bytes)}): the
    host↔device copy rows of torch.profiler's trace of ``fn()``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rows = {"HtoD": [0, 0], "DtoH": [0, 0]}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        for kind, row in rows.items():
            if kind in e["name"]:
                row[0] += 1
                row[1] += int(e["args"]["bytes"])
    return out, {k: tuple(v) for k, v in rows.items()}


def ledger_totals():
    """{"HtoD": (count, bytes), "DtoH": ...} of the transfer ledger."""
    from nnstreamer_tpu_torch.obs.transfer import LEDGER

    return {"HtoD": LEDGER.totals(direction="h2d"),
            "DtoH": LEDGER.totals(direction="d2h")}


def _delta(a, b):
    return {k: (b[k][0] - a[k][0], b[k][1] - a[k][1]) for k in a}


def _http(base: str, path: str):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=30) as r:
        body = r.read().decode()
    return body if path == "/metrics" else json.loads(body)


def _metric(text: str, name: str, **labels) -> float:
    """The sum of the exposition samples of ``name`` whose labels include
    ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name + "{") and not line.startswith(
                name + " "):
            continue
        head, _, value = line.rpartition(" ")
        if all(f'{k}="{v}"' in head for k, v in labels.items()):
            total += float(value)
    return total


def _phase_hists(label: str):
    """(sum, count) of the pool's nns_invoke_* histograms by phase."""
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    fams = REGISTRY.collect()
    out = {}
    for fam, phase in (("nns_invoke_device_seconds", "device"),
                       ("nns_invoke_host_seconds", "prep"),
                       ("nns_invoke_host_seconds", "drain")):
        s = n = 0.0
        for x in fams.get(fam, {}).get("samples", ()):
            lb = x["labels"]
            if lb.get("source") != label or lb.get("kind") != "pool" or \
                    lb.get("phase", "device") != phase:
                continue
            if x.get("name", "").endswith("_sum"):
                s += x["value"]
            elif x.get("name", "").endswith("_count"):
                n += x["value"]
        out[phase] = (s, n)
    return out


def check_trace_nests(doc: dict) -> int:
    """The Chrome trace round-trips through JSON and every event lies in
    its frame's span; returns the number of frames."""
    doc = json.loads(json.dumps(doc))
    events = doc["traceEvents"]
    frames = {e["tid"]: e for e in events if e["cat"] == "frame"}
    for e in events:
        f = frames[e["tid"]]
        if e["ts"] < f["ts"] - 1e-3 or \
                e["ts"] + e.get("dur", 0) > f["ts"] + f["dur"] + 1e-3:
            raise RuntimeError(f"obs: trace event {e['name']} outside its "
                               "frame's span")
    return len(frames)


def obs_vit_serving(card: str, power: str, phase8=None):
    """14a: phase 8's shared topology at the ViT's width under the whole
    observability layer (see the module doc)."""
    import gc
    import threading

    import torch

    from nnstreamer_tpu_torch import chaos
    from nnstreamer_tpu_torch.chaos import hooks as chaos_hooks
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.obs import LatencyTracer, serve_metrics
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY
    from nnstreamer_tpu_torch.obs.tenantstat import TENANT_STATS
    from nnstreamer_tpu_torch.obs.transfer import LEDGER, params_nbytes
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch

    register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED, **VIT)
    pools, _ = serve_pools()
    on_card = pools[0][0].is_cuda
    alone = run_alone(pools)
    model_bytes = params_nbytes(get_model("vit_serve").params)
    per_frame = vit_flops_per_frame()
    os.environ["NNS_TPU_TORCH_CHAOS"] = OBS_CHAOS
    chaos_hooks._env_checked = False  # read at the next pipeline start
    TENANT_STATS.reset()
    srv = serve_metrics(port=0)
    base = f"http://127.0.0.1:{srv.port}"
    pipes = [parse_launch(SERVE_PIPE.format(
        norm=NORM, model="vit_serve", share="true", batch=64,
        buckets=",".join(map(str, SERVE_BUCKETS)), dec=LABEL_DEC,
        sample=f" stat-sample-interval-ms={OBS_SAMPLE_MS} "
        f"slo-ms={OBS_SLO_MS} tenant={'a' if s < 4 else 'b'}"))
        for s in range(SERVE_STREAMS)]
    tracer = LatencyTracer(sample_every=OBS_TRACE_EVERY)
    scrapes, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            scrapes.append((_http(base, "/metrics"),
                            _http(base, "/snapshot"),
                            _http(base, "/healthz")))
            stop.wait(OBS_SCRAPE_S)

    try:
        for p in pipes:
            p["src"].spec = TensorsSpec.parse(
                f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
            p.start()
        plan = chaos.active_plan()
        if plan is None or plan.seed != 7:
            raise RuntimeError("obs: NNS_TPU_TORCH_CHAOS installed no plan")
        entry = pipes[0]["net"].pool
        label = entry.label()
        if entry.admission is None or entry.admission._hist is None:
            raise RuntimeError("obs: admission does not read the registry")
        kernels.flash_attention.launches = 0
        kernels.scale_bias_cast.launches = 0
        closed_loop(pipes, pools, 0, SERVE_WARMUP, SERVE_DEPTH)
        torch.cuda.synchronize()
        warm_p99 = entry.admission.p99_s
        entry.admission.reset_signal()
        tracer.install()
        LEDGER.clear()
        hist0 = _phase_hists(label)
        REGISTRY.snapshot()  # the MFU join's window starts here
        th = threading.Thread(target=scraper, name="obs-scraper")
        th.start()
        try:
            outs, lats, wall = closed_loop(pipes, pools, SERVE_WARMUP,
                                           SERVE_FRAMES, SERVE_DEPTH)
            torch.cuda.synchronize()
        finally:
            stop.set()
            th.join()
        hist1 = _phase_hists(label)
        timed = ledger_totals()
        timed_rows = LEDGER.snapshot()
        first = SERVE_WARMUP + SERVE_FRAMES
        before = ledger_totals()
        _, prof = profiled_copies(lambda: closed_loop(
            pipes, pools, first, OBS_PROFILED, SERVE_DEPTH))
        copies = _delta(before, ledger_totals())
        after = (_http(base, "/metrics"), _http(base, "/snapshot"),
                 _http(base, "/healthz"))
        gc.collect()
        torch.cuda.synchronize()
        gc.disable()
        try:
            snap = REGISTRY.snapshot()
            stats = torch.cuda.memory_stats(0)
            limit = torch.cuda.mem_get_info(0)[1]
        finally:
            gc.enable()
        launches = {"flash_attention": kernels.flash_attention.launches,
                    "scale_bias_cast": kernels.scale_bias_cast.launches}
        adm_p99 = entry.admission.p99_s
        for p in pipes:
            p["src"].end_of_stream()
        for p in pipes:
            if not p.wait_eos(timeout=120):
                raise RuntimeError("obs: no EOS")
    finally:
        for p in pipes:
            p.stop()
        tracer.uninstall()
        srv.close()
        chaos.uninstall_plan()
        os.environ.pop("NNS_TPU_TORCH_CHAOS", None)
    frames_all = SERVE_STREAMS * (SERVE_WARMUP + SERVE_FRAMES + OBS_PROFILED)
    if on_card and (launches["scale_bias_cast"] < frames_all
                    or launches["flash_attention"] < VIT["depth"]):
        raise RuntimeError(f"obs: launches {launches} for {frames_all} "
                           "frames")
    # every stream's frames back in order, none lost; labels as alone
    labels_checked = 0
    for s, bufs in enumerate(outs):
        if [b.pts for b in bufs] != list(range(SERVE_WARMUP, first)):
            raise RuntimeError(f"obs: stream {s}: pts out of order or lost")
        for b in bufs:
            ref = alone[s][b.pts % SERVE_POOL].reshape(-1)
            top2 = torch.topk(ref, 2).values
            if float(top2[0] - top2[1]) > OBS_MARGIN:
                labels_checked += 1
                if b.meta["label_index"] != int(ref.argmax()):
                    raise RuntimeError(f"obs: stream {s} frame {b.pts}: "
                                       "label differs from the frame alone")
    lats.sort()
    fps = SERVE_STREAMS * SERVE_FRAMES / wall
    p50, p99 = lats[len(lats) // 2] * 1e3, \
        lats[min(int(0.99 * len(lats)), len(lats) - 1)] * 1e3
    # the tracer: residencies partition each record; each at least its
    # window's device time from the window's CUDA events
    recs = tracer.records()
    if len(recs) < SERVE_STREAMS * SERVE_FRAMES // OBS_TRACE_EVERY:
        raise RuntimeError(f"obs: {len(recs)} trace records")
    residency = {}
    for r in recs:
        if abs(sum(r["residency_s"].values()) - r["e2e_s"]) > 1e-9:
            raise RuntimeError("obs: residencies do not sum to e2e")
        dev = r.get("device_window_s")
        if (dev is None and on_card) or \
                (dev is not None and not r["e2e_s"] >= dev > 0):
            raise RuntimeError(f"obs: frame {r['frame']}: e2e {r['e2e_s']} "
                               f"s against its window's device time {dev}")
        for el, t in r["residency_s"].items():
            residency.setdefault(el, []).append(t * 1e3)
    nframes = check_trace_nests(tracer.chrome_trace())
    # the ledger against the profiler's copy rows over the same span
    if copies["DtoH"] != prof["DtoH"] or copies["HtoD"] != prof["HtoD"]:
        raise RuntimeError(f"obs: ledger {copies} against the profiler's "
                           f"copies {prof}")
    timed_frames = SERVE_STREAMS * SERVE_FRAMES
    per_frame_rows = {f"{r['direction']}:{r['reason']}":
                      r["count"] / timed_frames for r in timed_rows}
    # cost: the count at bucket 64 against the hand count, and nns_mfu
    rows = [r for _, sn, _ in scrapes + [after]
            for r in sn["executables"] if r["source"] == "vit_serve"]
    row64 = [r for r in rows if r["bucket"] == 64]
    if not row64:
        raise RuntimeError("obs: no bucket-64 program captured")
    flops64 = row64[-1]["flops"]
    if abs(flops64 - 64 * per_frame) > OBS_FLOPS_TOL * 64 * per_frame:
        raise RuntimeError(f"obs: nns_executable_flops at bucket 64 "
                           f"{flops64} against {64 * per_frame} by hand")
    mfu, hbm = {}, {}
    for r in rows:
        if "mfu" in r:
            if not 0 < r["mfu"] <= OBS_MFU_MAX:
                raise RuntimeError(f"obs: nns_mfu {r['mfu']} at bucket "
                                   f"{r['bucket']}")
            mfu.setdefault(r["bucket"], []).append(r["mfu"])
            hbm.setdefault(r["bucket"], []).append(r.get("hbm_bw_util", 0))
    if 64 not in mfu:
        raise RuntimeError("obs: no nns_mfu reading at bucket 64")
    # the tenant split
    t_ns, p_ns = TENANT_STATS.exactness(label)
    trows = {r["tenant"]: r for r in TENANT_STATS.snapshot()
             if r["pool"] == label}
    fa, fb = trows["a"]["frames"], trows["b"]["frames"]
    if t_ns != p_ns or p_ns <= 0 or abs(fa - fb) / 2 > 64:
        raise RuntimeError(f"obs: tenant split {t_ns} vs {p_ns}, frames "
                           f"a {fa} b {fb}")
    # chaos: the exported counter is the plan's count, the sleeps add up
    k = plan.counts().get("slow-invoke", 0)
    exported = _metric(after[0], "nns_chaos_injected_total",
                       fault="slow-invoke")
    if exported != k or plan.counts().keys() - {"slow-invoke"}:
        raise RuntimeError(f"obs: nns_chaos_injected_total {exported} "
                           f"against plan.counts() {plan.counts()}")
    slept = entry.chaos_sleep_s
    if abs(slept - k * OBS_SLOW_S) > 1e-9:
        raise RuntimeError(f"obs: {k} slow-invokes injected {slept} s of "
                           "sleep")
    # device memory and the pooled weights
    (mem,) = [r for r in snap["device_memory"] if r["device"] == "cuda:0"]
    if (mem["in_use"], mem["peak"], mem["limit"]) != (
            stats["allocated_bytes.all.current"],
            stats["allocated_bytes.all.peak"], limit):
        raise RuntimeError(f"obs: device memory {mem} against memory_stats")
    (prow,) = [r for r in snap["pools"] if r["pool"] == label]
    if prow["weights"]["bytes"] != model_bytes or _metric(
            after[0], "nns_model_weight_bytes", pool=label) != model_bytes:
        raise RuntimeError(f"obs: weights {prow['weights']} against "
                           f"{model_bytes} bytes of parameters")
    if after[2]["status"] != "ok" or not after[2]["device_memory"]:
        raise RuntimeError(f"obs: /healthz {after[2]}")
    d = {ph: (hist1[ph][0] - hist0[ph][0]) / max(hist1[ph][1] - hist0[ph][1],
                                                 1) * 1e3
         for ph in hist1}
    res = {
        "frames_per_s": fps, "p50_ms": p50, "p99_ms": p99,
        "labels_checked": labels_checked, "trace_records": len(recs),
        "trace_frames": nframes,
        "residency_p50_ms": {el: statistics.median(v)
                             for el, v in residency.items()},
        "e2e_p50_ms": statistics.median(r["e2e_s"] for r in recs) * 1e3,
        "device_window_p50_ms": statistics.median(
            r.get("device_window_s", 0.0) for r in recs) * 1e3,
        "phase_ms": d, "flops_bucket64": flops64,
        "flops_bucket64_by_hand": 64 * per_frame,
        "mfu_by_bucket": {b: statistics.median(v) for b, v in mfu.items()},
        "hbm_bw_util_by_bucket": {b: statistics.median(v)
                                  for b, v in hbm.items()},
        "crossings_per_frame": per_frame_rows,
        "profiled_copies": prof, "slow_invokes": k, "slept_s": slept,
        "tenant_frames": {"a": fa, "b": fb}, "tenant_device_ns": p_ns,
        "device_memory": mem, "weight_bytes": model_bytes,
        "scrapes": len(scrapes), "launches": launches,
        "warmup_admission_p99_ms": warm_p99 * 1e3,
        "admission_p99_ms": adm_p99 * 1e3}
    ref = "" if phase8 is None else (
        f" (phase 8 shared leg: {phase8['frames_per_s']:.1f} frames/s, "
        f"p50 {phase8['p50_ms']:.3f} ms, p99 {phase8['p99_ms']:.3f} ms)")
    print(f"obs (a) ViT serving under observation: {fps:.1f} frames/s, "
          f"push->pull p50 {p50:.3f} ms p99 {p99:.3f} ms{ref}; "
          f"{labels_checked} labels (top-2 margin > {OBS_MARGIN}) equal to "
          f"alone; {len(recs)} traced frames (1 in {OBS_TRACE_EVERY}), "
          f"residencies summing to e2e, e2e p50 "
          f"{res['e2e_p50_ms']:.3f} ms >= its window's device time (p50 "
          f"{res['device_window_p50_ms']:.3f} ms); {len(scrapes)} scrapes "
          f"of /metrics, /snapshot and /healthz; admission p99 from the "
          f"registry {res['admission_p99_ms']:.3f} ms (warm-up "
          f"{res['warmup_admission_p99_ms']:.3f} ms, then reset) "
          f"[{card}, {power}]", flush=True)
    print("obs (a) residency p50 ms by element: " + ", ".join(
        f"{el} {v:.3f}" for el, v in res["residency_p50_ms"].items()),
        flush=True)
    print(f"obs (a) pool dispatch from the registry histograms: host prep "
          f"{d['prep']:.3f} ms, device {d['device']:.3f} ms, host drain "
          f"{d['drain']:.3f} ms (means of the sampled dispatches)",
          flush=True)
    print(f"obs (a) cost: nns_executable_flops at bucket 64 {flops64:.6g} "
          f"against {64 * per_frame:.6g} by hand; nns_mfu by bucket "
          f"{res['mfu_by_bucket']}, nns_hbm_bw_util (a lower bound) "
          f"{res['hbm_bw_util_by_bucket']} [{card}, {power}]", flush=True)
    print(f"obs (a) crossings per frame {per_frame_rows}; over the profiled "
          f"span ledger {copies} = profiler {prof}; tenants a {fa} b {fb} "
          f"frames, device split exact ({p_ns} ns); {k} slow-invokes "
          f"injected = nns_chaos_injected_total, {slept:.6f} s of sleep; "
          f"device memory {mem}; pooled weights {model_bytes} bytes",
          flush=True)
    return res


def _composite_p50(desc: str, frames, n: int):
    _, bufs, _ = run_pipeline(desc, frames, n)
    return window_times(bufs, BATCH)


def obs_detect_child() -> int:
    """``--obs-detect-child``: phase 4's pipeline, OBS_WINDOWS windows, in
    this process (run with NNS_TPU_TORCH_OBS_DISABLE=1 by 14b); prints
    its frames/s and p50 window as one JSON line."""
    import torch

    from nnstreamer_tpu_torch.obs import hooks

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    frames = obs_detector()
    _composite_p50(composite("ssd_obs", "cuda", 2), frames, 2)
    fps, p50 = _composite_p50(composite("ssd_obs", "cuda", OBS_WINDOWS),
                              frames, OBS_WINDOWS)
    print(json.dumps({"obs_disabled": hooks.DISABLED, "fps": fps,
                      "p50_window_ms": p50}))
    return 0


def obs_detector():
    """Phase 4's detector as ``ssd_obs`` and its frame batches."""
    import torch

    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        ssd_mobilenet_v2_init,
        weights_to_bf16,
    )

    tree = ssd_mobilenet_v2_init(SEED, NUM_CLASSES)
    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    register_detector("ssd_obs", ssd_from_jax(weights_to_bf16(tree)),
                      anchors, BATCH, torch.bfloat16)
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(POOL)]


def conv_flops(fn, *args) -> int:
    """The FLOPs of every ``F.conv2d`` call ``fn(*args)`` makes, by hand:
    2 · output elements · (input channels a group) · kh · kw."""
    import torch.nn.functional as F

    conv, total = F.conv2d, [0]

    def counting(x, w, *a, **kw):
        y = conv(x, w, *a, **kw)
        total[0] += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    F.conv2d = counting
    try:
        fn(*args)
    finally:
        F.conv2d = conv
    return total[0]


def obs_detection(card: str, power: str):
    """14b: phase 4's detection pipeline, passive obs against the kill
    switch, its crossings, its cost, and a black box (see the module
    doc)."""
    import glob
    import shutil

    import torch

    from nnstreamer_tpu_torch.chaos import ChaosInvokeError
    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.obs import flightrec
    from nnstreamer_tpu_torch.obs.flightrec import FLIGHT
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY
    from nnstreamer_tpu_torch.obs.transfer import LEDGER
    from nnstreamer_tpu_torch.obs.xlacost import XLA_COST
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    frames = obs_detector()
    desc = composite("ssd_obs", "cuda", OBS_WINDOWS)
    _composite_p50(composite("ssd_obs", "cuda", 2), frames, 2)  # warm
    env = dict(os.environ, NNS_TPU_TORCH_OBS_DISABLE="1")
    passive, disabled, mfu = [], [], []
    kernels.scale_bias_cast.launches = 0
    for _ in range(2):  # A B A B
        REGISTRY.snapshot()  # the MFU join's window starts here
        passive.append(_composite_p50(desc, frames, OBS_WINDOWS))
        mfu += [r["mfu"] for r in REGISTRY.snapshot()["executables"]
                if r["source"] == "ssd_obs" and "mfu" in r]
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--obs-detect-child"], capture_output=True, text=True,
            timeout=600, env=env, cwd=HERE)
        if out.returncode != 0:
            raise RuntimeError(f"obs: the kill-switch run failed:\n"
                               f"{out.stderr[-4000:]}")
        child = json.loads(out.stdout.strip().splitlines()[-1])
        if child["obs_disabled"] is not True:
            raise RuntimeError("obs: the child ran with obs on")
        disabled.append((child["fps"], child["p50_window_ms"]))
    launches = kernels.scale_bias_cast.launches
    if launches < 2 * OBS_WINDOWS:
        raise RuntimeError(f"obs (b): scale_bias_cast launched {launches} "
                           f"times for {2 * OBS_WINDOWS} windows")
    p_on = statistics.mean(p for _, p in passive)
    p_off = statistics.mean(p for _, p in disabled)
    overhead = (p_on - p_off) / p_off
    if overhead > OBS_PASSIVE_TOL:
        raise RuntimeError(f"obs (b): passive metrics cost {overhead:.4f} "
                           f"of the p50 window ({p_on:.3f} ms against "
                           f"{p_off:.3f} ms with the kill switch)")
    if not mfu or not all(0 < m <= OBS_MFU_MAX for m in mfu):
        raise RuntimeError(f"obs (b): nns_mfu {mfu}")
    # crossings: the ledger against the profiler over one run
    LEDGER.clear()
    _, prof = profiled_copies(lambda: run_pipeline(desc, frames,
                                                   OBS_WINDOWS))
    got = ledger_totals()
    if got != prof:
        raise RuntimeError(f"obs (b): ledger {got} against the profiler's "
                           f"copies {prof}")
    rows = LEDGER.snapshot()
    staged = [r for r in rows if r["source"] == "src"]
    windows = [r for r in rows if r["source"] != "src"]
    # cost: the counted program against a hand count of its convolutions
    flops = XLA_COST.get("ssd_obs", 0)["flops"]
    fn = get_model("ssd_obs").flat_fn(torch.device(OBS_DEVICE))
    x = torch.zeros((BATCH, SIZE, SIZE, 3), device=OBS_DEVICE)
    with torch.inference_mode():
        hand = conv_flops(fn, x)
    prologue = 2 * BATCH * SIZE * SIZE * 3
    # the steady windows' utilization, from the count and the p50 window
    # (the gauge reads the one sampled dispatch: each pipeline's first)
    mfu_p50 = flops / (p_on / 1e3) / card_spec(card).peak_flops \
        if OBS_DEVICE == "cuda" else 0.0
    # the black box: a fail-invoke through the filter's chaos= property
    frdir = os.path.join(HERE, "build", "obs_flightrec")
    shutil.rmtree(frdir, ignore_errors=True)
    os.environ[flightrec.DIR_ENV] = frdir
    flightrec._env_checked = False  # read at the next pipeline start
    FLIGHT.clear()
    p = parse_launch(composite("ssd_obs", "cuda", 4))
    p["src"].frames = frames
    p["src"].pool_size = len(frames)
    p["net"].set_property("chaos", OBS_FAIL)
    try:
        p.start()
        ended = p.wait_eos(timeout=300, raise_on_error=False)
        err = p.error
    finally:
        p.stop()
        os.environ.pop(flightrec.DIR_ENV, None)
    if ended or err is None or not isinstance(err.error, ChaosInvokeError):
        raise RuntimeError(f"obs (b): the injected failure was not "
                           f"reported: {err}")
    deadline = time.monotonic() + 30
    while not FLIGHT.dumps and time.monotonic() < deadline:
        time.sleep(0.05)
    FLIGHT.disarm()
    if not FLIGHT.dumps:
        raise RuntimeError("obs (b): the flight recorder wrote no dump")
    trace_path, snap_path = FLIGHT.dumps[0]
    with open(trace_path) as f:
        marks = [e["name"] for e in json.load(f)["traceEvents"]]
    if "error:net" not in marks:
        raise RuntimeError(f"obs (b): the dumped trace lacks the error: "
                           f"{marks}")
    with open(snap_path) as f:
        dumped = json.load(f)
    injected = sum(
        s["value"] for s in dumped["snapshot"]["metrics"][
            "nns_chaos_injected_total"]["samples"]
        if s["labels"]["fault"] == "fail-invoke")
    if injected != 1:
        raise RuntimeError(f"obs (b): the dump counts {injected} injected "
                           "failures")
    res = {"passive": passive, "disabled": disabled,
           "passive_overhead": overhead, "mfu": mfu, "flops": flops,
           "conv_flops_by_hand": hand, "prologue_flops": prologue,
           "mfu_at_p50_window": mfu_p50,
           "copies": prof, "staged": staged, "window_crossings": windows,
           "launches": launches,
           "flightrec": [os.path.basename(trace_path),
                         os.path.basename(snap_path)],
           "error": f"{type(err.error).__name__}: {err.error}"}
    print(f"obs (b) detection, passive obs against the kill switch (A B A "
          f"B, {OBS_WINDOWS} windows each): p50 window "
          f"{[round(p, 3) for _, p in passive]} against "
          f"{[round(p, 3) for _, p in disabled]} ms, frames/s "
          f"{[round(f, 1) for f, _ in passive]} against "
          f"{[round(f, 1) for f, _ in disabled]}: passive cost "
          f"{overhead:+.4f} of the p50 window (bound {OBS_PASSIVE_TOL}) "
          f"[{card}, {power}]", flush=True)
    print(f"obs (b) crossings: ledger = profiler {prof}; staging "
          f"{[(r['direction'], r['count'], r['bytes']) for r in staged]}; "
          f"between source and sink once staged "
          f"{[(r['source'], r['direction'], r['reason'], r['count'])
              for r in windows]}", flush=True)
    print(f"obs (b) cost: nns_executable_flops {flops:.6g} a window against "
          f"{hand:.6g} of convolutions by hand + {prologue:.6g} of the "
          f"prologue; nns_mfu {[round(m, 4) for m in mfu]} (each run's "
          f"first window, the one sampled); at the p50 window "
          f"{mfu_p50:.4f} [{card}, {power}]", flush=True)
    print(f"obs (b) flight recorder: {res['error']} on the bus, dump "
          f"{res['flightrec']} loads, nns_chaos_injected_total "
          f"fail-invoke = {injected}", flush=True)
    return res


def phase_obs(card: str, power: str, phase8=None):
    """Phase 14 (see the module doc)."""
    t0 = time.perf_counter()
    out = {"vit_serving": obs_vit_serving(card, power, phase8),
           "detection": obs_detection(card, power)}
    print(f"obs phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels-per-forward":
        return count_forward_kernels(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--serving-legs":
        return serving_legs(sys.argv[2])
    if sys.argv[1:] == ["--obs-detect-child"]:
        return obs_detect_child()
    alone = sys.argv[1:] == ["--decoders"]
    elements_alone = sys.argv[1:] == ["--elements"]
    obs_alone = sys.argv[1:] == ["--obs"]
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

    if alone:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        print(json.dumps({"decoders": phase_decoders(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if elements_alone:
        print(json.dumps({"elements": phase_elements(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if obs_alone:
        print(json.dumps({"obs": phase_obs(card, power),
                          "card": card, "power_limit": power}))
        return 0
    worst, (ms, plain_ms, bound_ms) = phase_kernels(card, power)
    fa_worst, fa = phase_flash_attention(card, power)
    main_path = phase_main_path(card, power)
    phase_profile(composite("ssd_mobilenet_v2", "cuda", 3),
                  main_path.pop("frames"), card, power)
    phase_reference(main_path.pop("model"), main_path.pop("anchors"))
    vit_path = phase_vit(card, power)
    serving = phase_serving(card, power)
    lifecycle = phase_lifecycle(card, power)
    classify = phase_classify(card, power)
    yolo = phase_yolo(card, power)
    decoders = phase_decoders(card, power)
    elements = phase_elements(card, power)
    obs = phase_obs(card, power, serving["shared"])

    print(json.dumps({"main_path": main_path, "vit_path": vit_path,
                      "serving": serving, "lifecycle": lifecycle,
                      "classify": classify, "yolo": yolo,
                      "decoders": decoders, "elements": elements,
                      "obs": obs, "card": card, "power_limit": power}))
    served = serving["launches"]
    sbc_by_path = {"detection": main_path["launches"],
                   "vit": vit_path["scale_bias_cast_launches"],
                   "serving_shared": served["shared"]["scale_bias_cast"],
                   "serving_unshared": served["unshared"]["scale_bias_cast"],
                   "lifecycle": lifecycle["launches"]["scale_bias_cast"],
                   "classify": classify["v1"]["launches"],
                   "classify_v2": classify["v2"]["launches"],
                   "yolo": yolo["launches"],
                   "yolo_raw": yolo["raw"]["launches"],
                   "cascade": decoders["cascade"]["launches"],
                   "labeled_overlay": decoders["labeled"]["launches"],
                   "elements_classify": elements["classify"]["launches"],
                   "elements_gated": elements["gated"]["launches"],
                   "elements_two_cameras":
                       elements["two_cameras"]["launches"],
                   "obs_vit_serving": obs["vit_serving"]["launches"][
                       "scale_bias_cast"],
                   "obs_detection": obs["detection"]["launches"]}
    fa_by_path = {"vit": vit_path["flash_launches"],
                  "serving_shared": served["shared"]["flash_attention"],
                  "serving_unshared": served["unshared"]["flash_attention"],
                  "lifecycle": lifecycle["launches"]["flash_attention"],
                  "obs_vit_serving": obs["vit_serving"]["launches"][
                      "flash_attention"]}
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
