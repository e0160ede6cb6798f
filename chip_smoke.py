#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-per-forward DIR   # one count, see below
    python3 chip_smoke.py --serving-legs DIR          # phase 8's legs only
    python3 chip_smoke.py --decoders                  # build + phase 12 only
    python3 chip_smoke.py --elements                  # build + phase 13 only
    python3 chip_smoke.py --obs                       # build + phase 14 only
    python3 chip_smoke.py --control                   # build + phase 15 only
    python3 chip_smoke.py --repairs                   # build + phase 16 only
    python3 chip_smoke.py --edge                      # build + phase 17 only
    python3 chip_smoke.py --mqtt                      # build + phase 18 only
    python3 chip_smoke.py --parallel                  # build + phase 19 only
    python3 chip_smoke.py --training                  # build + phase 20 only

It drives the port's paths — the composite detection pipeline, the ViT
classification pipeline, shared-model serving at the ViT's width, the
model lifecycle of that pool (hot swap, canary, the kernel cache),
MobileNet classification, YOLO detection, the decoders with the
detect → tensor_region → tensor_crop cascade, and the stream elements
(aggregated camera frames into a TorchScript classifier, a gated camera,
two cameras in one window), the observability layer on the serving
and detection paths, and the active layer (host profiler, watchdog,
controller, lock witness, ``nns-top``) on the serving path, and the
repaired elements with the static analyzer against all of them, and the
edge layer (query offload across processes and within one, the pooled
ViT served to several clients, pub/sub), and MQTT (a camera in another
process fed to the SSD through a broker, the pooled ViT found through the
broker and moved mid-run, the gRPC bridge) — through ``parse_launch`` at
full width.
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
15. the active layer on phase 8's shared topology at the ViT's width
   (8 closed-loop streams, ``share-model=true batch=64
   batch-timeout-ms=2 batch-buckets=8,16,32,64``, each pipeline named so
   the profiler's accounts stay apart).  (a) The host profiler: the
   element threads under their ``nns:<pipeline>:<element>`` names in the
   thread registry; a leg with the sampler at 47 Hz: the accounts' CPU
   at most the process's CPU delta (+2%), every card wait on the wait
   side (the sink's fence, the label's drain, the sampled dispatch's
   synchronize all go through ``card_wait``), the pool's dispatch cycle
   split into CPU, card wait and neither, and one more element loop (a
   queue before the card transform and an appsink, whose fence waits on
   every frame) with card wait in its account, on the wait side, so the
   gate never rests on a window happening to fill on an element thread
   and dispatch inline there; three interleaved off/on pairs
   for the sampler's overhead, printed beside the JAX package's 3% bound
   as a reading; an alert (a threshold rule on the pool's frames) starts
   a deep capture whose ``torch.profiler`` trace must hold both kernels'
   device rows, while eight open-loop cameras at ``CAMERA_FPS`` keep
   pushing (every frame back, in order; the gate's holds printed).
   (b) The JAX package's three pool scripts of bench_mttr on the ViT
   (their rules, playbooks, chaos plans and 50 ms watch and control
   intervals; 2 or 3 streams, windows of 8, 8 and 16): each
   rig's capacity measured in a closed loop, then open-loop pumps at 0.6
   of it, which run the JAX script's settle (1.0, 1.0 and 1.5 s) before
   the watch attaches; gates: detected, actuated and recovered (held
   0.5 s), no alert before the fault (an alert that does fire is printed
   with its age and detail), the audit ring equal to
   ``nns_control_actions_total``, every stream's pts in order, none lost
   but the frames admission shed.  Then its fourth script,
   ``breaker-stuck``: an ``edgesink`` publisher's pipeline dies, the
   ``edgesrc`` subscriber's re-dial loop fails until its breaker opens
   (3 failures, an 8 s open window), the publisher is back at +1 s, and
   the ``redial-link`` playbook on the ``breaker-open`` rule forces the
   half-open probe: recovered (breaker closed, frames flowing) before the
   open window ends.
   (c) The default rule pack over the shared leg with no fault, as long
   as the longest script's watched span (at most 12 s): the alerts that
   fired (false positives) and the forecasts table; the ``forecasts``
   and alert sections present while the watch runs, and empty in a child
   under ``NNS_TPU_TORCH_OBS_DISABLE=1`` (``--control-disabled-child``).
   (d) The shared leg in a child under ``NNS_TPU_TORCH_LOCKDEP=1``
   (``--control-lockdep-child``): no lock-order cycle, no lock held
   across a dispatch but the marked flush lock.  (e) ``nns-top --once
   --json`` against ``serve_metrics`` while slo-burn fires: a row for
   every element and the pool, and slo-burn firing in ALERTS.  15a's
   deep capture runs under the default rule pack plus bench_mttr's
   pool-stall, its trigger after ``CTL_BASELINE_S`` of traffic: the
   alerts that fire from the trigger to one ``for=`` window after the
   capture's last hold are printed;
16. repairs and the analyzer: (a) phase 4's SSD path with the host
   ``bounding_boxes`` decoder behind ``queue prefetch-host=`` (false and
   true in turns, ``PREFETCH_WINDOWS`` windows each): the sink bytes of
   every run equal; with the prefetch, the transfer ledger shows each
   of the filter's four outputs crossing once a window at the queue
   (reason ``prefetch``) and nothing at the decoder, without it the
   decoder's packed drain crossing once a window, the same bytes; a
   torch.profiler window of the prefetch run shows the device→host copies
   on a stream other than the one the filter's kernels ran on, and the
   card's busy share; the p50 window (host, sink arrivals) of each
   setting.  (b) ``FilterSingle`` on phase 7's ViT (``vit_b64``): its
   logits for window 0's normalized frames against the pipeline's within
   phase 7's bf16 tolerance (5e-2), ``flash_attention`` launched depth
   times per invoke, the p50 of its ``InvokeStats``.  (c) ``to_dot`` of
   the running 16a pipeline: every link with negotiated caps.  (d)
   ``analyze_description`` over every distinct description this process
   passed to ``parse_launch`` in phases 4–16 (recorded as they ran):
   no error; the warnings and info counted; the static corpus
   (``chip_smoke.py``'s literals and the element-doc examples) clean;
   ``--self --concurrency --strict`` over the port exits 0; neither
   kernel's launch counter moves across the lint.  (e) ``nns-torch-lint``
   and ``nnstreamer-tpu-torch-check --json`` in children: the check
   lists the card;
17. the edge layer on the card.  (a) Detection offload across processes:
   a child process (``--edge-server-child``) serves ``tensor_query_serversrc
   connect-type=tcp ! tensor_transform backend=cuda ! tensor_filter``
   SSD-MobileNetV2 at batch 1 (300x300, 91 classes, bf16-resident) ``!
   tensor_query_serversink``; here ``appsrc ! tensor_query_client
   max-request=8 ! appsink`` offloads 256 uint8 1×300×300×3 frames staged
   on the card in a closed loop of 8 in flight (a free-running source
   against ``max-request=8`` drops by design): frames/s, the RTT from the
   client's ``LinkMetrics`` (bucket bounds and mean), the link's tx/rx
   bytes equal to the frames re-packed, crossings per frame on each side
   from the transfer ledgers; gates: bytes exact, every frame back in
   order, none dropped or timed out, boxes, classes and counts equal to
   the same frames through the local pipeline and scores within 1e-5.
   (b) The device channel in one process: the same server at batch 256
   (69.12 MB frames) in this process over ``connect-type=tcp``, 12 frames
   with ``device-channel=true`` then ``false``: with it no crossing
   (0.0 a frame) and every deposit taken, none evicted; without it one
   d2h a tensor a hop and one h2d a frame; outputs byte-equal; each run's
   p50 gap between results; one host read of a card tensor crosses once
   (``tobytes()`` then ``np()``, and the reverse).  (c) The pooled ViT
   served to 4 clients over TCP (``device-channel=false``): the server
   ``tensor_query_serversrc ! tensor_transform backend=cuda !
   tensor_filter`` ViT ``share-model=true batch=64 batch-timeout-ms=2
   batch-buckets=8,16,32,64 ! tensor_decoder mode=image_labeling !
   tensor_query_serversink``; every reply routed to the client that
   sent it, in order (by ``client_id`` at the server), each label equal
   to the frame alone's where its top-2 margin exceeds 1e-4; frames/s
   per client and in all, windows by bucket, ``flash_attention``
   launches.  (d) Pub/sub: ``edgesink`` publishes card frames on a topic
   under a ``LatencyTracer``; two ``edgesrc`` subscribers on it get
   every frame in order, byte-equal, one of them learning the caps from
   the publisher; a third on another topic gets none; every subscriber
   record carries the publisher's marks as a one-way remote entry; each
   frame leaves the card once for both subscribers;
18. MQTT on the card.  (a) A camera fed over MQTT to the SSD: a child
   process (``--mqtt-pub-child``) stages 256 uint8 1×300×300×3 frames on
   the card from a seeded ``torch.Generator`` and runs ``appsrc !
   mqttsink pub-topic=cam`` against the port's ``MiniBroker`` here;
   ``mqttsrc sub-topic=cam ! tensor_transform backend=cuda !
   tensor_filter`` SSD-MobileNetV2 at batch 1 (bf16-resident) ``!
   tensor_decoder mode=bounding_boxes … option7=device ! appsink`` and a
   second ``mqttsrc`` on ``cam`` into a host ``appsink`` subscribe: every
   frame arrives at both in order, the overlays equal the same frames
   through the local pipeline, the host subscriber's bytes the published
   ones; one d2h a frame at the publisher and one h2d a frame at the SSD
   (the transfer ledgers); the broker's payload bytes equal the packed
   messages (in once, out twice).  It runs twice: the child publishing
   as fast as it can, for frames/s, then paced at ``CAMERA_FPS`` (below
   the SSD's rate), for the p50/p99 of ``mqttsrc``'s ``last_latency_us``
   (unpaced, that number is the subscriber's backlog).  (b) The pooled ViT of 17c behind
   ``tensor_query_serversrc connect-type=hybrid`` (topic ``vit`` at the
   broker), 4 ``connect-type=hybrid`` clients with 8 frames in flight:
   32 frames each, the server stops, a replacement registers the topic on
   a new data port, 32 more each: every frame answered, each half by its
   own server, labels equal to the frame alone's where the top-2 margin
   exceeds 1e-4, the retained address cleared after the last stop;
   frames/s and the seconds from the stop to the replacement's first
   answer.  (c) Where ``import grpc`` succeeds, two SSD windows at batch
   256 through ``tensor_sink_grpc server=true idl=protobuf`` →
   ``tensor_src_grpc`` byte-equal to local; where it fails, one line
   saying so and nothing counted as held;
19. the parallel layer (``nnstreamer_tpu_torch/parallel/``).  (a) Phase
   8's shared ViT topology with ``mesh=data:-1`` (``data:1`` on one
   card): every frame's logits equal to the unmeshed pool's within 1e-4,
   labels equal wherever the top-2 margin exceeds 1e-4, frames/s beside
   phase 8's shared leg of the same call, ``flash_attention`` 6 times a
   forward and the meshstat row at 1 shard, imbalance 0.0 and no pad on
   a full window.  (b) Virtual shards on one card (8 device records over
   ``cuda:0``, ``parallel.mesh.set_virtual_devices``; correctness only, no
   scaling claimed): the ViT pool at ``mesh=data:4`` and ``data:8``
   against the unmeshed logits within 5e-2, a window of 60 frames in a
   64 bucket launching the attention once a layer per shard and meshstat
   splitting it as ``shard_split``; phase 4's SSD at batch 256 behind the
   fused normalize at ``mesh=data:4`` and ``mesh=data:2,model:2
   sharding=tp`` — ``scale_bias_cast`` once per data shard, raw heads at
   bf16 within 5e-2 and detections at f32 (TF32 off) equal to the
   unsharded run's.  (c) The JAX package's ``bench_cascade`` topology on
   those records (detector ``devices=0-3`` → ``tensor_crop`` →
   ``tensor_if offload=then`` → classifier ``devices=4-7``) against the
   single-stage run: offload ratio exactly 1/2, the stage boundary's
   crossings per frame exactly 0.0 (the split run's ledger beyond the
   single-stage run's), the ``d2d``/``handoff`` row byte-exact, outputs
   equal frame for frame.  (d) A one-rank NCCL world through
   ``multihost.initialize``: the five collectives on CUDA tensors over a
   ``replica`` (dcn) x ``data`` mesh against their one-device meaning,
   and the pool at ``mesh=dcn.data:1,data:-1``; the two-rank world runs
   only in the CPU tests (gloo).  (e) The analyzer over phase 19's
   descriptions: 0 errors;
20. in-pipeline training (``nnstreamer_tpu_torch/trainers/``,
   ``tensor_trainer``).  (a) MobileNetV1 at full width (1.0, 224x224x3
   uint8 samples, 1001 classes, bf16 compute on f32 leaves) trained from
   seed 0 on 1024 seeded samples that ``datareposink`` wrote: ``datareposrc
   epochs=2 ! tensor_demux`` → the image through ``tensor_transform
   backend=cuda`` (the normalize kernel; a transform converts every
   tensor of a buffer, so the int32 label goes round it) → ``tensor_mux``
   → ``tensor_trainer framework=torch-optim`` (sgd, lr 1e-2, batch 128,
   ``mesh=data:-1``, i.e. ``data:1``) → ``appsink``: 16 steps, each loss
   finite, 2 epoch events and 1 completion, 2048 (1,5) float64 status
   buffers, ``scale_bias_cast`` once a sample and ``flash_attention``
   never; it prints the step time p50/p90 split into forward, backward
   and update (CUDA events), samples/s over an epoch, the device busy
   share and top rows over a 3-step ``torch.profiler`` window, the peak
   card memory and each epoch's loss; then the same step again alone on
   one batch already on the card (no data path beside it); the kernel
   against its plain version at the path's shape; the saved ``.pkl`` through
   ``FilterSingle`` bit-equal to ``mobilenet_v1_tree_apply`` of its tree.
   (b) Three ``train_step`` steps of sgd, adam and adamw on the card
   against the CPU (width 0.25, 32x32, batch 16, f32, TF32 off, lr
   1e-4): the first loss within rtol 1e-4, the later ones 5e-3, leaves
   within 20·lr (ReLU6 elements at a clip boundary flip between the two
   devices' roundings: ``tests/test_torch_training.py``); the share of
   leaf entries within 1e-6 and the largest bf16 loss difference
   printed.  (c) ``tests/test_training.py``'s
   learnable toy on the card: the epoch losses fall.  (d) (a)'s tree as
   step 16 of a checkpoint root (``save_step``), staged as ``root@latest``
   into a share-model MobileNetV1 pool serving the untrained tree and
   committed: version tag ``16``, every frame after the flip with the
   trained model's label (logits within 1e-4 of it alone); the staging
   seconds and the flip stall printed.  (e) Both kernels' wrappers refuse
   a card input that requires grad and launch under ``no_grad``.  (f) The
   analyzer over phase 20's descriptions: 0 errors;
21. prints a ``{"kernels": [...]}`` line, then, last, the ``ok`` line.

Without a usable card it exits non-zero and prints no result.

``--kernels-per-forward DIR`` runs nothing but one full-width ViT forward
with the port found in the checkout DIR and prints how many CUDA kernels
it queued: the same count phase 7 prints, for another tree on the same
card.  ``--serving-legs DIR`` runs nothing but phase 8's shared and
unshared legs with the port in DIR: run it for two trees in one call, in
the order parent, change, change, parent, to compare them.
``--decoders`` builds the kernels and runs phase 12 alone (no ``ok``
line); ``--elements``, ``--obs``, ``--control``, ``--repairs``,
``--edge``, ``--mqtt``, ``--parallel`` and ``--training`` do the same
for phases 13, 14, 15, 16, 17, 18, 19 and 20 (phase 16 alone analyzes
only its own descriptions).
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
               decoder: bool = True, every_dispatch: bool = False,
               mesh: str = "") -> str:
    """The serving pipeline; ``every_dispatch`` times every dispatch
    (stat-sample-interval-ms=0: it waits for the card each window);
    ``mesh`` places the filter on a mesh (phase 19)."""
    return SERVE_PIPE.format(
        norm=NORM, model=model, share=str(share).lower(), batch=batch,
        buckets=buckets, dec=LABEL_DEC if decoder else "",
        sample=(" stat-sample-interval-ms=0" if every_dispatch else "")
        + (f" mesh={mesh}" if mesh else ""))


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
              profile: bool = False, mesh: str = ""):
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
        (", profiled" if profile else "") + (f", mesh={mesh}" if mesh else "")
    pipes = [parse_launch(serve_pipe("vit_serve", share, decoder=decoder,
                                     every_dispatch=profile, mesh=mesh))
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


def serve_pools(n: int = SERVE_STREAMS, device: str = "cuda"):
    """Each of ``n`` streams' SERVE_POOL distinct uint8 frames, staged on
    ``device``, and the generator that drew them (seeded: phases 8, 14
    and 15 draw the same frames)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 4)
    pools = [[torch.randint(0, 256, (1, VIT_SIZE, VIT_SIZE, 3), generator=g,
                            dtype=torch.uint8).to(device)
              for _ in range(SERVE_POOL)] for _ in range(n)]
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


# -- phase 15: the active layer (profiler, watchdog, controller, lockdep) ----

#: phase 15's device; its logic also runs on "cpu" at a small width (with
#: VIT/VIT_SIZE shrunk), as a dry run before a call to the card
CTL_DEVICE = "cuda"
CTL_PROF_HZ = 47.0          # the JAX package's sampler rate
CTL_FRAMES = 96             # frames per stream, the profiled leg
CTL_AB_PAIRS = 3            # interleaved sampler off/on pairs
CTL_AB_FRAMES = 48          # frames per stream, each A/B leg
CTL_AB_BOUND = 0.03         # the JAX package's overhead bound (a reading)
CTL_DEEP_S = 0.3            # the deep capture's episode
CTL_INTERVAL_S = 0.05       # watch and control intervals (bench_mttr's)
CTL_LOAD_SHARE = 0.6        # offered rate / the window's capacity
CTL_CHAOS_SEED = 20260803   # the JAX bench's CHAOS_SEED
CTL_DETECT_S = 20.0         # bench_mttr's detect and recover deadlines
CTL_RECOVER_S = 30.0
CTL_HOLD_S = 0.5            # recovery must hold this long
CTL_CLEAN_MAX_S = 12.0      # the clean leg: the scripts' span, capped
CTL_BASELINE_S = 3.0        # open-loop traffic before the deep capture
CTL_FENCE_FRAMES = 32       # frames through the fenced element loop


def _ctl_sync() -> None:
    import torch

    if CTL_DEVICE == "cuda":
        torch.cuda.synchronize()


def _ctl_card_gate(ok: bool, failure: str, what: str) -> None:
    """A gate that only the card can pass (card waits, device rows,
    kernel launches): raise ``failure`` on the card; on the CPU dry run
    say that the gate was skipped."""
    if CTL_DEVICE != "cuda":
        print(f"control dry run on {CTL_DEVICE}: skipped the card-only "
              f"gate: {what}", flush=True)
    elif not ok:
        raise RuntimeError(failure)


def ctl_open_loop(pipes, pools, first_pts: int, stop, fps: float):
    """Each pipeline gets a camera that pushes a frame of its pool every
    ``1/fps`` s, never waiting for results, and a reader that pulls
    them, until ``stop`` is set; then every result is pulled.  Raises
    unless each stream's results come back complete and in pts order.
    Returns the frames sent per stream."""
    import threading

    from nnstreamer_tpu_torch.core import Buffer, Tensor

    sent = [0] * len(pipes)
    got = [[] for _ in pipes]
    errors = []

    def camera(s):
        src, pool = pipes[s]["src"], pools[s]
        nxt = time.monotonic()
        while not stop.is_set():
            pts = first_pts + sent[s]
            src.push_buffer(Buffer(tensors=[Tensor(pool[pts % len(pool)])],
                                   pts=pts))
            sent[s] += 1
            nxt += 1.0 / fps
            time.sleep(max(0.0, nxt - time.monotonic()))

    cams = [threading.Thread(target=camera, args=(s,), name=f"camera{s}")
            for s in range(len(pipes))]

    def reader(s):
        sink, deadline = pipes[s]["out"], None
        while True:
            if stop.is_set() and not cams[s].is_alive():
                if len(got[s]) >= sent[s]:
                    return
                deadline = deadline or time.monotonic() + 120
                if time.monotonic() > deadline:
                    errors.append(f"stream {s}: {len(got[s])} of "
                                  f"{sent[s]} results")
                    return
            b = sink.pull(timeout=0.05)
            if b is not None:
                got[s].append(b.pts)

    readers = [threading.Thread(target=reader, args=(s,), name=f"reader{s}")
               for s in range(len(pipes))]
    for t in cams + readers:
        t.start()
    for t in cams + readers:
        t.join(timeout=600)
    for s in range(len(pipes)):
        if got[s] != list(range(first_pts, first_pts + sent[s])):
            errors.append(f"stream {s}: results out of order or lost")
    if errors or any(t.is_alive() for t in cams + readers):
        raise RuntimeError(f"open loop failed: {errors or 'a thread hung'}")
    return sent


def ctl_pipes(tag: str, n: int, batch: int = 64,
              buckets: str = ",".join(map(str, SERVE_BUCKETS)),
              extra: str = "", priorities=None):
    """``n`` pipelines of phase 8's shared topology, each with its own
    name (the host profiler keys its accounts by pipeline and element)."""
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch

    pipes = []
    for s in range(n):
        prio = f" priority={priorities[s]}" if priorities else ""
        p = parse_launch(SERVE_PIPE.format(
            norm=NORM, model="vit_serve", share="true", batch=batch,
            buckets=buckets, dec=LABEL_DEC, sample=extra + prio),
            pipeline=Pipeline(name=f"{tag}{s}", device=CTL_DEVICE))
        p["src"].spec = TensorsSpec.parse(
            f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
        pipes.append(p)
    return pipes


def _acct_delta(rows0, names):
    from nnstreamer_tpu_torch.obs import prof

    out = []
    for r in prof.account_rows():
        if r["pipeline"] not in names:
            continue
        b = rows0.get((r["pipeline"], r["element"]))
        if b is not None:
            r = dict(r, **{k: r[k] - b[k] for k in (
                "cpu_s", "run_s", "wait_s", "card_wait_s", "iters")})
        out.append(r)
    return out


def _dispatch_delta(d0, label):
    from nnstreamer_tpu_torch.obs import prof

    (r,) = [r for r in prof.dispatch_rows() if r["pool"] == label]
    b = d0.get(label)
    if b is None:
        return r
    n = r["dispatches"] - b["dispatches"]
    d = {k: r[k] - b[k] for k in ("wall_s", "cpu_s", "card_wait_s",
                                  "card_wait_cpu_s")}
    d["dispatches"] = n
    for k in ("wall", "cpu", "card_wait"):
        d[f"{k}_ms"] = d[f"{k}_s"] / max(n, 1) * 1e3
    d["other_ms"] = d["wall_ms"] - d["cpu_ms"] - d["card_wait_ms"]
    return d


def ctl_fence_row(pools) -> dict:
    """One element loop that waits on the card on every frame: the
    queue's thread runs the transform on the card and the appsink, whose
    fence waits for the previous frame's event (``runtime/element.py``
    ``SinkElement``).  Returns that queue's account over
    CTL_FENCE_FRAMES frames of the first stream's pool."""
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.obs import prof
    from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch

    p = parse_launch(
        "appsrc name=src max-buffers=32 ! queue name=q "
        "max-size-buffers=32 ! tensor_transform name=norm "
        f"mode=arithmetic option={NORM} backend=cuda ! appsink name=out "
        "max-buffers=128", pipeline=Pipeline(name="ctlfence",
                                             device=CTL_DEVICE))
    p["src"].spec = TensorsSpec.parse(f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
    rows0 = {(r["pipeline"], r["element"]): r for r in prof.account_rows()}
    try:
        p.start()
        outs = closed_loop([p], pools[:1], 0, CTL_FENCE_FRAMES,
                           SERVE_DEPTH)[0]
        if [b.pts for b in outs[0]] != list(range(CTL_FENCE_FRAMES)):
            raise RuntimeError("control (a): fenced loop: pts out of order "
                               "or lost")
        p["src"].end_of_stream()
        if not p.wait_eos(timeout=120):
            raise RuntimeError("control (a): fenced loop: no EOS")
    finally:
        p.stop()
    (row,) = [r for r in _acct_delta(rows0, {"ctlfence"})
              if r["element"] == "q"]
    return row


def ctl_hostprof(card: str, power: str):
    """15a: the host profiler on the shared leg (see the module doc)."""
    import tempfile
    import threading

    from nnstreamer_tpu_torch.obs import prof
    from nnstreamer_tpu_torch.obs.watch import AlertRule, Watch, default_rules

    pools = serve_pools(SERVE_STREAMS, CTL_DEVICE)[0]
    pipes = ctl_pipes("ctl", SERVE_STREAMS)
    names = {p.name for p in pipes}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    deep_dir = tempfile.mkdtemp(prefix="deepprof-",
                                dir=os.path.join(HERE, "build"))
    try:
        for p in pipes:
            p.start()
        label = pipes[0]["net"].pool.label()
        closed_loop(pipes, pools, 0, SERVE_WARMUP, SERVE_DEPTH)
        _ctl_sync()
        # every element loop runs under its nns: name, in the registry
        missing = []
        for p in pipes:
            for el in p.elements.values():
                t = getattr(el, "_thread", None)
                if t is None:
                    continue
                info = prof.THREADS.lookup(t.ident) or {}
                if t.name != f"nns:{p.name}:{el.name}" or \
                        (info.get("pipeline"), info.get("element")) != \
                        (p.name, el.name):
                    missing.append((t.name, info))
        if missing or len(prof.THREADS) < 2 * SERVE_STREAMS:
            raise RuntimeError(f"control (a): element threads outside the "
                               f"registry: {missing}")
        first = SERVE_WARMUP

        def leg(n, hz):
            nonlocal first
            rows0 = {(r["pipeline"], r["element"]): r
                     for r in prof.account_rows()}
            d0 = {r["pool"]: r for r in prof.dispatch_rows()}
            prof.PROFILER.clear()
            started = hz > 0 and prof.PROFILER.configure(hz).start()
            cpu0 = time.process_time()
            outs, _lats, wall = closed_loop(pipes, pools, first, n,
                                            SERVE_DEPTH)
            _ctl_sync()
            cpu = time.process_time() - cpu0
            if started:
                prof.PROFILER.stop()
            for s, bufs in enumerate(outs):
                if [b.pts for b in bufs] != list(range(first, first + n)):
                    raise RuntimeError(f"control (a): stream {s}: pts out "
                                       "of order or lost")
            first += n
            return {"rows": _acct_delta(rows0, names),
                    "dispatch": _dispatch_delta(d0, label),
                    "process_cpu_s": cpu, "wall_s": wall,
                    "fps": SERVE_STREAMS * n / wall,
                    "samples": prof.PROFILER.element_samples(),
                    "summary": prof.PROFILER.summary(),
                    "self_cpu_s": prof.PROFILER.self_cpu_s}

        on = leg(CTL_FRAMES, CTL_PROF_HZ)
        rows = on["rows"]
        total_cpu = sum(r["cpu_s"] for r in rows)
        exact = total_cpu <= on["process_cpu_s"] * 1.02 + 0.005
        if not exact:
            raise RuntimeError(f"control (a): accounts' CPU {total_cpu} s "
                               f"above the process's {on['process_cpu_s']}")
        # every dispatch waits on the card; a leg's element loop does
        # only when a window fills and dispatches inline on it, which a
        # leg may never do, so one more loop waits on every frame (the
        # sink's fence) and its account must show it, on the wait side
        fence = ctl_fence_row(pools)
        card_wait = sum(r["card_wait_s"] for r in rows)
        _ctl_card_gate(
            fence["card_wait_s"] > 0 and on["dispatch"]["card_wait_s"] > 0
            and all(r["wait_s"] >= r["card_wait_s"] - 1e-9
                    for r in rows + [fence]),
            f"control (a): card waits not on the wait side: {rows} "
            f"{fence} {on['dispatch']}", "card waits on the wait side")
        if on["summary"]["samples"] <= 0 or on["summary"]["errors"]:
            raise RuntimeError(f"control (a): sampler {on['summary']}")
        # interleaved A/B of the same leg: off/on, on/off
        ratios, self_fracs, ab = [], [], []
        for pair in range(CTL_AB_PAIRS):
            arms = ("off", "on") if pair % 2 == 0 else ("on", "off")
            got = {}
            for arm in arms:
                r = leg(CTL_AB_FRAMES, CTL_PROF_HZ if arm == "on" else 0.0)
                got[arm] = r
                ab.append((arm, r["fps"], r["process_cpu_s"]))
            ratios.append(got["on"]["process_cpu_s"]
                          / got["off"]["process_cpu_s"] - 1.0)
            self_fracs.append(got["on"]["self_cpu_s"]
                              / got["on"]["process_cpu_s"])
        overhead = statistics.median(ratios)
        # one alert-triggered deep capture with its device session
        prof.DEEP.clear()
        prof.DEEP.arm(deep_dir, seconds=CTL_DEEP_S, hz=200.0,
                      min_interval_s=3600.0, device=True)
        # the default pack and bench_mttr's pool-stall watch the capture;
        # the trigger waits CTL_BASELINE_S of traffic so the anomaly rules
        # hold a baseline before the gate's holds
        watched = default_rules() + [AlertRule(
            name="pool-stall", kind="threshold", metric="nns_pool_pending",
            op=">=", value=16.0, for_s=0.1, severity="critical")]
        window_s = max(r.for_s for r in watched)
        w = Watch(rules=watched + [AlertRule(
            name="serving-live", kind="threshold",
            metric="nns_pool_frames_total", op=">", value=0.0,
            for_s=CTL_BASELINE_S, severity="info")],
            interval_s=CTL_INTERVAL_S)
        # open-loop cameras through the capture: frames keep arriving
        # while the session starts and stops (the gate holds them back;
        # none may be lost or reordered)
        stop = threading.Event()
        fed = {}

        def feed():
            try:
                fed["sent"] = ctl_open_loop(pipes, pools, first, stop,
                                            CAMERA_FPS)
            except Exception as e:  # noqa: BLE001 - re-raised below
                fed["error"] = e

        th = threading.Thread(target=feed, name="ctl-feed")
        def fired():
            return {a["rule"]: a["fired"] for a in w.alerts()
                    if a["rule"] != "serving-live"}

        w.start()
        th.start()
        before = after = None
        try:
            deadline = time.monotonic() + 60
            while not prof.DEEP.episodes and time.monotonic() < deadline:
                before = fired()
                time.sleep(0.02)
            while not prof.DEEP.captures and time.monotonic() < deadline:
                time.sleep(0.05)
            # one for= window of traffic after the stop's hold, watched
            time.sleep(window_s)
            after = fired()
        finally:
            stop.set()
            th.join(timeout=300)
            w.stop()
            prof.DEEP.disarm()
        hold_alerts = {k: v - (before or {}).get(k, 0)
                       for k, v in (after or {}).items()
                       if v - (before or {}).get(k, 0) > 0}

        if "error" in fed or th.is_alive():
            raise RuntimeError(f"control (a): open-loop feed through the "
                               f"capture: {fed.get('error', 'hung')}")
        first += max(fed["sent"])
        if not prof.DEEP.captures:
            raise RuntimeError("control (a): the alert started no deep "
                               "capture")
        if prof.DEEP.device_failures or not prof.DEEP.device_traces:
            raise RuntimeError(f"control (a): deep capture's device trace "
                               f"failed: {prof.DEEP.last_device_error}")
        with open(prof.DEEP.device_traces[0]) as f:
            events = json.load(f)["traceEvents"]
        knames = [e.get("name", "") for e in events
                  if e.get("cat") == "kernel"]
        deep_rows = {k: sum(k in n for n in knames)
                     for k in ("scale_bias_cast", "flash_attention")}
        _ctl_card_gate(all(deep_rows.values()),
                       f"control (a): the deep trace lacks a kernel's "
                       f"device rows: {deep_rows}",
                       "the deep trace's kernel rows")
        for p in pipes:
            p["src"].end_of_stream()
        for p in pipes:
            if not p.wait_eos(timeout=120):
                raise RuntimeError("control (a): no EOS")
    finally:
        for p in pipes:
            p.stop()
    samples = on["samples"]
    elements = {}
    for r in rows:
        key = f"{r['pipeline']}:{r['element']}"
        elements[key] = {k: r[k] for k in ("cpu_s", "run_s", "wait_s",
                                           "card_wait_s", "iters")}
        elements[key]["samples"] = samples.get(
            (r["pipeline"], r["element"]), 0)
    disp = on["dispatch"]
    res = {"fps": on["fps"], "process_cpu_s": on["process_cpu_s"],
           "element_cpu_s": total_cpu, "attribution_exact": exact,
           "elements": elements, "dispatch": disp,
           "fenced_loop": {k: fence[k] for k in ("cpu_s", "run_s", "wait_s",
                                                 "card_wait_s", "iters")},
           "sampler": on["summary"], "ab": ab,
           "ab_overhead_frac": overhead, "ab_bound": CTL_AB_BOUND,
           "sampler_self_cpu_frac": max(self_fracs),
           "deep_capture": {"trace": os.path.relpath(
               prof.DEEP.device_traces[0], HERE), "kernel_rows": deep_rows,
               "kernel_events": len(knames),
               "gate_holds_ms": [h * 1e3 for h in prof.DEEP.gate_holds_s],
               "alerts_after_hold": hold_alerts,
               "alerts_before_trigger": {k: v for k, v in
                                         (before or {}).items() if v},
               "watched_rules": len(watched), "for_window_s": window_s,
               "open_loop_fps": CAMERA_FPS,
               "open_loop_frames": sum(fed["sent"])}}
    print(f"control (a) host profiler at {CTL_PROF_HZ:g} Hz on the shared "
          f"leg: {on['fps']:.1f} frames/s, process CPU "
          f"{on['process_cpu_s']:.3f} s, the element accounts "
          f"{total_cpu:.3f} s (exact: {exact}), card waits {card_wait:.3f} s "
          f"on the wait side, {on['summary']['samples']} samples "
          f"[{card}, {power}]", flush=True)
    for q in sorted(elements):
        e = elements[q]
        print(f"control (a) {q}: cpu {e['cpu_s']:.4f} s run "
              f"{e['run_s']:.4f} s wait {e['wait_s']:.4f} s (card "
              f"{e['card_wait_s']:.4f} s) samples {e['samples']}",
              flush=True)
    fl = res["fenced_loop"]
    print(f"control (a) ctlfence:q, the fenced loop ({fl['iters']} frames): "
          f"cpu {fl['cpu_s']:.4f} s run {fl['run_s']:.4f} s wait "
          f"{fl['wait_s']:.4f} s (card {fl['card_wait_s']:.4f} s) "
          f"[{card}, {power}]", flush=True)
    print(f"control (a) pool dispatch cycle ({disp['dispatches']} "
          f"dispatches): {disp['wall_ms']:.3f} ms = CPU "
          f"{disp['cpu_ms']:.3f} + card wait {disp['card_wait_ms']:.3f} + "
          f"neither (interpreter or lock waits) {disp['other_ms']:.3f} ms "
          f"[{card}, {power}]", flush=True)
    print(f"control (a) sampler overhead, {CTL_AB_PAIRS} interleaved pairs "
          f"of {CTL_AB_FRAMES} frames a stream: median extra process CPU "
          f"{overhead:.4f} (the JAX package's bound {CTL_AB_BOUND}, a "
          f"reading here), sampler thread {max(self_fracs):.4f} of the "
          f"process CPU; legs (arm, frames/s, CPU s) {ab} [{card}, "
          f"{power}]", flush=True)
    dc = res["deep_capture"]
    print(f"control (a) deep capture on an alert: device trace "
          f"{dc['trace']}, kernel rows {deep_rows}; the gate closed "
          f"{dc['gate_holds_ms']} ms for the session's start and stop "
          f"while {len(pipes)} open-loop cameras at {CAMERA_FPS} frames/s "
          f"sent {dc['open_loop_frames']} frames, none lost or reordered "
          f"[{card}, {power}]", flush=True)
    print(f"control (a) alerts of the default pack and pool-stall "
          f"({dc['watched_rules']} rules) that fired from the capture's "
          f"trigger to one for= window ({dc['for_window_s']:g} s) after its "
          f"last hold: {sum(dc['alerts_after_hold'].values())} "
          f"{dc['alerts_after_hold']} (before the trigger, after "
          f"{CTL_BASELINE_S:g} s of traffic: "
          f"{dc['alerts_before_trigger']}) [{card}, {power}]", flush=True)
    return res


class CtlRig:
    """``n`` share-model pipelines of the ViT with open-loop pumps: the
    serving fixture each bench_mttr pool script steers.  Pumps push the
    staged frames at a fixed pace and drain their sinks, from warm-up
    through fault and recovery; each stream's delivered pts are kept."""

    def __init__(self, tag: str, n: int, batch: int, slo_ms: float = 0.0,
                 priorities=None, burst: int = 1):
        self.pipes = ctl_pipes(
            tag, n, batch=batch, buckets=str(batch),
            extra=" stat-sample-interval-ms=50"
            + (f" slo-ms={slo_ms:g}" if slo_ms else ""),
            priorities=priorities)
        self.pools = serve_pools(n, CTL_DEVICE)[0]
        self.n, self.batch, self.burst = n, batch, burst
        self.pace_s = 0.0
        self.pushed = [0] * n
        self.got = [[] for _ in range(n)]
        self._stop = None
        self._quiet = None  # set: stop pushing, keep draining
        self._threads = []

    @property
    def entry(self):
        return self.pipes[0]["net"].pool

    def capacity(self, n_frames: int = 32) -> float:
        """Frames/s the window sustains: a closed loop with a window of
        frames in flight a stream."""
        outs, _lats, wall = closed_loop(self.pipes, self.pools, 0,
                                        n_frames, self.batch)
        for s, bufs in enumerate(outs):
            self.got[s] += [b.pts for b in bufs]
            self.pushed[s] = n_frames
        return self.n * n_frames / wall

    def start(self, rate: float):
        import threading

        self.pace_s = self.burst / (rate / self.n)
        self._stop = threading.Event()
        self._quiet = threading.Event()
        for s in range(self.n):
            t = threading.Thread(target=self._pump, args=(s,),
                                 name=f"ctl-pump{s}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _pump(self, s):
        from nnstreamer_tpu_torch.core import Buffer, Tensor

        p, pool = self.pipes[s], self.pools[s]
        src, sink = p["src"], p["out"]
        while not self._stop.is_set():
            for _ in range(0 if self._quiet.is_set() else self.burst):
                pts = self.pushed[s]
                try:
                    src.push_buffer(Buffer(
                        tensors=[Tensor(pool[pts % len(pool)])], pts=pts),
                        timeout=0.5)
                except Exception:  # noqa: BLE001 - a full source under a
                    # stalled window is backpressure: drain and retry
                    break
                self.pushed[s] += 1
            while True:
                b = sink.pull(timeout=0)
                if b is None:
                    break
                self.got[s].append(b.pts)
            time.sleep(self.pace_s)

    def stop(self):
        """The pumps stop pushing and keep draining; EOS flushes every
        parked frame to the sinks; then the pumps stop and a last drain
        takes what they left."""
        if self._quiet is not None:
            self._quiet.set()
            time.sleep(2 * self.pace_s + 0.6)  # a push in flight lands
        for p in self.pipes:
            p["src"].end_of_stream()
        for p in self.pipes:
            p.wait_eos(timeout=120)
        if self._stop is not None:
            self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        for s, p in enumerate(self.pipes):
            while True:
                b = p["out"].pull(timeout=0)
                if b is None:
                    break
                self.got[s].append(b.pts)
        for p in self.pipes:
            p.stop()

    def check_streams(self, shed: int) -> dict:
        """Every stream's pts in order; none lost but the frames the
        admission controller shed."""
        lost = 0
        for s in range(self.n):
            got = self.got[s]
            if any(b <= a for a, b in zip(got, got[1:])):
                raise RuntimeError(f"control (b): stream {s} out of order")
            lost += self.pushed[s] - len(got)
        if lost != shed:
            raise RuntimeError(f"control (b): {lost} frames lost, {shed} "
                               "shed by admission")
        return {"pushed": sum(self.pushed),
                "delivered": sum(len(g) for g in self.got), "shed": shed}


def _actuate_retry(act, value, attempts: int = 8, wait_s: float = 0.3):
    from nnstreamer_tpu_torch.runtime.actuators import CooldownActive

    for i in range(attempts):
        try:
            return act.actuate(value)
        except CooldownActive:
            if i == attempts - 1:
                raise
            time.sleep(wait_s)


def _ctl_actions_total() -> float:
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    return _metric(REGISTRY.exposition(), "nns_control_actions_total")


def ctl_mttr_run(name, rig, expect_rule, rules, playbooks, fault_fn,
                 recovered_fn, warmup_s: float, during_fn=None):
    """bench_mttr's ``_mttr_run`` on the port: clean warm-up under the
    watch → seeded fault → alert → actuation → recovery held
    CTL_HOLD_S.  ``during_fn`` runs once while the alert fires."""
    from nnstreamer_tpu_torch.obs.control import Controller
    from nnstreamer_tpu_torch.obs.watch import Watch

    w = Watch(rules=rules, interval_s=CTL_INTERVAL_S)
    ctl = Controller(playbooks=playbooks, watch=w, interval_s=CTL_INTERVAL_S)
    actions0 = _ctl_actions_total()
    t_watch = time.monotonic()
    w.start()
    ctl.start()
    row = {"script": name, "expected_rule": expect_rule, "detected": False,
           "actuated": False, "recovered": False, "detect_s": None,
           "actuate_s": None, "mttr_s": None, "pre_fault_alerts": 0}
    during = None
    try:
        time.sleep(warmup_s)
        row["pre_fault_alerts"] = len(w.alert_log)
        # what fired before the fault, for the gate's message
        row["pre_fault"] = [{"after_watch_s": ev["ts"] - t_watch,
                             "rule": ev["rule"], "detail": ev["detail"]}
                            for ev in list(w.alert_log)]
        t_fault = time.monotonic()
        fault_fn()

        def firing(rule):
            return any(a["rule"] == rule and a["firing"] for a in w.alerts())

        deadline = t_fault + CTL_DETECT_S
        while time.monotonic() < deadline:
            post = [ev for ev in w.alert_log if ev["ts"] >= t_fault]
            if post:
                row["detected"] = True
                row["detect_s"] = post[0]["ts"] - t_fault
                row["rules_fired"] = sorted({ev["rule"] for ev in post})
                break
            time.sleep(CTL_INTERVAL_S / 2)
        if during_fn is not None and firing(expect_rule):
            during = during_fn()
        while time.monotonic() < deadline:
            acted = [d for d in list(ctl.audit)
                     if d["outcome"] in ("applied", "reverted")
                     and d["ts"] >= t_fault]
            if acted:
                row["actuated"] = True
                row["actuate_s"] = acted[0]["ts"] - t_fault
                break
            time.sleep(CTL_INTERVAL_S / 2)
        deadline = t_fault + CTL_RECOVER_S
        good_since = None
        while time.monotonic() < deadline:
            ok = row["detected"] and row["actuated"] \
                and not firing(expect_rule) and recovered_fn()
            now = time.monotonic()
            if not ok:
                good_since = None
            elif good_since is None:
                good_since = now
            elif now - good_since >= CTL_HOLD_S:
                row["recovered"] = True
                row["mttr_s"] = good_since - t_fault
                break
            time.sleep(CTL_INTERVAL_S / 2)
    finally:
        ctl.stop()
        w.stop()
    row["watched_s"] = time.monotonic() - t_watch
    row["actions"] = ctl.actions_total
    row["audit"] = [{k: d.get(k) for k in ("playbook", "actuator", "target",
                                           "applied", "prior", "outcome")}
                    for d in ctl.audit]
    row["exported_actions"] = _ctl_actions_total() - actions0
    bad = [k for k in ("detected", "actuated", "recovered") if not row[k]]
    if bad or row["pre_fault_alerts"] or expect_rule not in row.get(
            "rules_fired", []):
        raise RuntimeError(f"control (b) {name}: {bad or 'alerts'} {row}")
    if not (len(ctl.audit) == ctl.actions_total == row["exported_actions"]):
        raise RuntimeError(f"control (b) {name}: audit {len(ctl.audit)}, "
                           f"actions {ctl.actions_total}, "
                           f"nns_control_actions_total "
                           f"{row['exported_actions']}")
    return row, during


class GcPauses:
    """The cyclic collector's pauses while armed (``gc.callbacks``): how
    many collections of each generation ran and the longest, so a stall
    in a watched window can be told from the pool's own latency."""

    def __init__(self):
        self.t0 = None
        self.pauses = []  # (generation, seconds)

    def _cb(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self.t0))
            self.t0 = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def summary(self) -> dict:
        gens = Counter(g for g, _ in self.pauses)
        return {"collections": {str(g): n for g, n in sorted(gens.items())},
                "max_pause_s": max((t for _, t in self.pauses), default=0.0)}


def ctl_script(name, card, power, rig_kw, jax_rate, chaos_spec, rules,
               playbooks, fault, recovered, warmup_s, settle_s,
               during_fn=None):
    """One bench_mttr pool script on the ViT: the rig's capacity in this
    call, the offered rate CTL_LOAD_SHARE of it, ``settle_s`` of that
    open-loop traffic before the watch attaches (the JAX script's own
    settle: the start of the pumps must age out of the rules' windows),
    then the run.

    Before the pumps start, the heap the earlier phases left (profiler
    traces, buffers, pipelines: millions of objects by phase 15) is
    collected and frozen (``gc.freeze``): a full collection of it holds
    the interpreter for a few hundred ms, and one landing after the
    watch attached stalled the pool past the SLO before the fault (a
    0.48 s admission sample 0.77 s into the watch).  The collector's
    pauses over the run are kept in the row."""
    import gc

    from nnstreamer_tpu_torch import chaos

    heap = len(gc.get_objects())
    t_gc = time.perf_counter()
    gc.collect()
    full_collect_s = time.perf_counter() - t_gc
    gc.freeze()
    rig = CtlRig(name, **rig_kw)
    if chaos_spec:
        chaos.install_plan(chaos.FaultPlan.parse(chaos_spec))
    try:
        for p in rig.pipes:
            p.start()
        adm = rig.entry.admission
        slo_s = adm.slo_s if adm is not None else None
        if adm is not None:
            # a warm-up and a closed loop find the window's capacity; a
            # closed-loop client waits for every frame it pushed, so the
            # SLO is held out of the shed ramp's reach meanwhile (the
            # warm-up's first windows at a new bucket can outlast even
            # 0.99 of it), then restored, and the measurement's
            # latencies dropped from the signal
            adm.slo_s = 3600.0
        closed_loop(rig.pipes, rig.pools, 0, rig.batch, rig.batch)
        if adm is not None:
            adm.reset_signal()  # the first windows checked the fold
        for s in range(rig.n):
            rig.got[s], rig.pushed[s] = [], 0
        cap = rig.capacity()
        if adm is not None:
            adm.slo_s = slo_s
            adm.reset_signal()
        rate = CTL_LOAD_SHARE * cap
        rig.start(rate)
        time.sleep(settle_s)
        with GcPauses() as pauses:
            row, during = ctl_mttr_run(name, rig, rules[0].name, rules,
                                       playbooks, lambda: fault(rig),
                                       lambda: recovered(rig), warmup_s,
                                       during_fn=(lambda: during_fn(rig))
                                       if during_fn else None)
        adm = rig.entry.admission
    finally:
        rig.stop()
        gc.unfreeze()
        if chaos_spec:
            chaos.uninstall_plan()
    row["gc"] = {"heap_objects": heap, "full_collect_s": full_collect_s,
                 **pauses.summary()}
    # rig.stop() unwound the pool before the check: its flush delivered
    # every parked frame, and the pumps pushed their last frames, so the
    # shed count is read only now (read before the stop, a frame shed
    # after the read counted as lost)
    shed = adm.total_shed if adm is not None else 0
    row["frames"] = rig.check_streams(shed)
    row["capacity_fps"] = cap
    row["offered_fps"] = rate
    row["jax_offered_fps"] = jax_rate
    print(f"control (b) {name}: detect {row['detect_s']:.3f} s, actuate "
          f"{row['actuate_s']:.3f} s, MTTR {row['mttr_s']:.3f} s; rules "
          f"{row['rules_fired']}; {row['actions']} decisions = "
          f"nns_control_actions_total {row['exported_actions']:g}; offered "
          f"{rate:.1f} frames/s ({CTL_LOAD_SHARE} of the window's "
          f"{cap:.1f} frames/s in this call; the JAX script offered "
          f"{jax_rate:g} to its CPU model); frames {row['frames']}; "
          f"collector over the watched run {row['gc']} "
          f"[{card}, {power}]", flush=True)
    return row, during


CTL_BREAKER_OPEN_S = 8.0    # breaker-stuck: the long open window
CTL_PUB_BACK_S = 1.0        # breaker-stuck: the publisher returns


def ctl_breaker_stuck(card: str, power: str):
    """15b's fourth script, bench_mttr's ``_mttr_breaker_stuck`` on the
    port's edge layer: the publisher's pipeline dies; the subscriber's
    re-dial loop fails until its breaker opens (3 failures, then an 8 s
    open window); the publisher is back at +1 s; the ``redial-link``
    playbook on ``breaker-open`` forces the half-open probe.  Frames are
    (1, 4) float32 on the card; recovery is the breaker closed and fresh
    frames delivered, before the open window ends."""
    import threading

    import torch

    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.obs.control import Playbook
    from nnstreamer_tpu_torch.obs.watch import AlertRule
    from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch

    spec = TensorsSpec.parse("4:1", "float32")
    frame = torch.ones((1, 4), dtype=torch.float32, device=CTL_DEVICE)

    def publisher(port):
        p = parse_launch(
            "appsrc name=src max-buffers=64 ! edgesink name=esink "
            f"host=127.0.0.1 port={port} topic=mttr",
            pipeline=Pipeline(name="mttr-pub", device=CTL_DEVICE))
        p["src"].spec = spec
        p.start()
        return p, p["src"], p["esink"]

    ppub, psrc, esink = publisher(0)
    port = esink.port
    psub = parse_launch(
        "edgesrc name=esrc dest-host=127.0.0.1 "
        f"dest-port={port} topic=mttr caps=other/tensors,format=static,"
        "num_tensors=1,dimensions=4:1,types=float32 "
        "reconnect-timeout-s=60 ! appsink name=out max-buffers=256",
        pipeline=Pipeline(name="mttr-sub", device=CTL_DEVICE))
    esrc, outs = psub["esrc"], psub["out"]
    psub.start()
    # the production-shaped policy the script is about: fail fast to the
    # breaker, then a long open window
    esrc._retry.base_s = 0.05
    esrc._retry.max_s = 0.2
    esrc._retry.fail_threshold = 3
    esrc._retry.open_s = CTL_BREAKER_OPEN_S
    state = {"stop": False, "pub": (ppub, psrc), "sent": 0, "got": 0}
    lock = threading.Lock()

    def pump():
        n = 0
        while not state["stop"]:
            with lock:
                src = state["pub"][1]
            try:
                src.push_buffer(Buffer(tensors=[Tensor(frame)], pts=n),
                                timeout=0.2)
                state["sent"] += 1
                n += 1
            except Exception:  # noqa: BLE001 - publisher down mid-fault:
                # open-loop traffic keeps trying
                pass
            while outs.pull(timeout=0) is not None:
                state["got"] += 1
            time.sleep(0.005)

    pump_t = threading.Thread(target=pump, name="mttr-pump", daemon=True)
    pump_t.start()
    rules = [AlertRule(name="breaker-open", kind="threshold",
                       metric="nns_edge_breaker_state", op=">=",
                       value="open", severity="critical")]
    playbooks = [Playbook(name="redial-link", rule="breaker-open",
                          kind="link", actuator="breaker", action="set",
                          value=1.0, cooldown_s=0.3)]

    def fault():
        state["got_at_fault"] = state["got"]
        with lock:
            p = state["pub"][0]
        p.stop()

        def restart():
            time.sleep(CTL_PUB_BACK_S)
            with lock:
                state["pub"] = publisher(port)[:2]

        threading.Thread(target=restart, name="mttr-restart",
                         daemon=True).start()

    def recovered():
        # breaker closed AND fresh frames since the fault: a closed
        # breaker on a dead data path is not recovery
        return esrc._retry.state == 0 \
            and state["got"] > state.get("got_at_fault", 0)

    try:
        row, _ = ctl_mttr_run("breaker-stuck", None, "breaker-open", rules,
                              playbooks, fault, recovered, warmup_s=1.0)
    finally:
        # the subscriber first while the pump still drains its sink
        psub.stop()
        state["stop"] = True
        pump_t.join(timeout=5)
        with lock:
            state["pub"][0].stop()
    row["open_window_s"] = CTL_BREAKER_OPEN_S
    row["breaker_opens"] = esrc._retry.breaker_opens
    row["frames"] = {"sent": state["sent"], "delivered": state["got"]}
    if row["mttr_s"] >= CTL_BREAKER_OPEN_S or not row["breaker_opens"]:
        raise RuntimeError(f"control (b) breaker-stuck: not recovered "
                           f"before the {CTL_BREAKER_OPEN_S} s open "
                           f"window ends: {row}")
    print(f"control (b) breaker-stuck: detect {row['detect_s']:.3f} s, "
          f"actuate {row['actuate_s']:.3f} s, MTTR {row['mttr_s']:.3f} s "
          f"(the open window {CTL_BREAKER_OPEN_S} s, the publisher back at "
          f"+{CTL_PUB_BACK_S} s); rules {row['rules_fired']}; "
          f"{row['actions']} decisions = nns_control_actions_total "
          f"{row['exported_actions']:g}; breaker opened "
          f"{row['breaker_opens']} time(s); frames {row['frames']} "
          f"[{card}, {power}]", flush=True)
    return row


def ctl_top(rig, base: str):
    """15e: ``nns-top --once --json`` (and the rendered table) against
    the serving endpoint while slo-burn fires."""
    import io

    from nnstreamer_tpu_torch.obs import top

    connect = base.split("//", 1)[1]
    buf = io.StringIO()
    if top.main(["--once", "--json", "--connect", connect], out=buf) != 0:
        raise RuntimeError("control (e): nns-top --json failed")
    doc = json.loads(buf.getvalue())
    text = io.StringIO()
    if top.main(["--once", "--interval", "0.1", "--connect", connect],
                out=text) != 0:
        raise RuntimeError("control (e): nns-top --once failed")
    text = text.getvalue()
    rows = {(pl["pipeline"], el["element"]) for pl in doc["pipelines"]
            for el in pl["elements"]}
    want = {(p.name, el) for p in rig.pipes for el in p.elements}
    pools = [r["pool"] for r in doc["pools"]]
    firing = [s["labels"].get("rule") for s in
              doc["metrics"].get("nns_alert_state", {}).get("samples", [])
              if s.get("value")]
    lines = text.splitlines()
    head = [k for k, ln in enumerate(lines) if ln.startswith("ALERT ")]
    alerts = []
    for ln in lines[head[0] + 1:] if head else []:
        if not ln.strip():
            break
        alerts.append(ln)
    if not want <= rows or rig.entry.label() not in pools or \
            "slo-burn" not in firing or not any(
                ln.startswith("slo-burn") and "FIRING" in ln
                for ln in alerts):
        raise RuntimeError(f"control (e): nns-top rows {sorted(rows)}, "
                           f"pools {pools}, firing {firing}, ALERTS "
                           f"{alerts}")
    return {"element_rows": len(rows & want), "pools": pools,
            "firing": firing}


def ctl_mttr(card: str, power: str):
    """15b and 15e: bench_mttr's three pool scripts on the ViT."""
    from nnstreamer_tpu_torch.obs.control import Playbook
    from nnstreamer_tpu_torch.obs.metrics import serve_metrics
    from nnstreamer_tpu_torch.obs.watch import AlertRule

    rows = {}
    # window-stall → pool-stall → resume-coalescing
    rows["window-stall"], _ = ctl_script(
        "window-stall", card, power, dict(n=2, batch=8), 2 * 500.0, "",
        [AlertRule(name="pool-stall", kind="threshold",
                   metric="nns_pool_pending", op=">=", value=16.0,
                   for_s=0.1, severity="critical")],
        [Playbook(name="resume-coalescing", rule="pool-stall", kind="pool",
                  actuator="coalescing", action="set", value=1.0,
                  cooldown_s=0.5)],
        lambda rig: _actuate_retry(rig.entry.actuators()["coalescing"], 0.0),
        lambda rig: rig.entry.batcher is not None
        and rig.entry.batcher.pending < 8 and not rig.entry.batcher.paused,
        warmup_s=1.0, settle_s=1.0)
    # window-collapse → dispatch-amplification → revert max-batch
    rows["window-collapse"], _ = ctl_script(
        "window-collapse", card, power, dict(n=3, batch=8, burst=4),
        3 * 4 / 0.008, f"seed={CTL_CHAOS_SEED};slow-invoke:ms=2,p=1,"
        "match=pool:",
        [AlertRule(name="dispatch-amplification", kind="threshold",
                   metric="nns_pool_dispatches_total",
                   per="nns_pool_frames_total", op=">=", value=0.7,
                   for_s=0.25, severity="warning")],
        [Playbook(name="widen-window", rule="dispatch-amplification",
                  kind="pool", actuator="max-batch", action="revert",
                  cooldown_s=0.5)],
        lambda rig: _actuate_retry(rig.entry.actuators()["max-batch"], 1.0),
        lambda rig: rig.entry.batcher is not None
        and rig.entry.batcher.max_batch == 8
        and rig.entry.batcher.pending < 32,
        warmup_s=1.2, settle_s=1.0)
    # slo-burn-overload → slo-burn → widen-window + tighten-admission,
    # with nns-top against the endpoint while the burn fires
    srv = serve_metrics(port=0)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        rows["slo-burn-overload"], top_res = ctl_script(
            "slo-burn-overload", card, power,
            dict(n=3, batch=16, slo_ms=250.0,
                 priorities=["high", "low", "low"], burst=4),
            3 * 4 / 0.012, f"seed={CTL_CHAOS_SEED + 1};slow-invoke:ms=8,p=1,"
            "match=pool:",
            [AlertRule(name="slo-burn", kind="slo_burn",
                       metric="nns_admission_latency_seconds", fast_s=0.4,
                       slow_s=1.6, budget=0.05, burn=2.0,
                       severity="critical")],
            [Playbook(name="widen-window", rule="slo-burn", kind="pool",
                      actuator="max-batch", action="step", value=15.0,
                      cooldown_s=1.0),
             Playbook(name="tighten-admission", rule="slo-burn",
                      kind="pool", actuator="ramp-start", action="set",
                      value=0.5, cooldown_s=1.0)],
            lambda rig: _actuate_retry(rig.entry.actuators()["max-batch"],
                                       1.0),
            lambda rig: rig.entry.admission is not None
            and rig.entry.batcher is not None
            and rig.entry.batcher.max_batch == 16
            and rig.entry.admission.p99_s < 0.25,
            warmup_s=1.5, settle_s=1.5,
            during_fn=lambda rig: ctl_top(rig, base))
    finally:
        srv.close()
    if top_res is None:
        raise RuntimeError("control (e): slo-burn was not firing when "
                           "nns-top looked")
    print(f"control (e) nns-top --once --json during slo-burn: "
          f"{top_res['element_rows']} element rows, pools "
          f"{top_res['pools']}, firing {top_res['firing']} [{card}, "
          f"{power}]", flush=True)
    rows["breaker-stuck"] = ctl_breaker_stuck(card, power)
    return rows, top_res


def ctl_clean(card: str, power: str, seconds: float):
    """15c: the default rule pack over the shared leg, no fault."""
    import threading

    from nnstreamer_tpu_torch.obs import forecast
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY
    from nnstreamer_tpu_torch.obs.watch import Watch, default_rules

    pools = serve_pools(SERVE_STREAMS, CTL_DEVICE)[0]
    pipes = ctl_pipes("clean", SERVE_STREAMS)
    forecast.FORECASTS.reset()
    w = Watch(rules=default_rules(), interval_s=CTL_INTERVAL_S)
    try:
        for p in pipes:
            p.start()
        closed_loop(pipes, pools, 0, SERVE_WARMUP, SERVE_DEPTH)
        _ctl_sync()
        stop, first, frames = threading.Event(), [SERVE_WARMUP], [0]

        def feed():
            while not stop.is_set():
                closed_loop(pipes, pools, first[0], SERVE_DEPTH, SERVE_DEPTH)
                first[0] += SERVE_DEPTH
                frames[0] += SERVE_STREAMS * SERVE_DEPTH

        w.start()
        th = threading.Thread(target=feed, name="ctl-clean-feed")
        t0 = time.monotonic()
        th.start()
        try:
            time.sleep(seconds)
            snap = REGISTRY.snapshot()
        finally:
            stop.set()
            th.join(timeout=300)
            w.stop()
        wall = time.monotonic() - t0
        for p in pipes:
            p["src"].end_of_stream()
        for p in pipes:
            if not p.wait_eos(timeout=120):
                raise RuntimeError("control (c): no EOS")
    finally:
        for p in pipes:
            p.stop()
    fc = snap.get("forecasts") or {}
    if "nns_alert_state" not in snap["metrics"] or not (
            fc.get("rules") or fc.get("capacity")):
        raise RuntimeError(f"control (c): alerts/forecasts sections absent "
                           f"while the watch runs: {sorted(snap['metrics'])}"
                           f" {fc}")
    fired = [ev for ev in w.alert_log]
    disabled = ctl_disabled_check()
    res = {"seconds": wall, "frames": frames[0],
           "fps": frames[0] / wall, "false_positives": len(fired),
           "fired": sorted({ev["rule"] for ev in fired}),
           "forecasts": fc, "disabled": disabled}
    print(f"control (c) clean leg, default rule pack, {wall:.2f} s, "
          f"{frames[0]} frames ({res['fps']:.1f} frames/s): "
          f"{len(fired)} alerts fired {res['fired']} (false positives: no "
          f"fault was injected); forecasts table {json.dumps(fc)}; with "
          f"{'NNS_TPU_TORCH_OBS_DISABLE'}=1 {disabled} [{card}, {power}]",
          flush=True)
    return res


def ctl_disabled_child() -> int:
    """``--control-disabled-child``: run with the kill switch; a watch,
    the environment's watchdog and a pipeline on the CPU, then which of
    the snapshot's active sections hold anything (as one JSON line)."""
    import numpy as np

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.obs import hooks, watch
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY
    from nnstreamer_tpu_torch.runtime import parse_launch

    w = watch.Watch(rules=watch.default_rules(), interval_s=CTL_INTERVAL_S)
    started = w.start()
    p = parse_launch("appsrc name=src ! queue ! appsink name=out",
                     device="cpu")
    p["src"].spec = TensorsSpec.parse("4", "float32")
    with p:
        for i in range(8):
            p["src"].push_buffer(Buffer.of(np.zeros(4, np.float32), pts=i))
        p["src"].end_of_stream()
        p.wait_eos(timeout=60)
        time.sleep(3 * CTL_INTERVAL_S)
        snap = REGISTRY.snapshot()
    print(json.dumps({"obs_disabled": hooks.DISABLED, "watch_started": started,
                      "env_watch": watch.WATCH is not None,
                      "alert_family": "nns_alert_state" in snap["metrics"],
                      "forecast_rows": len(snap["forecasts"]["rules"])
                      + len(snap["forecasts"]["capacity"])}))
    return 0


def ctl_disabled_check() -> dict:
    env = dict(os.environ, NNS_TPU_TORCH_OBS_DISABLE="1",
               NNS_TPU_TORCH_WATCH=str(CTL_INTERVAL_S))
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--control-disabled-child"], capture_output=True,
                         text=True, timeout=300, env=env, cwd=HERE)
    if out.returncode != 0:
        raise RuntimeError(f"control (c): the kill-switch child failed:\n"
                           f"{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if res != {"obs_disabled": True, "watch_started": False,
               "env_watch": False, "alert_family": False,
               "forecast_rows": 0}:
        raise RuntimeError(f"control (c): with the kill switch {res}")
    return res


def ctl_lockdep_child() -> int:
    """``--control-lockdep-child``: run with NNS_TPU_TORCH_LOCKDEP=1;
    the shared leg, then the witness's counts as one JSON line."""
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import build
    from nnstreamer_tpu_torch.utils import lockdep

    if CTL_DEVICE == "cuda":
        build.build_all()
    register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED, **VIT)
    pools = serve_pools(SERVE_STREAMS, CTL_DEVICE)[0]
    pipes = ctl_pipes("lockdep", SERVE_STREAMS)
    try:
        for p in pipes:
            p.start()
        closed_loop(pipes, pools, 0, SERVE_WARMUP + CTL_AB_FRAMES,
                    SERVE_DEPTH)
        _ctl_sync()
        for p in pipes:
            p["src"].end_of_stream()
        for p in pipes:
            p.wait_eos(timeout=120)
    finally:
        for p in pipes:
            p.stop()
    wit = lockdep.witness_dict()
    print(json.dumps({"enabled": lockdep.enabled(),
                      "nodes": len(wit["nodes"]), "edges": len(wit["edges"]),
                      "cycles": wit["cycles"],
                      "violations": wit["violations"],
                      "dispatch_ok": sorted(
                          n["label"] for n in wit["nodes"]
                          if "_flush_serial_lock" in n["label"])}))
    return 0


def ctl_lockdep(card: str, power: str) -> dict:
    """15d: the shared leg under the lock-order witness, in a child."""
    env = dict(os.environ, NNS_TPU_TORCH_LOCKDEP="1")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--control-lockdep-child"], capture_output=True,
                         text=True, timeout=600, env=env, cwd=HERE)
    if out.returncode != 0:
        raise RuntimeError(f"control (d): the lockdep child failed:\n"
                           f"{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if not res["enabled"] or not res["nodes"] or res["cycles"] or \
            res["violations"] or not res["dispatch_ok"]:
        raise RuntimeError(f"control (d): lockdep witness {res}")
    print(f"control (d) lockdep on the shared leg (a child process): "
          f"{res['nodes']} lock nodes, {res['edges']} order edges, no "
          f"cycle, no lock held across a dispatch but the marked "
          f"{res['dispatch_ok']} [{card}, {power}]", flush=True)
    return res


def phase_control(card: str, power: str):
    """Phase 15 (see the module doc)."""
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED, **VIT)
    kernels.flash_attention.launches = 0
    kernels.scale_bias_cast.launches = 0
    hostprof = ctl_hostprof(card, power)
    mttr, top_res = ctl_mttr(card, power)
    launches = {"flash_attention": kernels.flash_attention.launches,
                "scale_bias_cast": kernels.scale_bias_cast.launches}
    _ctl_card_gate(all(launches.values()),
                   f"control: a kernel never launched: {launches}",
                   "kernel launches on phase 15's path")
    clean = ctl_clean(card, power, min(CTL_CLEAN_MAX_S, max(
        r["watched_s"] for r in mttr.values())))
    lock = ctl_lockdep(card, power)
    out = {"hostprof": hostprof, "mttr": mttr, "top": top_res,
           "clean": clean, "lockdep": lock, "launches": launches}
    print(f"control: kernel launches on phase 15's path {launches}; "
          f"control phase: {time.perf_counter() - t0:.2f} s [{card}, "
          f"{power}]", flush=True)
    return out


# -- phase 16: queue prefetch-host=, FilterSingle, to_dot and the analyzer ---

PREFETCH_WINDOWS = 12       # windows of each 16a run
PREFETCH_RUNS = ("false", "true", "true", "false")
PREFETCH_PROFILED = (3, 8)  # sink arrivals the 16a profile spans
SINGLE_INVOKES = 8          # 16b: FilterSingle invokes timed
SINGLE_TOL = 5e-2           # phase 7's bf16 tolerance, kernel vs plain
PREFETCH_PIPE = (
    "device_src name=src num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "queue name=q prefetch-host={pf} ! "
    "tensor_decoder name=dec mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} ! "
    "appsink name=out max-buffers={sink}")

#: (phase, description) of every parse_launch call of this process, in
#: order: the corpus phase 16d analyzes
LAUNCHED = []
PHASE = ["-"]


def record_launches() -> None:
    """Make every ``parse_launch`` of this process record its description
    in :data:`LAUNCHED` under the running phase (:data:`PHASE`)."""
    import nnstreamer_tpu_torch.runtime as runtime
    import nnstreamer_tpu_torch.runtime.parser as parser

    real = parser.parse_launch

    def recording(desc, *args, **kw):
        LAUNCHED.append((PHASE[0], desc))
        return real(desc, *args, **kw)

    runtime.parse_launch = parser.parse_launch = recording


def prefetch_pipe(pf: str, n: int) -> str:
    return PREFETCH_PIPE.format(n=n, norm=NORM, model="ssd_mobilenet_v2",
                                pf=pf, s=SIZE, sink=n + 4)


def d2h_rows():
    from nnstreamer_tpu_torch.obs import transfer as xfer

    return sorted((r["source"], r["reason"], r["count"], r["bytes"])
                  for r in xfer.LEDGER.snapshot() if r["direction"] == "d2h")


def copy_streams(trace_path: str):
    """(device→host copy streams, the filter's kernel streams, copies) of a
    torch.profiler Chrome trace: the filter's streams are those its fused
    prologue (``scale_bias_cast``) ran on."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    filt = {e["args"].get("stream") for e in events
            if e.get("cat") == "kernel"
            and "scale_bias_cast" in e.get("name", "")}
    return {e["args"].get("stream") for e in d2h}, filt, len(d2h)


def repairs_prefetch(frames, card: str, power: str):
    """16a: the SSD detection path with the host decoder behind
    ``queue prefetch-host=``, false and true in turns."""
    import hashlib

    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch

    n = PREFETCH_WINDOWS
    runs, digests, dot = [], {}, {}
    for pf in PREFETCH_RUNS:
        def setup(p, pf=pf):
            stamp_times(p)
            if pf == "true" and not dot:
                sink, render = p["out"], p["out"].render

                def first(b):
                    dot.setdefault("text", p.to_dot())
                    render(b)

                sink.render = first

        xfer.LEDGER.clear()
        kernels.scale_bias_cast.launches = 0
        p, bufs, secs = run_pipeline(prefetch_pipe(pf, n), frames, n,
                                     setup=setup)
        launches = kernels.scale_bias_cast.launches
        check_fused(p, None, f"repairs (a) prefetch-host={pf}")
        if launches < n:
            raise RuntimeError(f"repairs (a): scale_bias_cast launched "
                               f"{launches} times for {n} windows")
        rows = d2h_rows()
        digest = hashlib.sha256()
        for b in bufs:
            for t in b.tensors:
                digest.update(t.tobytes())
        digests.setdefault(pf, set()).add(digest.hexdigest())
        t_sink = [b.meta["t_sink"] for b in bufs]
        p50 = statistics.median(b - a for a, b in zip(t_sink[1:],
                                                       t_sink[2:])) * 1e3
        runs.append({"prefetch_host": pf, "p50_window_ms": p50,
                     "host_s": secs, "launches": launches, "d2h": rows})
        print(f"repairs (a) prefetch-host={pf}: p50 window {p50:.3f} ms "
              f"(host, sink arrivals 2..{n}), start→EOS {secs:.2f} s, "
              f"scale_bias_cast launches {launches}, device→host rows "
              f"(source, reason, count, bytes) {rows} [{card}, {power}]",
              flush=True)
        del bufs
    if len(set.union(*digests.values())) != 1:
        raise RuntimeError(f"repairs (a): sink bytes differ between runs: "
                           f"{digests}")
    by = {pf: [r for r in runs if r["prefetch_host"] == pf][0]["d2h"]
          for pf in ("false", "true")}
    outs = 4  # boxes, classes, scores, num
    want_pf = [("q", "prefetch", outs * n)]
    if [r[:3] for r in by["true"]] != want_pf:
        raise RuntimeError(f"repairs (a): with prefetch-host=true the "
                           f"device→host crossings are {by['true']}, not "
                           f"{want_pf}")
    if [r[:3] for r in by["false"]] != [("dec", "drain", n)]:
        raise RuntimeError(f"repairs (a): without prefetch the decoder's "
                           f"packed drain should cross once a window: "
                           f"{by['false']}")
    if by["true"][0][3] != by["false"][0][3]:
        raise RuntimeError(f"repairs (a): device→host bytes differ: "
                           f"{by['true']} vs {by['false']}")
    # a profile window of the prefetch run: the copies' streams
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.utils.profile import GATE, stop_when_quiescent

    p = parse_launch(prefetch_pipe("true", n), device="cuda")
    p["src"].frames = frames
    p["src"].pool_size = len(frames)
    prof = profile(activities=[ProfilerActivity.CUDA])
    seen, host = [0], []
    sink, render = p["out"], p["out"].render
    first, last = PREFETCH_PROFILED

    def profiled(b):
        # start/stop with no other thread inside a torch op: the filter
        # launches on the thread ahead of the queue (utils/profile.py)
        seen[0] += 1
        if seen[0] == first:
            GATE.hold(prof.start, 60.0)
            host.append(time.perf_counter())
        elif seen[0] == last:
            host.append(time.perf_counter())
            stop_when_quiescent(prof.stop, 60.0)
        render(b)

    sink.render = profiled
    p.start()
    try:
        if not p.wait_eos(timeout=600):
            raise RuntimeError("repairs (a) profile: no EOS")
    finally:
        p.stop()
    while p["out"].pull(timeout=0) is not None:
        pass
    busy, span, _ = device_busy(prof.events())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prefetch.json")
        prof.export_chrome_trace(path)
        copy_s, filt_s, n_copies = copy_streams(path)
    if not copy_s or not filt_s or copy_s & filt_s:
        raise RuntimeError(f"repairs (a): device→host copies on streams "
                           f"{copy_s}, the filter's kernels on {filt_s}: "
                           "the copies must run on a stream of their own")
    host_ms = (host[1] - host[0]) * 1e3
    print(f"repairs (a) profile, sink arrivals {first}..{last}: "
          f"{n_copies} device→host copies on stream(s) {sorted(copy_s)}, "
          f"the filter's kernels on stream(s) {sorted(filt_s)}; device busy "
          f"{busy:.3f} ms of a {span:.3f} ms device span (share "
          f"{busy / span:.3f}), {host_ms:.3f} ms of host time "
          f"[{card}, {power}]", flush=True)
    if "text" not in dot or "?" in dot["text"]:
        raise RuntimeError(f"repairs (c): to_dot of the running pipeline "
                           f"lacks negotiated caps: {dot}")
    links = [ln for ln in dot["text"].splitlines() if "->" in ln]
    if len(links) != 5:
        raise RuntimeError(f"repairs (c): {len(links)} links in the dot, "
                           "not 5")
    print("repairs (c) to_dot of the running prefetch pipeline (every link "
          "with its negotiated caps):\n" + dot["text"], flush=True)
    p50s = {pf: statistics.median(r["p50_window_ms"] for r in runs
                                  if r["prefetch_host"] == pf)
            for pf in ("false", "true")}
    return {"runs": runs, "p50_window_ms": p50s, "d2h": by,
            "busy_ms": busy, "span_ms": span, "busy_share": busy / span,
            "copy_streams": sorted(copy_s), "filter_streams": sorted(filt_s),
            "launches": sum(r["launches"] for r in runs), "dot_links":
            len(links)}


def repairs_single(card: str, power: str):
    """16b: ``FilterSingle`` on the full-width ViT against the pipeline."""
    import torch

    from nnstreamer_tpu_torch.core import DType
    from nnstreamer_tpu_torch.elements.filter import FilterSingle
    from nnstreamer_tpu_torch.elements.transform import (
        _fold_affine,
        parse_arith_ops,
    )
    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import kernels

    if get_model("vit_b64") is None:
        register_vit("vit_b64", batch=VIT_BATCH, image_size=VIT_SIZE,
                     seed=SEED, **VIT)
    rng = np.random.default_rng(SEED + 2)
    frames = [rng.integers(0, 256, (VIT_BATCH, VIT_SIZE, VIT_SIZE, 3),
                           dtype=np.uint8) for _ in range(2)]
    _, bufs, _ = run_pipeline(vit_pipe("vit_b64", 2), frames, 2)
    want = bufs[0].tensors[0].torch()
    # the pipeline's fused prologue, as one kernel call (not a path launch)
    a, b, _ = _fold_affine(parse_arith_ops(NORM), DType.UINT8)
    x = kernels.scale_bias_cast(torch.from_numpy(frames[0]).cuda(), a, b / a)
    depth = VIT["depth"]
    with FilterSingle(framework="torch-cuda", model="vit_b64") as fs:
        if fs.subplugin.device.type != "cuda":
            raise RuntimeError(f"repairs (b): FilterSingle placed on "
                               f"{fs.subplugin.device}, not the card")
        fs.invoke([x])  # warm
        kernels.flash_attention.launches = 0
        outs = [fs.invoke([x])[0] for _ in range(SINGLE_INVOKES)]
        launches = kernels.flash_attention.launches
        with fs.stats._lock:
            lat_us = sorted(list(fs.stats._recent)[-SINGLE_INVOKES:])
    if launches != depth * SINGLE_INVOKES:
        raise RuntimeError(f"repairs (b): flash_attention launched "
                           f"{launches} times for {SINGLE_INVOKES} invokes "
                           f"of depth {depth}")
    got = outs[0]
    err = float((got - want).abs().max())
    exact = bool(torch.equal(got, want))
    if not torch.allclose(got, want, atol=SINGLE_TOL, rtol=SINGLE_TOL) or \
            not all(torch.equal(o, got) for o in outs):
        raise RuntimeError(f"repairs (b): FilterSingle's logits differ from "
                           f"the pipeline's window 0 by {err}")
    p50 = statistics.median(lat_us) / 1e3
    print(f"repairs (b) FilterSingle on vit_b64 ({VIT}, batch {VIT_BATCH}, "
          f"{VIT_SIZE}x{VIT_SIZE}): logits vs the pipeline's window 0 "
          f"max_abs_diff={err} (equal: {exact}); flash_attention +{depth} "
          f"per invoke ({launches} in {SINGLE_INVOKES}); InvokeStats p50 "
          f"{p50:.3f} ms over {len(lat_us)} synchronous invokes "
          f"[{card}, {power}]", flush=True)
    return {"max_abs_diff": err, "equal": exact, "launches": launches,
            "p50_ms": p50, "invokes": SINGLE_INVOKES}


def repairs_lint(card: str, power: str):
    """16d: the analyzer over every description this process parsed, the
    static corpus and the self gate, with both kernels' counters still."""
    import io

    from nnstreamer_tpu_torch.analyze import Severity, analyze_description
    from nnstreamer_tpu_torch.analyze.cli import main as lint_main
    from nnstreamer_tpu_torch.analyze.pipelines import default_corpus
    from nnstreamer_tpu_torch.ops import kernels

    before = (kernels.scale_bias_cast.launches,
              kernels.flash_attention.launches)
    launched = list(LAUNCHED)  # the analyzer's own parses come after
    seen = {}
    for phase, desc in launched:
        seen.setdefault(desc, phase)
    t0 = time.perf_counter()
    tally = Counter()
    errors, by_code = [], Counter()
    for desc, phase in seen.items():
        diags, _ = analyze_description(desc)
        for d in diags:
            tally[d.severity] += 1
            by_code[d.code] += 1
            if d.severity == Severity.ERROR:
                errors.append((phase, desc, str(d)))
    secs = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"repairs (d): the analyzer finds errors in "
                           f"descriptions this run parsed: {errors}")
    phases = sorted(set(seen.values()), key=lambda s: (len(s), s))
    print(f"repairs (d) analyzed {len(seen)} distinct descriptions of "
          f"{len(launched)} parse_launch calls (phases {phases}) in "
          f"{secs:.2f} s: 0 errors, {tally[Severity.WARNING]} warnings, "
          f"{tally[Severity.INFO]} info; by code {dict(sorted(by_code.items()))}",
          flush=True)
    corpus = default_corpus(os.path.join(HERE, "chip_smoke.py"))
    bad = []
    for entry in corpus:
        diags, _ = analyze_description(entry.description,
                                       fragment=entry.fragment)
        bad += [f"{entry.label}: {d}" for d in diags
                if d.severity != Severity.INFO]
    if bad:
        raise RuntimeError(f"repairs (d): the static corpus is not clean: "
                           f"{bad}")
    out = io.StringIO()
    rc = lint_main(["--self", "--concurrency", "--strict"], out=out)
    if rc != 0:
        raise RuntimeError(f"repairs (d): --self --concurrency --strict "
                           f"exits {rc}: {out.getvalue()[-2000:]}")
    after = (kernels.scale_bias_cast.launches,
             kernels.flash_attention.launches)
    if after != before:
        raise RuntimeError(f"repairs (d): the lint launched a kernel: "
                           f"{before} -> {after}")
    print(f"repairs (d) static corpus: {len(corpus)} descriptions, 0 errors "
          f"and 0 warnings; --self --concurrency --strict over "
          f"nnstreamer_tpu_torch/ exits 0 ({out.getvalue().strip().splitlines()[-1]}); "
          f"kernel launches unchanged across the lint {before}", flush=True)
    return {"descriptions": len(seen), "calls": len(launched),
            "warnings": tally[Severity.WARNING],
            "info": tally[Severity.INFO], "by_code": dict(by_code),
            "corpus": len(corpus), "seconds": secs}


def repairs_children(card: str):
    """16e: ``nns-torch-lint`` and the installation check in children."""
    env = dict(os.environ, PYTHONPATH=HERE)
    lint = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.analyze", "--examples",
         "--self", "--concurrency", "--strict", "--json"],
        capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
    if lint.returncode != 0:
        raise RuntimeError(f"repairs (e): nns-torch-lint exits "
                           f"{lint.returncode}: {lint.stdout[-2000:]} "
                           f"{lint.stderr[-2000:]}")
    summary = json.loads(lint.stdout)["summary"]
    check = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.check", "--json"],
        capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
    if check.returncode != 0:
        raise RuntimeError(f"repairs (e): the check exits "
                           f"{check.returncode}: {check.stderr[-2000:]}")
    info = json.loads(check.stdout)
    kinds = [d["kind"] for d in info["devices"].get("cuda", [])]
    if card not in kinds:
        raise RuntimeError(f"repairs (e): the check lists {kinds}, not "
                           f"{card!r}")
    print(f"repairs (e) nns-torch-lint --examples --self --concurrency "
          f"--strict in a child: exit 0, {summary}; "
          f"nnstreamer-tpu-torch-check --json lists cuda {kinds}, "
          f"{len(info['elements'])} elements, native codec "
          f"{info['native_codec']}", flush=True)
    return {"lint_summary": summary, "check_cuda": kinds,
            "elements": len(info["elements"])}


def phase_repairs(card: str, power: str):
    """Phase 16 (see the module doc): prefetch-host=, FilterSingle, to_dot
    and the analyzer against the card's paths."""
    import torch

    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        ssd_mobilenet_v2_init,
        weights_to_bf16,
    )

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if get_model("ssd_mobilenet_v2") is None:
        register_detector("ssd_mobilenet_v2", ssd_from_jax(weights_to_bf16(
            ssd_mobilenet_v2_init(SEED, NUM_CLASSES))),
            ssd_anchors(SIZE, feature_sizes_for(SIZE)), BATCH,
            torch.bfloat16)
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(POOL)]
    res = {"prefetch": repairs_prefetch(frames, card, power),
           "single": repairs_single(card, power)}
    res["lint"] = repairs_lint(card, power)
    res["children"] = repairs_children(card)
    res["seconds"] = time.perf_counter() - t0
    print(f"repairs phase: {res['seconds']:.1f} s", flush=True)
    return res


# -- phase 17: the edge layer (query offload, device channel, pub/sub) -------

EDGE_FRAMES = 256          # 17a: frames the client offloads
EDGE_POOL = 16             # 17a: distinct frames, staged on the card
EDGE_INFLIGHT = 8          # the client's max-request and its closed loop
EDGE_SCORE_TOL = 1e-5      # phase 11's detection score tolerance
EDGE_BIG_FRAMES = 12       # 17b: batch-256 frames a run
EDGE_BIG_INFLIGHT = 2      # 17b: frames in flight (69.12 MB each)
EDGE_VIT_CLIENTS = 4       # 17c
EDGE_VIT_FRAMES = 64       # 17c: frames a client
EDGE_PUB_FRAMES = 64       # 17d
#: phase 17's device; its logic also runs on "cpu" at a small width (with
#: ``obs.transfer.CARD_TYPES`` widened), as a dry run before a call
EDGE_DEVICE = "cuda"
EDGE_SERVER_PIPE = (
    "tensor_query_serversrc name=qsrc connect-type=tcp host=127.0.0.1 "
    "port=0 id={sid} caps=other/tensors,format=static,num_tensors=1,"
    "dimensions=3:{s}:{s}:{b},types=uint8 ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=enet{sid} framework=torch-cuda model={model}{extra} ! "
    "{dec}tensor_query_serversink name=qsink id={sid}")
EDGE_CLIENT_PIPE = (
    "appsrc name=src max-buffers={q} ! tensor_query_client name=cli "
    "host=127.0.0.1 port={port} connect-type=tcp max-request={inflight} "
    "timeout=120000 device-channel={devch} ! appsink name=out "
    "max-buffers={sink}")


def edge_register_ssd(name: str, batch: int) -> None:
    """Phase 4's detector (SSD-MobileNetV2, bf16-resident) at ``batch``."""
    import torch

    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        ssd_mobilenet_v2_init,
        weights_to_bf16,
    )

    if get_model(name) is None:
        register_detector(name, ssd_from_jax(weights_to_bf16(
            ssd_mobilenet_v2_init(SEED, NUM_CLASSES))),
            ssd_anchors(SIZE, feature_sizes_for(SIZE)), batch,
            torch.bfloat16)


def _edge_card_gate(ok: bool, failure: str, what: str) -> None:
    """A gate only the card can pass (kernel launches): raise
    ``failure`` on the card; on the CPU dry run say it was skipped."""
    if EDGE_DEVICE != "cuda":
        print(f"edge dry run on {EDGE_DEVICE}: skipped the card-only "
              f"gate: {what}", flush=True)
    elif not ok:
        raise RuntimeError(failure)


def edge_pipe(desc: str, name: str):
    from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch

    return parse_launch(desc, pipeline=Pipeline(name=name,
                                                device=EDGE_DEVICE))


def edge_loop(p, pool, n: int, depth: int, first: int = 0):
    """Push ``pool[i % len(pool)]`` (card tensors) with pts i for i from
    ``first`` on, ``depth`` in flight, pull every result: (buffers, pull
    times, wall seconds)."""
    from nnstreamer_tpu_torch.core import Buffer, Tensor

    src, sink = p["src"], p["out"]
    outs, pulls = [], []
    sent = 0
    t0 = time.perf_counter()
    while len(outs) < n:
        while sent < n and sent - len(outs) < depth:
            pts = first + sent
            src.push_buffer(Buffer(tensors=[Tensor(pool[pts % len(pool)])],
                                   pts=pts))
            sent += 1
        b = sink.pull(timeout=300)
        if b is None:
            raise RuntimeError(f"{p.name}: no result within 300 s after "
                               f"{len(outs)} of {n}")
        pulls.append(time.perf_counter())
        outs.append(b)
    return outs, pulls, time.perf_counter() - t0


def edge_eos(p) -> None:
    p["src"].end_of_stream()
    if not p.wait_eos(timeout=120):
        raise RuntimeError(f"{p.name}: no EOS")


def rtt_quantile(rtt: dict, q: float):
    """The RTT histogram bucket bound (s) holding quantile ``q`` of the
    ``LinkMetrics`` RTT samples."""
    from nnstreamer_tpu_torch.obs.metrics import EDGE_RTT_BUCKETS

    want, seen = q * rtt["count"], 0
    for le, c in zip(EDGE_RTT_BUCKETS, rtt["buckets"]):
        seen += c
        if seen >= want:
            return le
    return float("inf")


def edge_crossings(pipeline: str, frames: int) -> dict:
    from nnstreamer_tpu_torch.obs import transfer as xfer

    d2h = xfer.LEDGER.totals(pipeline=pipeline, direction="d2h")
    h2d = xfer.LEDGER.totals(pipeline=pipeline, direction="h2d")
    return {"d2h": d2h[0], "d2h_bytes": d2h[1], "h2d": h2d[0],
            "h2d_bytes": h2d[1],
            "per_frame": (d2h[0] + h2d[0]) / max(frames, 1)}


def edge_server_child(cfg_json: str) -> int:
    """17a's server process: the SSD at batch 1 behind
    ``tensor_query_serversrc connect-type=tcp``.  Prints ``PORT=<n>``,
    serves until a line arrives on stdin, then prints its kernel launches
    and its ledger's crossings as ``EDGE_SERVER {json}``."""
    global SIZE, NUM_CLASSES, EDGE_DEVICE
    cfg = json.loads(cfg_json)
    SIZE, NUM_CLASSES, EDGE_DEVICE = (cfg["size"], cfg["classes"],
                                      cfg["device"])
    import torch

    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.ops import build, kernels

    if cfg["fake_card"]:
        xfer.CARD_TYPES = ("cuda", "cpu")
    if EDGE_DEVICE == "cuda":
        build.build_all()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    edge_register_ssd("edge_ssd_b1", 1)
    p = edge_pipe(EDGE_SERVER_PIPE.format(
        sid=171, s=SIZE, b=1, norm=NORM, model="edge_ssd_b1", extra="",
        dec=""), "edge-srv")
    kernels.scale_bias_cast.launches = 0
    xfer.LEDGER.clear()
    p.start()
    print(f"PORT={p['qsrc'].port}", flush=True)
    sys.stdin.readline()
    from nnstreamer_tpu_torch.edge import devicechannel

    res = {"scale_bias_cast": kernels.scale_bias_cast.launches,
           "crossings": edge_crossings("edge-srv", cfg["frames"]),
           "fingerprint": devicechannel.fingerprint()}
    p.stop()
    print("EDGE_SERVER " + json.dumps(res), flush=True)
    return 0


def edge_local_ssd(pool):
    """The pool's frames through the batch-1 detector here: (outputs as
    host arrays by frame, the filter's negotiated output caps)."""
    from nnstreamer_tpu_torch.core import TensorsSpec

    p = edge_pipe(
        "appsrc name=src max-buffers=4 ! tensor_transform mode=arithmetic "
        f"option={NORM} backend=cuda ! tensor_filter name=enet "
        "framework=torch-cuda model=edge_ssd_b1 ! appsink name=out "
        f"max-buffers={len(pool) + 4}", "edge-local")
    p["src"].spec = TensorsSpec.parse(f"3:{SIZE}:{SIZE}:1", "uint8")
    with p:
        outs, _, _ = edge_loop(p, pool, len(pool), 1)
        caps = p["enet"].srcpad.caps
        edge_eos(p)
    return [[t.np() for t in b.tensors] for b in outs], caps


def edge_offload(card: str, power: str):
    """17a: the SSD offloaded to a server in a child process over TCP."""
    import torch

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.edge.wire import (MSG_QUERY, MSG_REPLY,
                                                EdgeMessage)
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.obs.metrics import LinkMetrics

    edge_register_ssd("edge_ssd_b1", 1)
    rng = np.random.default_rng(SEED + 17)
    host = [rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(EDGE_POOL)]
    pool = [torch.from_numpy(h).to(EDGE_DEVICE) for h in host]
    local, caps = edge_local_ssd(pool)
    cfg = {"size": SIZE, "classes": NUM_CLASSES, "device": EDGE_DEVICE,
           "fake_card": xfer.CARD_TYPES != ("cuda",), "frames": EDGE_FRAMES}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--edge-server-child", json.dumps(cfg)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=HERE)
    try:
        port = None
        t_up = time.perf_counter()
        for line in proc.stdout:
            if line.startswith("PORT="):
                port = int(line.strip().split("=", 1)[1])
                break
        if port is None:
            raise RuntimeError(f"edge (a): the server child exited "
                               f"{proc.wait()} before serving")
        t_up = time.perf_counter() - t_up
        LinkMetrics.clear_all()
        p = edge_pipe(EDGE_CLIENT_PIPE.format(
            q=EDGE_INFLIGHT + 4, port=port, inflight=EDGE_INFLIGHT,
            devch="false", sink=EDGE_FRAMES + 4), "edge-cli")
        p["src"].spec = TensorsSpec.parse(f"3:{SIZE}:{SIZE}:1", "uint8")
        p["cli"].caps = caps  # pinned: no caps exchange on the link
        xfer.LEDGER.clear()
        with p:
            outs, pulls, wall = edge_loop(p, pool, EDGE_FRAMES,
                                          EDGE_INFLIGHT)
            link = LinkMetrics.get("cli", f"127.0.0.1:{port}",
                                   kind="query").snapshot()
            cli = edge_crossings("edge-cli", EDGE_FRAMES)
            timeouts, dropped = p["cli"].timeouts, p["cli"].dropped
            edge_eos(p)
        proc.stdin.write("stop\n")
        proc.stdin.flush()
        server = None
        for line in proc.stdout:
            if line.startswith("EDGE_SERVER "):
                server = json.loads(line[len("EDGE_SERVER "):])
        if proc.wait(timeout=120) != 0 or server is None:
            raise RuntimeError("edge (a): the server child failed")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # the link's counters against the frames re-packed: 4-byte length
    # prefix + wire bytes; replies echo seq with client_id 1
    tx_truth = sum(4 + len(EdgeMessage.from_buffer(
        MSG_QUERY, Buffer.of(host[i % EDGE_POOL], pts=i), seq=i + 1).pack())
        for i in range(EDGE_FRAMES))
    rx_truth = sum(4 + len(EdgeMessage.from_buffer(
        MSG_REPLY, b, client_id=1, seq=i + 1).pack())
        for i, b in enumerate(outs))
    worst = 0.0
    for i, b in enumerate(outs):
        got, ref = [t.np() for t in b.tensors], local[i % EDGE_POOL]
        if len(got) != 4 or any(g.shape != r.shape for g, r in
                                zip(got, ref)):
            raise RuntimeError(f"edge (a): frame {i}: outputs "
                               f"{[g.shape for g in got]}")
        worst = max(worst, float(np.abs(got[2].astype(np.float64)
                                        - ref[2]).max()))
        if not (np.array_equal(got[0], ref[0])
                and np.array_equal(got[1], ref[1])
                and np.array_equal(got[3], ref[3])) \
                or worst > EDGE_SCORE_TOL:
            raise RuntimeError(f"edge (a): frame {i} differs from the "
                               f"same frame through the local pipeline "
                               f"(scores off by {worst})")
    res = {
        "frames": len(outs), "frames_per_s": len(outs) / wall,
        "server_start_s": t_up,
        "rtt_p50_le_ms": rtt_quantile(link["rtt"], 0.5) * 1e3,
        "rtt_p99_le_ms": rtt_quantile(link["rtt"], 0.99) * 1e3,
        "rtt_mean_ms": link["rtt"]["mean_us"] / 1e3,
        "rtt_count": link["rtt"]["count"],
        "tx_bytes": link["tx_bytes"], "rx_bytes": link["rx_bytes"],
        "tx_bytes_truth": tx_truth, "rx_bytes_truth": rx_truth,
        "tx_msgs": link["tx_msgs"], "rx_msgs": link["rx_msgs"],
        "timeouts": timeouts, "dropped": dropped,
        "client_crossings": cli, "server_crossings": server["crossings"],
        "server_fingerprint": server["fingerprint"],
        "max_abs_score_diff": worst,
        "launches": server["scale_bias_cast"],
    }
    if [b.pts for b in outs] != list(range(EDGE_FRAMES)) or timeouts \
            or dropped:
        raise RuntimeError(f"edge (a): frames lost or out of order: "
                           f"{len(outs)} back, {timeouts} timed out, "
                           f"{dropped} dropped")
    if (link["tx_bytes"], link["rx_bytes"]) != (tx_truth, rx_truth) or \
            (link["tx_msgs"], link["rx_msgs"]) != (EDGE_FRAMES,
                                                   EDGE_FRAMES):
        raise RuntimeError(f"edge (a): link counters {link} against the "
                           f"re-packed frames tx {tx_truth} rx {rx_truth}")
    if cli["d2h"] != EDGE_FRAMES or cli["h2d"] or \
            server["crossings"]["h2d"] != EDGE_FRAMES or \
            server["crossings"]["d2h"] != 4 * EDGE_FRAMES:
        raise RuntimeError(f"edge (a): crossings client {cli}, server "
                           f"{server['crossings']}: expected one d2h a "
                           "frame here, one h2d and 4 d2h (one a "
                           "tensor) a frame at the server")
    _edge_card_gate(res["launches"] > 0, "edge (a): scale_bias_cast "
                    "never launched in the server", "17a's launches")
    print(f"edge (a) SSD offload across processes over TCP: "
          f"{res['frames_per_s']:.1f} frames/s ({EDGE_FRAMES} frames, "
          f"{EDGE_INFLIGHT} in flight); RTT p50 <= "
          f"{res['rtt_p50_le_ms']:g} ms, p99 <= {res['rtt_p99_le_ms']:g} "
          f"ms (bucket bounds), mean {res['rtt_mean_ms']:.3f} ms; tx "
          f"{link['tx_bytes']} B rx {link['rx_bytes']} B = the re-packed "
          f"frames; crossings a frame: client {cli['per_frame']:g} (d2h "
          f"{cli['d2h']}), server {server['crossings']['per_frame']:g} "
          f"(h2d {server['crossings']['h2d']}, d2h "
          f"{server['crossings']['d2h']}); outputs equal to local, scores "
          f"within {worst:g}; scale_bias_cast {res['launches']} launches "
          f"in the server [{card}, {power}]", flush=True)
    return res


def edge_repair_d2h() -> dict:
    """One host read of a card tensor crosses once, in either order."""
    import torch

    from nnstreamer_tpu_torch.core import Tensor
    from nnstreamer_tpu_torch.obs import transfer as xfer

    out = {}
    for order in ("tobytes-np", "np-tobytes"):
        x = torch.arange(3 * 1024, dtype=torch.float32, device=EDGE_DEVICE)
        t = Tensor(x)
        xfer.LEDGER.clear()
        if order == "tobytes-np":
            raw, arr = t.tobytes(), t.np()
        else:
            arr, raw = t.np(), t.tobytes()
        got = xfer.LEDGER.totals(direction="d2h")
        if got != (1, x.numel() * 4) or raw != arr.tobytes() or \
                not np.array_equal(arr, np.arange(3 * 1024,
                                                  dtype=np.float32)):
            raise RuntimeError(f"edge (b): {order}: {got} d2h (count, "
                               "bytes), one expected")
        out[order] = got[0]
    return out


def edge_devch(card: str, power: str):
    """17b: the SSD at batch 256 served in this process over TCP, with
    and without the device channel."""
    import torch

    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.edge import devicechannel
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.ops import kernels

    edge_register_ssd("ssd_mobilenet_v2", BATCH)
    rng = np.random.default_rng(SEED + 18)
    pool = [torch.from_numpy(rng.integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(EDGE_DEVICE)
        for _ in range(2)]
    srv = edge_pipe(EDGE_SERVER_PIPE.format(
        sid=172, s=SIZE, b=BATCH, norm=NORM, model="ssd_mobilenet_v2",
        extra="", dec=""), "edge-devch-srv")
    runs, outs = {}, {}
    launches = 0
    srv.start()
    try:
        for on in (True, False):
            name = f"edge-devch-{'on' if on else 'off'}"
            p = edge_pipe(EDGE_CLIENT_PIPE.format(
                q=4, port=srv["qsrc"].port, inflight=EDGE_BIG_INFLIGHT,
                devch="true" if on else "false",
                sink=EDGE_BIG_FRAMES + 4), name)
            p["src"].spec = TensorsSpec.parse(
                f"3:{SIZE}:{SIZE}:{BATCH}", "uint8")
            with p:
                granted = p["cli"]._ensure_conn().devch_ok
                devicechannel.reset()
                xfer.LEDGER.clear()
                kernels.scale_bias_cast.launches = 0
                bufs, pulls, wall = edge_loop(p, pool, EDGE_BIG_FRAMES,
                                              EDGE_BIG_INFLIGHT)
                launches += kernels.scale_bias_cast.launches
                d2h = xfer.LEDGER.totals(direction="d2h")
                h2d = xfer.LEDGER.totals(direction="h2d")
                st = devicechannel.stats()
                edge_eos(p)
            gaps = [(b - a) * 1e3 for a, b in zip(pulls, pulls[1:])]
            runs[name] = {
                "device_channel": on, "granted": granted,
                "d2h": d2h[0], "d2h_bytes": d2h[1], "h2d": h2d[0],
                "h2d_bytes": h2d[1],
                "crossings_per_frame": (d2h[0] + h2d[0]) / EDGE_BIG_FRAMES,
                "devch": st, "frames_per_s": EDGE_BIG_FRAMES * BATCH / wall,
                "p50_gap_ms": statistics.median(gaps),
                "pts_in_order": [b.pts for b in bufs]
                == list(range(EDGE_BIG_FRAMES))}
            outs[on] = bufs
    finally:
        srv.stop()
    on, off = runs["edge-devch-on"], runs["edge-devch-off"]
    frame_bytes = BATCH * SIZE * SIZE * 3
    out_bytes = sum(t.nbytes for t in outs[False][0].tensors)
    if not (on["granted"] and on["pts_in_order"] and off["pts_in_order"]):
        raise RuntimeError(f"edge (b): handshake or order: {runs}")
    if on["crossings_per_frame"] != 0.0 or \
            on["devch"]["deposits"] != on["devch"]["takes"] or \
            on["devch"]["deposits"] != 2 * EDGE_BIG_FRAMES or \
            on["devch"]["evicted"] or on["devch"]["misses"]:
        raise RuntimeError(f"edge (b): with the device channel: {on}")
    if (off["d2h"], off["h2d"], off["d2h_bytes"], off["h2d_bytes"]) != (
            5 * EDGE_BIG_FRAMES, EDGE_BIG_FRAMES,
            EDGE_BIG_FRAMES * (frame_bytes + out_bytes),
            EDGE_BIG_FRAMES * frame_bytes) or off["devch"]["deposits"]:
        raise RuntimeError(f"edge (b): without the device channel: {off}; "
                           "expected one d2h a tensor a hop (1 + 4 a "
                           "frame) and one h2d a frame")
    for i, (a, b) in enumerate(zip(outs[True], outs[False])):
        if [t.tobytes() for t in a.tensors] != \
                [t.tobytes() for t in b.tensors]:
            raise RuntimeError(f"edge (b): frame {i}: outputs differ with "
                               "and without the device channel")
    _edge_card_gate(launches > 0, "edge (b): scale_bias_cast never "
                    "launched", "17b's launches")
    res = {"runs": runs, "repair_d2h": edge_repair_d2h(),
           "launches": launches}
    print(f"edge (b) device channel in one process, SSD batch {BATCH} "
          f"({frame_bytes} B frames), {EDGE_BIG_FRAMES} frames a run: with "
          f"it {on['crossings_per_frame']:g} crossings a frame, "
          f"{on['devch']['deposits']} deposits = takes, "
          f"{on['devch']['evicted']} evicted, p50 gap "
          f"{on['p50_gap_ms']:.3f} ms; without it "
          f"{off['crossings_per_frame']:g} a frame (d2h {off['d2h']}, h2d "
          f"{off['h2d']}), p50 gap {off['p50_gap_ms']:.3f} ms; outputs "
          f"byte-equal; tobytes()+np() one d2h either order "
          f"[{card}, {power}]", flush=True)
    return res


def edge_vit(card: str, power: str):
    """17c: the pooled ViT served to EDGE_VIT_CLIENTS clients over TCP."""
    import threading

    import torch

    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.decoders.boxutil import load_labels
    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import kernels

    if get_model("vit_serve") is None:
        register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED,
                     **VIT)
    pools, _ = serve_pools(EDGE_VIT_CLIENTS, EDGE_DEVICE)
    alone = run_alone(pools)
    labels = load_labels(LABELS)
    srv = edge_pipe(EDGE_SERVER_PIPE.format(
        sid=173, s=VIT_SIZE, b=1, norm=NORM, model="vit_serve",
        extra=" share-model=true batch=64 batch-timeout-ms=2 "
              "batch-buckets=" + ",".join(map(str, SERVE_BUCKETS)),
        dec=LABEL_DEC), "edge-vit-srv")
    routed, lock = [], threading.Lock()
    render = srv["qsink"].render

    def recording(buf):
        with lock:
            routed.append((buf.meta.get("client_id"),
                           buf.meta.get("query_seq")))
        return render(buf)

    srv["qsink"].render = recording
    by_bucket = Counter()
    clients, outs, walls, errors = [], {}, {}, []
    srv.start()
    try:
        sp = srv["enet173"].pool.subplugin
        batched = sp.invoke_batched

        def counted(frames, bucket):
            by_bucket[bucket] += 1
            return batched(frames, bucket)

        sp.invoke_batched = counted
        for s in range(EDGE_VIT_CLIENTS):
            p = edge_pipe(EDGE_CLIENT_PIPE.format(
                q=EDGE_INFLIGHT + 4, port=srv["qsrc"].port,
                inflight=EDGE_INFLIGHT, devch="false",
                sink=EDGE_VIT_FRAMES + 4), f"edge-vit-c{s}")
            p["src"].spec = TensorsSpec.parse(
                f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
            p.start()
            clients.append(p)
        by_bucket.clear()
        with lock:
            routed.clear()
        kernels.flash_attention.launches = 0
        kernels.scale_bias_cast.launches = 0

        def client(s):
            try:
                outs[s], _, walls[s] = edge_loop(
                    clients[s], pools[s], EDGE_VIT_FRAMES, EDGE_INFLIGHT)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(s,),
                                    name=f"edge-vit-client{s}")
                   for s in range(EDGE_VIT_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": kernels.flash_attention.launches,
                    "scale_bias_cast": kernels.scale_bias_cast.launches}
        sp.invoke_batched = batched
        for p in clients:
            edge_eos(p)
    finally:
        for p in clients:
            p.stop()
        srv.stop()
    if errors or len(outs) != EDGE_VIT_CLIENTS:
        raise RuntimeError(f"edge (c): a client failed: {errors}")
    checked = 0
    for s in range(EDGE_VIT_CLIENTS):
        if [b.pts for b in outs[s]] != list(range(EDGE_VIT_FRAMES)):
            raise RuntimeError(f"edge (c): client {s}: replies out of order "
                               "or lost")
        for b in outs[s]:
            ref = alone[s][b.pts % len(pools[s])].reshape(-1)
            top2 = torch.topk(ref, 2).values
            if float(top2[0] - top2[1]) <= SERVE_TOL:
                continue
            idx = int(ref.argmax())
            want = labels[idx] if idx < len(labels) else str(idx)
            got = bytes(b.tensors[0].np()).decode("utf-8")
            if got != want:
                raise RuntimeError(f"edge (c): client {s} frame {b.pts}: "
                                   f"label {got!r}, alone {want!r}")
            checked += 1
    by_client = {}
    for cid, seq in routed:
        by_client.setdefault(cid, []).append(seq)
    if len(by_client) != EDGE_VIT_CLIENTS or any(
            seqs != list(range(1, EDGE_VIT_FRAMES + 1))
            for seqs in by_client.values()):
        raise RuntimeError(f"edge (c): replies by client_id at the server: "
                           f"{ {c: len(v) for c, v in by_client.items()} }")
    _edge_card_gate(all(launches.values()), f"edge (c): a kernel never "
                    f"launched: {launches}", "17c's launches")
    res = {"frames_per_s": EDGE_VIT_CLIENTS * EDGE_VIT_FRAMES / wall,
           "frames_per_s_by_client": {
               str(s): EDGE_VIT_FRAMES / walls[s]
               for s in range(EDGE_VIT_CLIENTS)},
           "windows_by_bucket": {str(k): v for k, v in
                                 sorted(by_bucket.items())},
           "labels_checked": checked, "launches": launches}
    print(f"edge (c) pooled ViT served to {EDGE_VIT_CLIENTS} clients over "
          f"TCP: {res['frames_per_s']:.1f} frames/s in all, by client "
          f"{ {k: round(v, 1) for k, v in res['frames_per_s_by_client'].items()} }; "
          f"windows by bucket {res['windows_by_bucket']}; every reply "
          f"routed to its client in order; {checked} labels (top-2 margin "
          f"> {SERVE_TOL}) equal to alone; launches {launches} "
          f"[{card}, {power}]", flush=True)
    return res


def edge_pubsub(card: str, power: str):
    """17d: ``edgesink`` publishing card frames; two subscribers on the
    topic, one on another; a one-way trace span."""
    import torch

    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.obs import LatencyTracer
    from nnstreamer_tpu_torch.obs import transfer as xfer

    caps = (f"other/tensors,format=static,num_tensors=1,"
            f"dimensions=3:{VIT_SIZE}:{VIT_SIZE}:1,types=uint8")
    g = torch.Generator().manual_seed(SEED + 19)
    frames = [torch.randint(0, 256, (1, VIT_SIZE, VIT_SIZE, 3), generator=g,
                            dtype=torch.uint8).to(EDGE_DEVICE)
              for _ in range(EDGE_PUB_FRAMES)]
    host = [f.cpu().numpy() for f in frames]
    pub = edge_pipe("appsrc name=src max-buffers=8 ! edgesink name=esink "
                    "host=127.0.0.1 port=0 connect-type=tcp topic=cam",
                    "edge-pub")
    pub["src"].spec = TensorsSpec.parse(f"3:{VIT_SIZE}:{VIT_SIZE}:1",
                                        "uint8")
    subs = []
    with LatencyTracer(sample_every=1) as tr:
        pub.start()
        try:
            port = pub["esink"].port
            for k, (topic, pinned) in enumerate((("cam", False),
                                                 ("cam", True),
                                                 ("other", True))):
                subs.append(edge_pipe(
                    f"edgesrc name=esrc{k} dest-host=127.0.0.1 "
                    f"dest-port={port} connect-type=tcp topic={topic} "
                    f"device-channel=false "
                    + (f"caps={caps} " if pinned else "")
                    + (f"num-buffers={EDGE_PUB_FRAMES} "
                       if topic == "cam" else "")
                    + f"! appsink name=out{k} "
                    f"max-buffers={EDGE_PUB_FRAMES + 4}", f"edge-sub{k}"))
                subs[-1].start()
            learned = subs[0]["esrc0"].srcpad.spec
            deadline = time.monotonic() + 30
            while len(pub["esink"]._server._subs) < 3:
                if time.monotonic() > deadline:
                    raise RuntimeError("edge (d): subscriptions did not land")
                time.sleep(0.02)
            xfer.LEDGER.clear()
            for i, f in enumerate(frames):
                pub["src"].push_buffer(Buffer(tensors=[Tensor(f)], pts=i))
            got = []
            for k in (0, 1):
                got.append([subs[k][f"out{k}"].pull(timeout=60)
                            for _ in range(EDGE_PUB_FRAMES)])
                if not subs[k].wait_eos(timeout=60):
                    raise RuntimeError(f"edge (d): subscriber {k}: no EOS")
            stray = subs[2]["out2"].pull(timeout=0.5)
            d2h = xfer.LEDGER.totals(pipeline="edge-pub", direction="d2h")
            published = pub["esink"].published
        finally:
            for p in subs:
                p.stop()
            pub.stop()
    for k in (0, 1):
        if any(b is None for b in got[k]) or \
                [b.pts for b in got[k]] != list(range(EDGE_PUB_FRAMES)):
            raise RuntimeError(f"edge (d): subscriber {k} lost frames or "
                               "got them out of order")
        for b in got[k]:
            if b.tensors[0].tobytes() != host[b.pts].tobytes():
                raise RuntimeError(f"edge (d): subscriber {k} frame "
                                   f"{b.pts} differs from the published")
    if stray is not None:
        raise RuntimeError("edge (d): the subscriber on another topic got "
                           "a frame")
    if not learned.is_static() or \
            learned.tensors[0].dims != (3, VIT_SIZE, VIT_SIZE, 1):
        raise RuntimeError(f"edge (d): learned caps {learned}")
    if d2h != (EDGE_PUB_FRAMES, EDGE_PUB_FRAMES * host[0].nbytes) or \
            published != 2 * EDGE_PUB_FRAMES:
        raise RuntimeError(f"edge (d): {d2h} d2h (count, bytes) for "
                           f"{published} sends: one a frame expected")
    recs = [r for r in tr.records()
            if any(name in ("out0", "out1") for _, name, _ in r["marks"])]
    hops = [r["remote"][0] for r in recs if r.get("remote")]
    if len(recs) != 2 * EDGE_PUB_FRAMES or len(hops) != len(recs) or any(
            h["link"] not in ("esrc0", "esrc1")
            or not {nm for _, nm, _ in h["marks"]} >= {"src"}
            for h in hops):
        raise RuntimeError(f"edge (d): {len(recs)} subscriber records, "
                           f"{len(hops)} with a one-way hop")
    lag = statistics.median(r["end"] - h["t_in"] for r, h in
                            zip(recs, hops)) if hops else None
    res = {"frames": EDGE_PUB_FRAMES, "subscribers": 2, "published": published,
           "d2h": d2h[0], "learned_dims": list(learned.tensors[0].dims),
           "oneway_records": len(hops), "p50_sub_residency_s": lag}
    print(f"edge (d) pub/sub: {EDGE_PUB_FRAMES} card frames to 2 "
          f"subscribers in order, byte-equal, none to the other topic; "
          f"caps learned {res['learned_dims']}; {d2h[0]} d2h for "
          f"{published} sends; {len(hops)} subscriber records with the "
          f"publisher's one-way hop [{card}, {power}]", flush=True)
    return res


def phase_edge(card: str, power: str):
    """Phase 17 (see the module doc)."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    res = {"offload": edge_offload(card, power),
           "devch": edge_devch(card, power),
           "vit": edge_vit(card, power),
           "pubsub": edge_pubsub(card, power)}
    res["seconds"] = time.perf_counter() - t0
    print(f"edge phase: {res['seconds']:.1f} s", flush=True)
    return res


# -- phase 18: MQTT pub/sub, the MQTT-hybrid transport, the gRPC bridge -------

MQTT_FRAMES = 256          # 18a: camera frames the publisher child sends
MQTT_VIT_HALF = 32         # 18b: frames a client sends to each server
MQTT_GRPC_WINDOWS = 2      # 18c: batch-256 SSD windows over gRPC
MQTT_CAMERA_PIPE = (
    "mqttsrc name=msrc host=127.0.0.1 port={port} sub-topic=cam "
    "num-buffers={n} ! "
    "tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! "
    "tensor_filter name=mnet framework=torch-cuda model={model} ! "
    "tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} "
    "option7=device ! appsink name=out max-buffers={sink}")
MQTT_HYBRID_SERVER_PIPE = EDGE_SERVER_PIPE.replace(
    "connect-type=tcp host=127.0.0.1 port=0",
    "connect-type=hybrid host=127.0.0.1 port={broker} topic=vit")
MQTT_HYBRID_CLIENT_PIPE = EDGE_CLIENT_PIPE.replace(
    "port={port} connect-type=tcp",
    "port={port} connect-type=hybrid topic=vit")


def mqtt_camera_frames():
    """18a's camera frames, drawn on the host from a seeded generator (the
    publisher child and this process draw the same ones)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 20)
    return [torch.randint(0, 256, (1, SIZE, SIZE, 3), generator=g,
                          dtype=torch.uint8) for _ in range(MQTT_FRAMES)]


def mqtt_pub_child(cfg_json: str) -> int:
    """18a's publisher process: the camera frames staged on the card,
    ``appsrc ! mqttsink pub-topic=cam``, pushed as fast as they go or, with
    ``fps``, frame i no earlier than i/fps s after the first, as a camera
    does.  Prints ``READY`` once connected, publishes when a line arrives
    on stdin, then prints its ledger's crossings as ``MQTT_PUB {json}``."""
    global SIZE, MQTT_FRAMES, EDGE_DEVICE
    cfg = json.loads(cfg_json)
    SIZE, MQTT_FRAMES, EDGE_DEVICE = cfg["size"], cfg["frames"], cfg["device"]
    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.obs import transfer as xfer

    if cfg["fake_card"]:
        xfer.CARD_TYPES = ("cuda", "cpu")
    frames = [f.to(EDGE_DEVICE) for f in mqtt_camera_frames()]
    p = edge_pipe("appsrc name=src max-buffers=8 ! mqttsink name=mk "
                  f"host=127.0.0.1 port={cfg['port']} pub-topic=cam",
                  "mqtt-pub")
    p["src"].spec = TensorsSpec.parse(f"3:{SIZE}:{SIZE}:1", "uint8")
    p.start()
    xfer.LEDGER.clear()
    print("READY", flush=True)
    sys.stdin.readline()
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        if cfg["fps"]:
            wait = t0 + i / cfg["fps"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        p["src"].push_buffer(Buffer(tensors=[Tensor(f)], pts=i))
    edge_eos(p)
    res = {"seconds": time.perf_counter() - t0,
           "crossings": edge_crossings("mqtt-pub", MQTT_FRAMES),
           "caps": str(p["mk"].sinkpad.caps)}
    p.stop()
    print("MQTT_PUB " + json.dumps(res), flush=True)
    return 0


def mqtt_camera_run(host, want, fps: float, label: str):
    """One run of 18a: the publisher child (unpaced with ``fps`` 0, else
    paced at ``fps``) through a fresh ``MiniBroker`` to the SSD and to a
    host subscriber, with every gate of 18a held."""
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.edge.mqtt import MiniBroker, pack_mqtt_buffer
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.ops import kernels

    broker = MiniBroker()
    proc = ssd = tap = None
    try:
        ssd = edge_pipe(MQTT_CAMERA_PIPE.format(
            port=broker.port, n=MQTT_FRAMES, norm=NORM, model="edge_ssd_b1",
            s=SIZE, sink=MQTT_FRAMES + 4), "mqtt-ssd")
        tap = edge_pipe(
            f"mqttsrc name=msrc2 host=127.0.0.1 port={broker.port} "
            f"sub-topic=cam num-buffers={MQTT_FRAMES} ! appsink name=out2 "
            f"max-buffers={MQTT_FRAMES + 4}", "mqtt-tap")
        lat = []
        create = ssd["msrc"].create

        def stamped():
            buf = create()
            if buf is not None:
                lat.append(ssd["msrc"].last_latency_us)
            return buf

        ssd["msrc"].create = stamped
        ssd.start()
        tap.start()
        cfg = {"size": SIZE, "frames": MQTT_FRAMES, "device": EDGE_DEVICE,
               "port": broker.port, "fps": fps,
               "fake_card": xfer.CARD_TYPES != ("cuda",)}
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--mqtt-pub-child", json.dumps(cfg)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=HERE)
        for line in proc.stdout:
            if line.startswith("READY"):
                break
        else:
            raise RuntimeError(f"mqtt (a, {label}): the publisher child "
                               f"exited {proc.wait()} before publishing")
        xfer.LEDGER.clear()
        kernels.scale_bias_cast.launches = 0
        proc.stdin.write("go\n")
        proc.stdin.flush()
        t0 = time.perf_counter()
        got = []
        for _ in range(MQTT_FRAMES):
            b = ssd["out"].pull(timeout=300)
            if b is None:
                raise RuntimeError(f"mqtt (a, {label}): {len(got)} of "
                                   f"{MQTT_FRAMES} frames reached the SSD")
            got.append(b)
        wall = time.perf_counter() - t0
        taps = [tap["out2"].pull(timeout=60) for _ in range(MQTT_FRAMES)]
        for p in (ssd, tap):
            if not p.wait_eos(timeout=60):
                raise RuntimeError(f"mqtt (a, {label}): {p.name}: no EOS")
        launches = kernels.scale_bias_cast.launches
        sub = edge_crossings("mqtt-ssd", MQTT_FRAMES)
        pub = None
        for line in proc.stdout:
            if line.startswith("MQTT_PUB "):
                pub = json.loads(line[len("MQTT_PUB "):])
        if proc.wait(timeout=120) != 0 or pub is None:
            raise RuntimeError(f"mqtt (a, {label}): the publisher child "
                               "failed")
        bytes_in, bytes_out = broker.bytes_in, broker.bytes_out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in (ssd, tap):
            if p is not None:
                p.stop()
        broker.stop()
    packed = sum(len(pack_mqtt_buffer(Buffer.of(h.numpy(), pts=i), None,
                                      0, 0))
                 for i, h in enumerate(host))
    frame_bytes = SIZE * SIZE * 3
    if [b.pts for b in got] != list(range(MQTT_FRAMES)) or \
            any(b is None for b in taps) or \
            [b.pts for b in taps] != list(range(MQTT_FRAMES)):
        raise RuntimeError(f"mqtt (a, {label}): frames lost or out of order")
    for i, (b, t) in enumerate(zip(got, taps)):
        if b.tensors[0].tobytes() != want[i]:
            raise RuntimeError(f"mqtt (a, {label}): frame {i}: the overlay "
                               "differs from the same frame through the "
                               "local pipeline")
        if t.tensors[0].tobytes() != host[i].numpy().tobytes():
            raise RuntimeError(f"mqtt (a, {label}): frame {i}: the host "
                               "subscriber got other bytes than were "
                               "published")
    pubx = pub["crossings"]
    if (pubx["d2h"], pubx["d2h_bytes"], pubx["h2d"]) != (
            MQTT_FRAMES, MQTT_FRAMES * frame_bytes, 0) or \
            (sub["h2d"], sub["h2d_bytes"]) != (MQTT_FRAMES,
                                               MQTT_FRAMES * frame_bytes):
        raise RuntimeError(f"mqtt (a, {label}): crossings publisher {pubx}, "
                           f"subscriber {sub}: expected one d2h a frame at "
                           "the publisher and one h2d a frame at the SSD")
    if (bytes_in, bytes_out) != (packed, 2 * packed):
        raise RuntimeError(f"mqtt (a, {label}): broker bytes in {bytes_in} "
                           f"out {bytes_out} against {packed} packed (twice "
                           "out: two subscribers)")
    _edge_card_gate(launches >= MQTT_FRAMES, f"mqtt (a, {label}): "
                    f"scale_bias_cast launched {launches} times for "
                    f"{MQTT_FRAMES} frames", "18a's launches")
    lat.sort()
    return {"frames_per_s": MQTT_FRAMES / wall, "publish_s": pub["seconds"],
            "latency_p50_us": statistics.median(lat),
            "latency_p99_us": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
            "publisher_crossings": pubx, "subscriber_crossings": sub,
            "broker_bytes_in": bytes_in, "broker_bytes_out": bytes_out,
            "packed_bytes": packed, "caps": pub["caps"],
            "launches": launches}


def mqtt_camera(card: str, power: str):
    """18a: a camera in a child process publishing over MQTT to the SSD,
    twice: unpaced for frames/s, then paced at ``CAMERA_FPS`` (below the
    SSD's rate) for ``last_latency_us``, which in the unpaced run is the
    subscriber's backlog."""
    from nnstreamer_tpu_torch.core import TensorsSpec

    edge_register_ssd("edge_ssd_b1", 1)
    host = mqtt_camera_frames()
    frames = [h.to(EDGE_DEVICE) for h in host]
    local = edge_pipe(
        "appsrc name=src max-buffers=4 ! tensor_transform mode=arithmetic "
        f"option={NORM} backend=cuda ! tensor_filter framework=torch-cuda "
        "model=edge_ssd_b1 ! tensor_decoder mode=bounding_boxes "
        f"option1=mobilenet-ssd-postprocess option4={SIZE}:{SIZE} "
        f"option5={SIZE}:{SIZE} option7=device ! appsink name=out "
        f"max-buffers={MQTT_FRAMES + 4}", "mqtt-local")
    local["src"].spec = TensorsSpec.parse(f"3:{SIZE}:{SIZE}:1", "uint8")
    with local:
        want, _, _ = edge_loop(local, frames, MQTT_FRAMES, 1)
        edge_eos(local)
    want = [b.tensors[0].tobytes() for b in want]
    fast = mqtt_camera_run(host, want, 0, "unpaced")
    paced = mqtt_camera_run(host, want, CAMERA_FPS, f"{CAMERA_FPS} frames/s")
    res = {"frames": MQTT_FRAMES, "frames_per_s": fast["frames_per_s"],
           "latency_p50_us": paced["latency_p50_us"],
           "latency_p99_us": paced["latency_p99_us"],
           "paced_fps": CAMERA_FPS, "unpaced": fast, "paced": paced,
           # a camera faster than the SSD: the paced latency is the queue
           "pace_above_rate": fast["frames_per_s"] < CAMERA_FPS,
           "launches": fast["launches"] + paced["launches"]}
    pubx, sub = fast["publisher_crossings"], fast["subscriber_crossings"]
    print(f"mqtt (a) camera child → MiniBroker → SSD at batch 1: unpaced "
          f"{res['frames_per_s']:.1f} frames/s ({MQTT_FRAMES} frames in "
          f"order to the SSD and to a host subscriber, overlays equal to "
          f"local, in both runs); paced at {CAMERA_FPS} frames/s"
          f"{' (above the unpaced rate: a queue)' if res['pace_above_rate'] else ''}: "
          f"last_latency_us p50 {res['latency_p50_us']} p99 "
          f"{res['latency_p99_us']}; crossings a frame: publisher d2h "
          f"{pubx['d2h'] / MQTT_FRAMES:g}, SSD h2d "
          f"{sub['h2d'] / MQTT_FRAMES:g}; broker in "
          f"{fast['broker_bytes_in']} B out {fast['broker_bytes_out']} B = "
          f"the packed messages; scale_bias_cast {fast['launches']} + "
          f"{paced['launches']} launches [{card}, {power}]", flush=True)
    return res


def mqtt_vit(card: str, power: str):
    """18b: the pooled ViT found through the broker, moved mid-run."""
    import threading

    import torch

    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.decoders.boxutil import load_labels
    from nnstreamer_tpu_torch.edge.mqtt import MiniBroker
    from nnstreamer_tpu_torch.edge.transport import _hybrid_discover
    from nnstreamer_tpu_torch.filters.torch_cuda import get_model
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.ops import kernels

    if get_model("vit_serve") is None:
        register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED,
                     **VIT)
    pools, _ = serve_pools(EDGE_VIT_CLIENTS, EDGE_DEVICE)
    alone = run_alone(pools)
    labels = load_labels(LABELS)
    broker = MiniBroker()
    answered, lock = Counter(), threading.Lock()

    def server(sid):
        p = edge_pipe(MQTT_HYBRID_SERVER_PIPE.format(
            broker=broker.port, sid=sid, s=VIT_SIZE, b=1, norm=NORM,
            model="vit_serve",
            extra=" share-model=true batch=64 batch-timeout-ms=2 "
                  "batch-buckets=" + ",".join(map(str, SERVE_BUCKETS)),
            dec=LABEL_DEC), f"mqtt-vit-srv{sid}")
        render = p["qsink"].render

        def counted(buf):
            with lock:
                answered[sid] += 1
            return render(buf)

        p["qsink"].render = counted
        return p

    def drive(first):
        outs, errors = {}, []

        def client(s):
            try:
                bufs, pulls, _ = edge_loop(
                    clients[s], pools[s], MQTT_VIT_HALF, EDGE_INFLIGHT,
                    first=first)
                outs[s] = (bufs, pulls)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(s,),
                                    name=f"mqtt-vit-client{s}")
                   for s in range(EDGE_VIT_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(outs) != EDGE_VIT_CLIENTS:
            raise RuntimeError(f"mqtt (b): a client failed: {errors}")
        return outs, time.perf_counter() - t0

    clients, srv2 = [], None
    srv1 = server(181)
    try:
        srv1.start()
        for s in range(EDGE_VIT_CLIENTS):
            p = edge_pipe(MQTT_HYBRID_CLIENT_PIPE.format(
                q=EDGE_INFLIGHT + 4, port=broker.port,
                inflight=EDGE_INFLIGHT, devch="false",
                sink=2 * MQTT_VIT_HALF + 4), f"mqtt-vit-c{s}")
            p["src"].spec = TensorsSpec.parse(
                f"3:{VIT_SIZE}:{VIT_SIZE}:1", "uint8")
            p.start()
            clients.append(p)
        kernels.flash_attention.launches = 0
        kernels.scale_bias_cast.launches = 0
        first, wall1 = drive(0)
        t_stop = time.perf_counter()
        srv1.stop()
        srv2 = server(182)
        srv2.start()
        second, wall2 = drive(MQTT_VIT_HALF)
        moved_s = min(pulls[0] for _, pulls in second.values()) - t_stop
        launches = {"flash_attention": kernels.flash_attention.launches,
                    "scale_bias_cast": kernels.scale_bias_cast.launches}
        for p in clients:
            edge_eos(p)
    finally:
        for p in clients:
            p.stop()
        srv1.stop()
        if srv2 is not None:
            srv2.stop()
    try:
        try:
            _hybrid_discover("127.0.0.1", broker.port, "vit", 0.5)
            cleared = False
        except OSError:
            cleared = True
    finally:
        broker.stop()
    checked = 0
    for s in range(EDGE_VIT_CLIENTS):
        bufs = first[s][0] + second[s][0]
        if [b.pts for b in bufs] != list(range(2 * MQTT_VIT_HALF)):
            raise RuntimeError(f"mqtt (b): client {s}: replies out of order "
                               "or lost")
        for b in bufs:
            ref = alone[s][b.pts % len(pools[s])].reshape(-1)
            top2 = torch.topk(ref, 2).values
            if float(top2[0] - top2[1]) <= SERVE_TOL:
                continue
            idx = int(ref.argmax())
            want = labels[idx] if idx < len(labels) else str(idx)
            got = bytes(b.tensors[0].np()).decode("utf-8")
            if got != want:
                raise RuntimeError(f"mqtt (b): client {s} frame {b.pts}: "
                                   f"label {got!r}, alone {want!r}")
            checked += 1
    answered = dict(answered)
    if answered != {181: EDGE_VIT_CLIENTS * MQTT_VIT_HALF,
                    182: EDGE_VIT_CLIENTS * MQTT_VIT_HALF}:
        raise RuntimeError(f"mqtt (b): frames answered by server {answered}:"
                           f" each half must go to its own server")
    if not cleared:
        raise RuntimeError("mqtt (b): the retained address outlived the "
                           "last server")
    _edge_card_gate(all(launches.values()), f"mqtt (b): a kernel never "
                    f"launched: {launches}", "18b's launches")
    n = EDGE_VIT_CLIENTS * MQTT_VIT_HALF
    res = {"frames_per_s": 2 * n / (wall1 + wall2),
           "frames_per_s_first": n / wall1, "frames_per_s_second": n / wall2,
           "moved_s": moved_s, "answered": {str(k): v for k, v in
                                            answered.items()},
           "labels_checked": checked, "address_cleared": cleared,
           "launches": launches}
    print(f"mqtt (b) pooled ViT found through the broker by "
          f"{EDGE_VIT_CLIENTS} clients (connect-type=hybrid): "
          f"{res['frames_per_s']:.1f} frames/s ({res['frames_per_s_first']:.1f}"
          f" before the move, {res['frames_per_s_second']:.1f} after); "
          f"{moved_s:.3f} s from the stop to the replacement's first answer;"
          f" answered by server {answered}; {checked} labels (top-2 margin > "
          f"{SERVE_TOL}) equal to alone; retained address cleared; launches "
          f"{launches} [{card}, {power}]", flush=True)
    return res


def mqtt_grpc(card: str, power: str):
    """18c: the SSD's outputs at batch BATCH over the gRPC bridge, where
    grpcio is installed."""
    try:
        import grpc  # noqa: F401
    except ImportError as e:
        print(f"mqtt (c) gRPC bridge: not run: grpcio is not installed here "
              f"({e}); nothing of 18c is counted as held", flush=True)
        return {"ran": False, "reason": str(e)}
    import torch

    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.ops import kernels

    edge_register_ssd("ssd_mobilenet_v2", BATCH)
    g = torch.Generator().manual_seed(SEED + 21)
    frames = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g,
                            dtype=torch.uint8).to(EDGE_DEVICE)
              for _ in range(MQTT_GRPC_WINDOWS)]
    head = ("appsrc name=src max-buffers=4 ! tensor_transform "
            f"mode=arithmetic option={NORM} backend=cuda ! tensor_filter "
            "framework=torch-cuda model=ssd_mobilenet_v2 ! ")
    local = edge_pipe(head + "appsink name=out max-buffers=8", "grpc-local")
    send = edge_pipe(head + "tensor_sink_grpc name=gs server=true port=0 "
                     "idl=protobuf", "grpc-send")
    for p in (local, send):
        p["src"].spec = TensorsSpec.parse(f"3:{SIZE}:{SIZE}:{BATCH}", "uint8")
    with local:
        want, _, _ = edge_loop(local, frames, MQTT_GRPC_WINDOWS, 1)
        edge_eos(local)
    send.start()
    try:
        recv = edge_pipe(f"tensor_src_grpc name=gr server=false "
                         f"port={send['gs'].bound_port} idl=protobuf "
                         f"num-buffers={MQTT_GRPC_WINDOWS} ! appsink "
                         "name=out max-buffers=8", "grpc-recv")
        recv.start()
        try:
            deadline = time.monotonic() + 30
            while not send["gs"]._subscribers:
                if time.monotonic() > deadline:
                    raise RuntimeError("mqtt (c): no RecvTensors subscriber")
                time.sleep(0.02)
            kernels.scale_bias_cast.launches = 0
            for i, f in enumerate(frames):
                send["src"].push_buffer(Buffer(tensors=[Tensor(f)], pts=i))
            got = [recv["out"].pull(timeout=300)
                   for _ in range(MQTT_GRPC_WINDOWS)]
            launches = kernels.scale_bias_cast.launches
        finally:
            recv.stop()
    finally:
        send.stop()
    nbytes = 0
    for i, (g_, w) in enumerate(zip(got, want)):
        if g_ is None or [t.tobytes() for t in g_.tensors] != \
                [t.tobytes() for t in w.tensors]:
            raise RuntimeError(f"mqtt (c): window {i} differs from local")
        nbytes += sum(t.nbytes for t in g_.tensors)
    _edge_card_gate(launches > 0, "mqtt (c): scale_bias_cast never "
                    "launched", "18c's launches")
    res = {"ran": True, "windows": MQTT_GRPC_WINDOWS, "bytes": nbytes,
           "launches": launches}
    print(f"mqtt (c) gRPC bridge: {MQTT_GRPC_WINDOWS} SSD windows at batch "
          f"{BATCH} through tensor_sink_grpc → tensor_src_grpc, {nbytes} B "
          f"byte-equal to local; scale_bias_cast {launches} launches "
          f"[{card}, {power}]", flush=True)
    return res


def phase_mqtt(card: str, power: str):
    """Phase 18 (see the module doc)."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    res = {"camera": mqtt_camera(card, power),
           "vit": mqtt_vit(card, power),
           "grpc": mqtt_grpc(card, power)}
    res["seconds"] = time.perf_counter() - t0
    print(f"mqtt phase: {res['seconds']:.1f} s", flush=True)
    return res


# -- phase 19: the parallel layer --------------------------------------------

PAR_DEVICE = "cuda"       # the virtual records' platform (a CPU dry run: cpu)
PAR_VIRTUAL = 8           # device records over the one card in (b)-(d)
PAR_TOL_BF16 = 5e-2       # sharded against unsharded at bf16 compute
PAR_TOL_F32 = 1e-4        # ... at f32 compute with TF32 off
PAR_WINDOW = (60, 64)     # (b): frames in a window, its bucket
PAR_CASCADE_FRAMES = 64
PAR_CASCADE_SHAPE = (32, 32, 3)   # the JAX bench_cascade's sizes
PAR_CASCADE_CROP = (24, 24)
PAR_CASCADE_PERIOD = 4            # frame values cycle 0..3
PAR_CASCADE_THRESHOLD = 3.0       # detector adds 1: {2, 3} offload, 1/2
#: kernels launch only on the card: off it (a dry run) the launch gates
#: read the plain versions' zero counts and are skipped
PAR_ON_CARD = lambda: PAR_DEVICE == "cuda"  # noqa: E731
PAR_SSD_PIPE = (
    "appsrc name=src ! tensor_transform name=norm mode=arithmetic "
    "option={norm} backend=cuda ! tensor_filter name={model} "
    "framework=torch-cuda model={model}{props} ! appsink name=out")


def _par_counts():
    from nnstreamer_tpu_torch.ops import kernels

    return {"flash_attention": kernels.flash_attention.launches,
            "scale_bias_cast": kernels.scale_bias_cast.launches}


def _par_zero():
    from nnstreamer_tpu_torch.ops import kernels

    kernels.flash_attention.launches = 0
    kernels.scale_bias_cast.launches = 0


def _par_logits(outs):
    """{(stream, pts): logits} of a serving leg run without the decoder."""
    return {(s, b.pts): b.tensors[0].torch().reshape(-1)
            for s, bufs in enumerate(outs) for b in bufs}


def _par_hold(got, want, tol: float, what: str) -> float:
    import torch

    if set(got) != set(want):
        raise RuntimeError(f"parallel {what}: frames {sorted(got)[:4]} "
                           f"against {sorted(want)[:4]}")
    worst = 0.0
    for k, y in got.items():
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"parallel {what}: non-finite logits at {k}")
        worst = max(worst, float((y - want[k]).abs().max()))
        if not torch.allclose(y, want[k], atol=tol, rtol=tol):
            raise RuntimeError(f"parallel {what}: frame {k} differs from "
                               f"the unmeshed pool's by {worst:.3e}")
    return worst


def _par_window(mesh: str, pools, n: int, bucket: int):
    """One window of ``n`` f32 frames in ``bucket`` through a FilterSingle
    of the ViT on ``mesh``, taken twice (the first checks the fold): the
    second's attention launches and its meshstat row."""
    import torch

    from nnstreamer_tpu_torch.elements.filter import FilterSingle
    from nnstreamer_tpu_torch.obs.meshstat import MESH_STATS
    from nnstreamer_tpu_torch.ops import kernels

    fs = FilterSingle(framework="torch-cuda", model="vit_serve",
                      device=PAR_DEVICE, mesh=mesh)
    sp = fs.subplugin
    frames = [[(pools[i % len(pools)][i // len(pools)].float() - 127.5)
               / 127.5] for i in range(n)]
    sp.invoke_batched(frames, bucket)
    MESH_STATS.reset()
    n0 = kernels.flash_attention.launches
    outs = sp.invoke_batched(frames, bucket)
    launched = kernels.flash_attention.launches - n0
    row = MESH_STATS.get("vit_serve")
    shards = len(sp._placement.groups)
    fs.close()
    if not all(bool(torch.isfinite(o[0]).all()) for o in outs):
        raise RuntimeError(f"parallel window {mesh}: non-finite logits")
    return launched, row, shards


def par_serving(card: str, power: str, phase8_fps=None):
    """19a: the shared ViT pool on ``mesh=data:-1`` at full width."""
    import torch

    from nnstreamer_tpu_torch.obs.meshstat import MESH_STATS
    from nnstreamer_tpu_torch.ops import kernels

    pools, _ = serve_pools(device=PAR_DEVICE)
    _, plain_outs = serve_leg(True, pools, card, power, decoder=False,
                              warmup=0, n=SERVE_POOL)
    plain = _par_logits(plain_outs)
    MESH_STATS.reset()
    _, mesh_outs = serve_leg(True, pools, card, power, decoder=False,
                             warmup=0, n=SERVE_POOL, mesh="data:-1")
    worst = _par_hold(_par_logits(mesh_outs), plain, SERVE_TOL,
                      "19a logits")
    row = MESH_STATS.get("vit_serve")
    if row is None or row["shards"] != 1 or row["imbalance"] != 0.0 \
            or row["replicated_dispatches"]:
        raise RuntimeError(f"parallel 19a: meshstat row {row}")
    # the timed leg with the decoder: frames/s and labels
    _par_zero()
    leg, outs = serve_leg(True, pools, card, power, mesh="data:-1")
    launches = _par_counts()
    if PAR_ON_CARD() and \
            launches["flash_attention"] < VIT["depth"] * leg["dispatches"]:
        raise RuntimeError(f"parallel 19a: {launches} for "
                           f"{leg['dispatches']} timed dispatches")
    labels = 0
    for s, bufs in enumerate(outs):
        for b in bufs:
            ref = plain[(s, b.pts % SERVE_POOL)]
            top2 = torch.topk(ref, 2).values
            if float(top2[0] - top2[1]) > SERVE_TOL:
                labels += 1
                if b.meta["label_index"] != int(ref.argmax()):
                    raise RuntimeError(f"parallel 19a: stream {s} frame "
                                       f"{b.pts}: label differs")
    # one full window: 6 attention launches a forward, no pad
    full = SERVE_BUCKETS[-1]
    fa, wrow, shards = _par_window("data:-1", pools, full, full)
    if shards != 1 or (PAR_ON_CARD() and fa != VIT["depth"]) or \
            wrow["pad_slots"] or \
            wrow["imbalance"] != 0.0 or wrow["shard_frames"] != [full]:
        raise RuntimeError(f"parallel 19a: a full window launched {fa} "
                           f"attentions on {shards} shard(s), row {wrow}")
    print(f"parallel (a) mesh=data:-1 (mesh(data:1) on this card): logits "
          f"of {len(plain)} frames against the unmeshed pool max |diff| "
          f"{worst:.3e} (tol {SERVE_TOL}), {labels} labels checked; "
          f"{leg['frames_per_s']:.1f} frames/s beside phase 8's shared "
          f"leg {phase8_fps if phase8_fps is None else round(phase8_fps, 1)}"
          f" frames/s this call; {leg['dispatches']} dispatches, launches "
          f"{launches}; meshstat shards {row['shards']} imbalance "
          f"{row['imbalance']} pad_frac {row['pad_frac']:.4f}; a full "
          f"window of {full}: {fa} attention launches, pad 0 "
          f"[{card}, {power}]", flush=True)
    return {"frames_per_s": leg["frames_per_s"],
            "phase8_shared_frames_per_s": phase8_fps,
            "max_abs_diff": worst, "labels_checked": labels,
            "dispatches": leg["dispatches"], "launches": launches,
            "meshstat": {k: row[k] for k in ("shards", "imbalance",
                                             "pad_frac")},
            "full_window_flash_launches": fa}, pools, plain


def par_virtual_vit(pools, plain, card: str, power: str):
    """19b, the ViT: the pool on data:4 and data:8 of the virtual records,
    and one window per placement launching the attention per shard."""
    from nnstreamer_tpu_torch.obs.meshstat import shard_split

    out = {}
    n, bucket = PAR_WINDOW
    for mesh in ("data:4", "data:8"):
        _par_zero()
        _, outs = serve_leg(True, pools, card, power, decoder=False,
                            warmup=0, n=SERVE_POOL, mesh=mesh)
        worst = _par_hold(_par_logits(outs), plain, PAR_TOL_BF16,
                          f"19b vit {mesh}")
        pool_launches = _par_counts()
        fa, row, shards = _par_window(mesh, pools, n, bucket)
        want = shard_split(bucket, n, shards)
        if row["shard_frames"] != want or (
                PAR_ON_CARD() and fa != VIT["depth"] * shards):
            raise RuntimeError(f"parallel 19b {mesh}: {fa} attention "
                               f"launches on {shards} shards, frames "
                               f"{row['shard_frames']} against {want}")
        out[mesh] = {"max_abs_diff": worst, "shards": shards,
                     "window_flash_launches": fa,
                     "shard_frames": row["shard_frames"],
                     "pool_launches": pool_launches}
        print(f"parallel (b) virtual shards on one card, ViT {mesh}: "
              f"logits against the unmeshed pool max |diff| {worst:.3e} "
              f"(tol {PAR_TOL_BF16}); a window of {n} in {bucket}: "
              f"{fa} attention launches ({VIT['depth']} a shard x "
              f"{shards}), shard frames {row['shard_frames']} = "
              f"shard_split; pool leg launches {pool_launches} "
              f"[{card}, {power}]", flush=True)
    return out


def _par_ssd_run(model: str, frame, props: str):
    """Two batches through the fused normalize + ``model``: the second's
    outputs and its scale_bias_cast launches (the first builds)."""
    import torch

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch

    desc = PAR_SSD_PIPE.format(norm=NORM, model=model, props=props)
    p = parse_launch(desc, device=PAR_DEVICE)
    p["src"].spec = TensorsSpec.from_shapes([frame.shape], np.uint8)
    with p:
        p["src"].push_buffer(Buffer.of(frame))
        if p["out"].pull(timeout=300) is None:
            raise RuntimeError(f"parallel 19b: no output from {desc}")
        if [(s.transforms, s.filter) for s in p.fused_segments] != \
                [(("norm",), model)]:
            raise RuntimeError(f"parallel 19b: norm not fused in {desc}")
        n0 = kernels.scale_bias_cast.launches
        p["src"].push_buffer(Buffer.of(frame))
        out = p["out"].pull(timeout=300)
        if PAR_DEVICE == "cuda":
            torch.cuda.synchronize()
        launched = kernels.scale_bias_cast.launches - n0
        p["src"].end_of_stream()
        p.wait_eos(timeout=120)
    return [t.torch() for t in out.tensors], launched


def par_virtual_ssd(card: str, power: str):
    """19b, the SSD at batch 256: raw heads at bf16 and detections at f32
    (TF32 off), sharded against unsharded, the prologue once a shard."""
    import torch

    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import (
        feature_sizes_for,
        ssd_anchors,
        ssd_from_jax,
        ssd_mobilenet_v2_init,
    )

    model = ssd_from_jax(ssd_mobilenet_v2_init(SEED, NUM_CLASSES))
    anchors = ssd_anchors(SIZE, feature_sizes_for(SIZE))
    register_model("par_ssd_raw", lambda m, x: m(x), params=model,
                   in_shapes=[(BATCH, SIZE, SIZE, 3)], in_dtypes=np.float32)
    register_detector("par_ssd_f32", model, anchors, BATCH, torch.float32)
    frame = np.random.default_rng(SEED + 19).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    placements = {"": 1, " mesh=data:4": 4,
                  " mesh=data:2,model:2 sharding=tp": 2}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    out = {}
    try:
        for model_name, tol in (("par_ssd_raw", PAR_TOL_BF16),
                                ("par_ssd_f32", PAR_TOL_F32)):
            f32 = model_name.endswith("f32")
            torch.backends.cuda.matmul.allow_tf32 = not f32 and tf32[0]
            torch.backends.cudnn.allow_tf32 = not f32 and tf32[1]
            want = None
            for props, shards in placements.items():
                _par_zero()
                got, launched = _par_ssd_run(model_name, frame, props)
                if PAR_ON_CARD() and launched != shards:
                    raise RuntimeError(
                        f"parallel 19b {model_name}{props}: "
                        f"scale_bias_cast launched {launched} times for "
                        f"{shards} data shard(s)")
                if want is None:
                    want = got
                    continue
                worst = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(got, want))
                ok = all(torch.allclose(a.float(), b.float(), atol=tol,
                                        rtol=tol) for a, b in zip(got, want))
                if f32:
                    # detections equal: classes and counts exactly
                    ok = ok and torch.equal(got[1], want[1]) \
                        and torch.equal(got[3], want[3])
                if not ok:
                    raise RuntimeError(f"parallel 19b {model_name}{props}: "
                                       f"outputs differ by {worst:.3e}")
                out[f"{model_name}{props}"] = {"max_abs_diff": worst,
                                               "scale_bias_cast": launched}
                what = "f32 detections (TF32 off)" if f32 \
                    else "bf16 raw heads"
                print(f"parallel (b) virtual shards on one card, SSD batch "
                      f"{BATCH} {what}"
                      f"{props}: against unsharded max |diff| {worst:.3e} "
                      f"(atol and rtol {tol}"
                      f"{', classes and num equal' if f32 else ''}),"
                      f" scale_bias_cast {launched} launches = data shards "
                      f"[{card}, {power}]", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return out


def _par_cascade(split: bool, frames_n: int):
    """One run of the JAX package's bench_cascade topology (its
    ``_cascade_leg``) on the port: device_src → detector (devices=0-3
    when split) → tensor_crop → tensor_if offload=then → classifier
    (devices=4-7 when split), both share-model pools on mesh=data:4."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
    from nnstreamer_tpu_torch.elements.condition import TensorIf
    from nnstreamer_tpu_torch.elements.crop import TensorCrop
    from nnstreamer_tpu_torch.elements.devicesrc import DeviceSrc
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.obs.stagestat import STAGE_STATS
    from nnstreamer_tpu_torch.runtime import Pipeline

    ch, cw = PAR_CASCADE_CROP
    pname = "par_cascade_split" if split else "par_cascade_fused"
    pool = [np.full(PAR_CASCADE_SHAPE, float(k), np.float32)
            for k in range(PAR_CASCADE_PERIOD)]
    p = Pipeline(name=pname, device=PAR_DEVICE)
    src = DeviceSrc(name="src", frames=pool, pool_size=PAR_CASCADE_PERIOD,
                    num_buffers=frames_n)
    info = AppSrc(name="regions",
                  spec=TensorsSpec.from_shapes([(1, 4)], np.uint32),
                  max_buffers=frames_n + 8)
    q1 = Queue(name="q1", max_size_buffers=64)
    det = TensorFilter(name="det", framework="torch-cuda", model="par_det",
                       mesh="data:4", devices="0-3" if split else "",
                       batch=4, batch_buckets="4", batch_timeout_ms=20.0,
                       share_model=True, stat_sample_interval_ms=0)
    crop = TensorCrop(name="crop")
    route = TensorIf(name="route", compared_value="A_VALUE",
                     compared_value_option="0:0",
                     supplied_value=str(PAR_CASCADE_THRESHOLD),
                     operator="ge", offload="then",
                     then="PASSTHROUGH", else_="PASSTHROUGH")
    q2 = Queue(name="q2", max_size_buffers=64)
    cls = TensorFilter(name="cls", framework="torch-cuda", model="par_cls",
                       mesh="data:4", devices="4-7" if split else "",
                       batch=4, batch_buckets="4", batch_timeout_ms=20.0,
                       share_model=True, stat_sample_interval_ms=0)
    sink_off = AppSink(name="off", max_buffers=frames_n + 8)
    sink_keep = AppSink(name="keep", max_buffers=frames_n + 8)
    p.add(src, info, q1, det, crop, route, q2, cls, sink_off, sink_keep)
    p.link(src, q1, det)
    p.link_pads(det, "src", crop, "sink_raw")
    p.link_pads(info, "src", crop, "sink_info")
    p.link(crop, route)
    p.link_pads(route, "src_then", q2, "sink")
    p.link(q2, cls, sink_off)
    p.link_pads(route, "src_else", sink_keep, "sink")
    region = np.array([[0, 0, cw, ch]], np.uint32)

    def crossings():
        # this run's own pipeline rows: the pools' fold checks (their
        # count varies with how windows fill) record under the pool
        return xfer.LEDGER.totals(pipeline=pname, reason="input")[0] \
            + xfer.LEDGER.totals(pipeline=pname, reason="drain")[0]

    x0 = crossings()
    h0 = xfer.LEDGER.totals(direction="d2d", reason="handoff")
    t0 = time.perf_counter()
    p.start()
    try:
        for _ in range(frames_n):
            info.push_buffer(Buffer.of(region), timeout=120)
        info.end_of_stream()
        if not p.wait_eos(timeout=300):
            raise RuntimeError(f"{pname}: no EOS")
        secs = time.perf_counter() - t0
        x1 = crossings()
        h1 = xfer.LEDGER.totals(direction="d2d", reason="handoff")
        hrow = STAGE_STATS.get(pname, "cls")
        orow = STAGE_STATS.get(pname, "route")
        off, keep = pull_all(sink_off), pull_all(sink_keep)
        res = {"fps": frames_n / secs, "crossings": x1 - x0,
               "handoff": (h1[0] - h0[0], h1[1] - h0[1]),
               "handoff_row": hrow, "offload_row": orow,
               "off": [b.tensors[0].torch().clone() for b in off],
               "keep": [b.tensors[0].torch().clone() for b in keep]}
    finally:
        p.stop()
    return res


def par_cascade(card: str, power: str):
    """19c: the stage split against the single-stage run."""
    import torch

    from nnstreamer_tpu_torch.filters import register_model

    register_model("par_det", lambda prm, f: f + prm,
                   params=torch.tensor(1.0), in_shapes=[PAR_CASCADE_SHAPE],
                   in_dtypes=np.float32)
    ch, cw = PAR_CASCADE_CROP
    register_model("par_cls",
                   lambda prm, f: torch.tanh(f * prm).sum(dim=(0, 1)),
                   params=torch.tensor(1.0),
                   in_shapes=[(ch, cw, PAR_CASCADE_SHAPE[2])],
                   in_dtypes=np.float32)
    n = PAR_CASCADE_FRAMES
    fused = _par_cascade(False, n)
    split = _par_cascade(True, n)
    crop_bytes = ch * cw * PAR_CASCADE_SHAPE[2] * 4
    orow, hrow = split["offload_row"] or {}, split["handoff_row"] or {}
    boundary = (split["crossings"] - fused["crossings"]) / float(n)
    half = n // 2
    bad = []
    if orow.get("ratio") != 0.5:
        bad.append(f"offload ratio {orow.get('ratio')}")
    if boundary != 0.0:
        bad.append(f"boundary crossings/frame {boundary}")
    if split["handoff"] != (half, half * crop_bytes) or \
            (hrow.get("frames"), hrow.get("bytes"), hrow.get("from"),
             hrow.get("to"), hrow.get("depth")) != \
            (half, half * crop_bytes, "0-3", "4-7", 0):
        bad.append(f"handoff {split['handoff']} row {hrow}")
    if fused["handoff"][0]:
        bad.append(f"single-stage handoffs {fused['handoff']}")
    for name in ("off", "keep"):
        a, b = split[name], fused[name]
        if len(a) != half or len(b) != half or not all(
                torch.equal(x, y) for x, y in zip(a, b)):
            bad.append(f"{name} outputs differ")
    if bad:
        raise RuntimeError(f"parallel 19c: {bad}")
    print(f"parallel (c) stage split on the virtual records (detector "
          f"devices=0-3, classifier devices=4-7, {n} frames): offload "
          f"ratio {orow['ratio']}, boundary crossings/frame {boundary} "
          f"(split run {split['crossings']} host crossings in its pipeline "
          f"= single-stage run {fused['crossings']}: tensor_if's scalar "
          f"a frame, the source's pool), handoff {hrow['frames']} frames "
          f"{hrow['bytes']} B = {crop_bytes} B each ({hrow['from']} -> "
          f"{hrow['to']}, depth {hrow['depth']}), outputs equal frame for "
          f"frame; {split['fps']:.1f} frames/s split, {fused['fps']:.1f} "
          f"single-stage [{card}, {power}]", flush=True)
    return {"offload_ratio": orow["ratio"],
            "boundary_crossings_per_frame": boundary,
            "handoff_frames": hrow["frames"], "handoff_bytes": hrow["bytes"],
            "fps_split": split["fps"], "fps_fused": fused["fps"]}


def par_multihost(pools, plain, card: str, power: str):
    """19d: a one-rank NCCL world, the collectives over it, a dcn pool."""
    import socket

    import torch

    from nnstreamer_tpu_torch.parallel import collectives as C
    from nnstreamer_tpu_torch.parallel import mesh as M
    from nnstreamer_tpu_torch.parallel import multihost

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0,
                         backend="nccl" if PAR_DEVICE == "cuda" else "gloo")
    try:
        backend = multihost.backend()
        M.set_virtual_devices(PAR_VIRTUAL, PAR_DEVICE)
        m = multihost.hybrid_mesh([("data", PAR_VIRTUAL)], [("replica", 1)])
        both = ("replica", "data")
        g = torch.Generator().manual_seed(SEED + 19)
        x = torch.randn(2 * PAR_VIRTUAL, 64, generator=g).to(PAR_DEVICE)
        y = torch.randn(PAR_VIRTUAL, PAR_VIRTUAL * 2, 8,
                        generator=g).to(PAR_DEVICE)
        q, k, v = (torch.randn(2, 16 * PAR_VIRTUAL, 64,
                               generator=g).to(PAR_DEVICE) for _ in range(3))
        checks = {
            "all_gather_merge": torch.equal(C.all_gather_merge(m, both)(x),
                                            x),
            "psum_reduce": torch.allclose(
                C.psum_reduce(m, both)(x),
                x.reshape(PAR_VIRTUAL, 2, 64).sum(0), atol=1e-4,
                rtol=1e-5),
            "ring_shift": torch.equal(C.ring_shift(m, both, 1)(x),
                                      torch.roll(x, 2, 0)),
            "all_to_all_regroup": torch.equal(
                C.all_to_all_regroup(m, both, 1, 0)(y), y)}
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            att = C.ring_attention(m, both)(q, k, v)
            ref = torch.softmax(q @ k.transpose(1, 2) / 8.0, -1) @ v
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        att_err = float((att - ref).abs().max())
        checks["ring_attention"] = att_err <= 1e-4
        if not all(checks.values()) or not all(
                t.device.type == PAR_DEVICE for t in (att,)):
            raise RuntimeError(f"parallel 19d: collectives {checks}, "
                               f"ring attention |diff| {att_err:.3e}")
        M.clear_virtual_devices()
        _par_zero()
        _, outs = serve_leg(True, pools, card, power, decoder=False,
                            warmup=0, n=SERVE_POOL,
                            mesh="dcn.data:1,data:-1")
        worst = _par_hold(_par_logits(outs), plain, SERVE_TOL,
                          "19d dcn pool")
        launches = _par_counts()
    finally:
        M.clear_virtual_devices()
        multihost.shutdown()
    print(f"parallel (d) one-rank {backend} world via multihost.initialize "
          f"in {time.perf_counter() - t0:.2f} s: collectives on "
          f"{PAR_DEVICE} tensors over replica(dcn):1 x data:{PAR_VIRTUAL} "
          f"{checks}, ring attention f32 |diff| {att_err:.3e}; pool "
          f"mesh=dcn.data:1,data:-1 logits against the unmeshed pool max "
          f"|diff| {worst:.3e}, launches {launches} [{card}, {power}]",
          flush=True)
    print("parallel (d) a two-rank world runs in the CPU tests only "
          "(gloo, tests/test_torch_multihost.py): NCCL puts one rank on "
          "one GPU", flush=True)
    return {"backend": backend, "collectives": checks,
            "ring_attention_max_abs_diff": att_err,
            "dcn_pool_max_abs_diff": worst, "launches": launches}


def par_lint(card: str, power: str):
    """19e: the analyzer over the descriptions phase 19 parsed."""
    from nnstreamer_tpu_torch.analyze import Severity, analyze_description
    from nnstreamer_tpu_torch.parallel import mesh as M

    descs = sorted({d for ph, d in LAUNCHED if ph == "19"})
    M.set_virtual_devices(PAR_VIRTUAL, PAR_DEVICE)
    try:
        tally, errors = Counter(), []
        for desc in descs:
            diags, _ = analyze_description(desc)
            for d in diags:
                tally[d.severity] += 1
                if d.severity == Severity.ERROR:
                    errors.append((desc, str(d)))
    finally:
        M.clear_virtual_devices()
    if errors:
        raise RuntimeError(f"parallel 19e: analyzer errors {errors}")
    print(f"parallel (e) the analyzer over phase 19's {len(descs)} distinct "
          f"descriptions: 0 errors, {tally[Severity.WARNING]} warnings, "
          f"{tally[Severity.INFO]} info [{card}, {power}]", flush=True)
    return {"descriptions": len(descs), "errors": 0,
            "warnings": tally[Severity.WARNING]}


def phase_parallel(card: str, power: str, phase8_fps=None):
    """Phase 19: (a)-(e) above; each leg's kernel counts from 0."""
    import torch

    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    register_vit("vit_serve", batch=1, image_size=VIT_SIZE, seed=SEED, **VIT)
    res = {}
    _par_zero()
    res["serving"], pools, plain = par_serving(card, power, phase8_fps)
    res["serving_launches"] = res["serving"]["launches"]
    M.set_virtual_devices(PAR_VIRTUAL, PAR_DEVICE)
    try:
        res["virtual_vit"] = par_virtual_vit(pools, plain, card, power)
        res["virtual_ssd"] = par_virtual_ssd(card, power)
        res["cascade"] = par_cascade(card, power)
    finally:
        M.clear_virtual_devices()
    res["multihost"] = par_multihost(pools, plain, card, power)
    res["lint"] = par_lint(card, power)
    fa = res["serving"]["launches"]["flash_attention"] + sum(
        r["pool_launches"]["flash_attention"] + r["window_flash_launches"]
        for r in res["virtual_vit"].values()) \
        + res["multihost"]["launches"]["flash_attention"]
    sbc = res["serving"]["launches"]["scale_bias_cast"] + sum(
        r["pool_launches"]["scale_bias_cast"]
        for r in res["virtual_vit"].values()) + sum(
        r["scale_bias_cast"] for r in res["virtual_ssd"].values()) \
        + res["multihost"]["launches"]["scale_bias_cast"]
    res["launches"] = {"flash_attention": fa, "scale_bias_cast": sbc}
    res["seconds"] = time.perf_counter() - t0
    print(f"parallel phase: {res['seconds']:.1f} s, launches "
          f"{res['launches']} [{card}, {power}]", flush=True)
    return res


# -- phase 20: in-pipeline training ------------------------------------------

TRAIN_DEVICE = "cuda"      # the pipelines' device (a CPU dry run: cpu)
TRAIN_SAMPLES = 1024       # (a): seeded uint8 samples in the dataset
TRAIN_SIZE = 224
TRAIN_CLASSES = 1001
TRAIN_WIDTH = 1.0
TRAIN_EPOCHS = 2
TRAIN_BATCH = 128          # 2 epochs of 8 steps
TRAIN_LR = 1e-2
TRAIN_PROFILED = (8, 11)   # (a): steps [8, 11) inside torch.profiler
TRAIN_ALONE_STEPS = 6      # (a): the step again, alone, on a card batch
TRAIN_ROWS = 8             # (a): the profile's top device rows printed
#: (b): the card's step against the CPU's (tests/test_torch_training.py's
#: sizes and lr): the first loss rtol, the later losses rtol, the leaves
#: atol (about 3x the largest card reading, 3.2e-5), and each leaf's
#: update gap ||Δcard − Δcpu|| / ||Δcpu|| by optimizer (the test's limits
#: against the JAX step)
TRAIN_SMALL = dict(width=0.25, size=32, classes=10, batch=16, lr=1e-4)
TRAIN_SMALL_TOL = dict(first_loss=1e-4, loss=5e-3, leaf=1e-4,
                       update_gap={"sgd": 0.1, "adam": 0.4, "adamw": 0.4})
TRAIN_SERVE_FRAMES = 32    # (d): frames each serving leg sees
TRAIN_WRITE_PIPE = ("appsrc name=src ! datareposink name=sink "
                    "location={data} json={js}")
TRAIN_PIPE = (
    "tensor_mux name=m ! tensor_trainer name=trn framework=torch-optim "
    "num-inputs=1 num-labels=1 num-training-samples={n} epochs={epochs} "
    "model-save-path={save} ! appsink name=out max-buffers={sink} "
    "datareposrc name=src location={data} json={js} epochs={epochs} "
    "is-shuffle=false ! tensor_demux name=d tensorpick=0,1 "
    "d.src_0 ! tensor_transform name=norm mode=arithmetic option={norm} "
    "backend=cuda ! m.sink_0 d.src_1 ! m.sink_1")
TRAIN_TOY_PIPE = (
    "appsrc name=src ! tensor_trainer name=trn framework=torch-optim "
    "num-inputs=1 num-labels=1 num-training-samples=32 epochs=3 ! "
    "appsink name=out max-buffers=128")
TRAIN_SERVE_PIPE = (
    "appsrc name=src ! tensor_transform name=norm mode=arithmetic "
    "option={norm} backend=cuda ! tensor_filter name={name} "
    "framework=torch-cuda model={model}{props} ! appsink name=out "
    "max-buffers={sink}")


def train_dataset(root: str):
    """(a)'s dataset through ``datareposink``: TRAIN_SAMPLES seeded uint8
    (1,S,S,3) samples with int32 labels in [0, TRAIN_CLASSES).  Returns
    the two paths and the first TRAIN_SERVE_FRAMES samples."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    data = os.path.join(root, "train.dat")
    js = os.path.join(root, "train.json")
    p = parse_launch(TRAIN_WRITE_PIPE.format(data=data, js=js),
                     device="cpu")
    s = TRAIN_SIZE
    p["src"].spec = TensorsSpec.parse(f"3:{s}:{s}:1,1:1", "uint8,int32")
    rng = np.random.default_rng(SEED)
    kept = []
    with p:
        for i in range(TRAIN_SAMPLES):
            x = rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8)
            y = rng.integers(0, TRAIN_CLASSES, (1, 1), dtype=np.int32)
            p["src"].push_buffer(Buffer.of(x, y))
            if i < TRAIN_SERVE_FRAMES:
                kept.append(x)
        p["src"].end_of_stream()
        if not p.wait_eos(timeout=600):
            raise RuntimeError("training: the dataset writer reached no EOS")
    return data, js, kept


def _norm_fold():
    """The transform's folded (scale, bias-over-scale) for NORM on uint8,
    as its kernel path computes them."""
    from nnstreamer_tpu_torch.core.types import DType
    from nnstreamer_tpu_torch.elements.transform import (_fold_affine,
                                                         parse_arith_ops)

    a, b, _ = _fold_affine(parse_arith_ops(NORM), DType.UINT8)
    return a, b / a


def _percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def train_full_width(root: str, data: str, js: str, kept, card: str,
                     power: str):
    """20a: MobileNetV1 at full width trained through ``datareposrc !
    (demux: the image through the CUDA normalize, the label as it is;
    mux) ! tensor_trainer``, 2 epochs at batch 128."""
    import pickle

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import nnstreamer_tpu_torch.parallel as par
    from nnstreamer_tpu_torch.elements.filter import FilterSingle
    from nnstreamer_tpu_torch.models.convert import mobilenet_v1_tree_apply
    from nnstreamer_tpu_torch.models.mobilenet import mobilenet_v1_init
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.runtime import parse_launch
    from nnstreamer_tpu_torch.utils.profile import GATE, stop_when_quiescent

    on_card = TRAIN_DEVICE == "cuda"
    # training under cuDNN's defaults; the bit-for-bit check below under
    # deterministic algorithms (earlier phases leave them set)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    save = os.path.join(root, "mnv1.pkl")
    p = parse_launch(TRAIN_PIPE.format(
        n=TRAIN_SAMPLES, epochs=TRAIN_EPOCHS, save=save, data=data, js=js,
        norm=NORM, sink=TRAIN_SAMPLES * TRAIN_EPOCHS + 8),
        device=TRAIN_DEVICE)
    # a dict model-config does not fit in a launch string: set before start
    p["trn"].model_config = {
        "apply": "nnstreamer_tpu_torch.models.convert:"
                 "mobilenet_v1_tree_apply",
        "init": lambda seed: mobilenet_v1_init(seed, TRAIN_CLASSES,
                                               TRAIN_WIDTH),
        "seed": SEED, "batch_size": TRAIN_BATCH, "optimizer": "sgd",
        "lr": TRAIN_LR, "mesh": "data:-1"}
    steps, losses, prof_box, events = [], [], {}, []

    class Profiled:
        """The trainer's step with the profiler window and the loss log
        around each call, on the trainer's worker thread; the profiler
        starts and stops with no other thread inside a torch op (the
        streaming thread launches the normalize meanwhile:
        utils/profile.py).  Every attribute is the step's."""

        def __init__(self, step):
            self.step = step

        def __getattr__(self, name):
            return getattr(self.step, name)

        def __call__(self, *args):
            step = self.step
            if step.steps == TRAIN_PROFILED[0] and on_card:
                prof_box["prof"] = profile(activities=[ProfilerActivity.CUDA])
                GATE.hold(prof_box["prof"].start, 60.0)
                prof_box["t0"] = time.perf_counter()
            out = step(*args)
            losses.append(float(step.last_loss))
            if step.steps == TRAIN_PROFILED[1] and "prof" in prof_box:
                torch.cuda.synchronize()
                prof_box["wall_ms"] = (time.perf_counter()
                                       - prof_box["t0"]) * 1e3
                stop_when_quiescent(prof_box["prof"].stop, 60.0)
            return out

    real = par.train_step

    def recording(*args, **kw):
        step, params, opt_state = real(*args, **kw)
        step.record_events = on_card
        steps.append(step)
        return Profiled(step), params, opt_state

    p.bus.add_watch(lambda m: events.append((time.perf_counter(),
                                             dict(m.data)))
                    if isinstance(m.data, dict) and "event" in m.data
                    else None)
    _par_zero()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    par.train_step = recording
    t0 = time.perf_counter()
    statuses = []
    try:
        p.start()
        if not p.wait_eos(timeout=900):
            raise RuntimeError("training (a): no EOS within 900 s")
        while True:
            b = p["out"].pull(timeout=0.5)
            if b is None:
                break
            statuses.append(b)
    finally:
        p.stop()
        par.train_step = real
        torch.backends.cudnn.deterministic = True
    wall_s = time.perf_counter() - t0
    launches = _par_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card \
        else float("nan")
    if p.error is not None:
        raise RuntimeError(f"training (a): pipeline error {p.error}")
    # -- holds ------------------------------------------------------------
    n_steps = TRAIN_EPOCHS * -(-TRAIN_SAMPLES // TRAIN_BATCH)
    if len(steps) != 1 or steps[0].steps != n_steps:
        raise RuntimeError(f"training (a): {len(steps)} step builds, "
                           f"{steps[0].steps if steps else 0} steps, not "
                           f"{n_steps}")
    if steps[0].device.type != TRAIN_DEVICE:
        raise RuntimeError(f"training (a): the step ran on "
                           f"{steps[0].device}")
    if len(losses) != n_steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"training (a): step losses {losses}")
    kinds = Counter(e["event"] for _, e in events)
    if kinds != Counter({"epoch-completion": TRAIN_EPOCHS,
                         "training-completion": 1}) or any(
            "error" in e for _, e in events):
        raise RuntimeError(f"training (a): events {events}")
    n_status = TRAIN_SAMPLES * TRAIN_EPOCHS
    bad = [b for b in statuses
           if b.num_tensors != 1 or b.tensors[0].shape != (1, 5)
           or b.tensors[0].dtype.np_dtype != np.float64]
    if len(statuses) != n_status or bad:
        raise RuntimeError(f"training (a): {len(statuses)} status buffers "
                           f"({len(bad)} not one (1,5) float64), not "
                           f"{n_status}")
    sbc = launches["scale_bias_cast"]
    if on_card and not n_status <= sbc <= n_status + 2 or \
            launches["flash_attention"]:
        raise RuntimeError(f"training (a): launches {launches}, want "
                           f"scale_bias_cast one a sample ({n_status}) and "
                           f"no flash_attention")
    epoch_t = [t for t, e in events if e["event"] == "epoch-completion"]
    epoch_losses = [e["training_loss"] for _, e in events
                    if e["event"] == "epoch-completion"]
    samples_per_s = TRAIN_SAMPLES / (epoch_t[1] - epoch_t[0])
    split = steps[0].timings()[1:] if on_card else []
    res = {"wall_s": wall_s, "steps": n_steps, "step_losses": losses,
           "epoch_losses": epoch_losses,
           "samples_per_s_epoch2": samples_per_s,
           "samples_per_s_epoch1": TRAIN_SAMPLES / (epoch_t[0] - t0),
           "peak_mib": peak_mib, "launches": launches,
           "status_buffers": len(statuses)}
    if split:
        for i, part in enumerate(("forward", "backward", "update")):
            ms = [s[i] for s in split]
            res[f"{part}_ms_p50"] = _percentile(ms, 0.5)
            res[f"{part}_ms_p90"] = _percentile(ms, 0.9)
        tot = [sum(s) for s in split]
        res["step_ms_p50"] = _percentile(tot, 0.5)
        res["step_ms_p90"] = _percentile(tot, 0.9)
        res["first_step_ms"] = sum(steps[0].timings()[0])
    prof = prof_box.get("prof")
    if prof is not None:
        busy, span, _ = device_busy(prof.events())
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
        if busy <= 0 or not rows:
            print("training (a) profile: torch.profiler recorded no device "
                  "kernels; busy share not measured", flush=True)
        else:
            res["profile"] = {"busy_ms": busy, "span_ms": span,
                              "wall_ms": prof_box["wall_ms"],
                              "busy_share": busy / prof_box["wall_ms"]}
            for e in rows[:TRAIN_ROWS]:
                print(f"training (a) profile: "
                      f"{e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.self_device_time_total / 1e3 / busy:6.1%} "
                      f"n={e.count:5d} {e.key[:100]}", flush=True)
    # -- the path's kernel against its plain version, at the path's shape -
    a, b = _norm_fold()
    x0 = torch.from_numpy(kept[0]).to(TRAIN_DEVICE)
    with torch.no_grad():
        y0 = kernels.scale_bias_cast(x0, a, b)
    res["max_abs_err"] = float((y0 - kernels.scale_bias_cast_reference(
        x0, a, b)).abs().max())
    if res["max_abs_err"] > 0:
        raise RuntimeError(f"training (a): scale_bias_cast differs from its "
                           f"plain version by {res['max_abs_err']}")
    # -- the saved model served: logits bit for bit ----------------------
    with open(save, "rb") as f:
        blob = pickle.load(f)
    tree = blob["params"]
    xs = torch.cat([kernels.scale_bias_cast_reference(
        torch.from_numpy(k).to(TRAIN_DEVICE), a, b) for k in kept[:8]])
    fs = FilterSingle(framework="torch-cuda", model=save,
                      device=TRAIN_DEVICE)
    try:
        got = fs.invoke([xs])[0]
    finally:
        fs.close()

    def placed(t):
        if isinstance(t, dict):
            return {k: placed(v) for k, v in t.items()}
        if isinstance(t, list):
            return [placed(v) for v in t]
        return torch.from_numpy(t).to(TRAIN_DEVICE)

    with torch.no_grad():
        want = mobilenet_v1_tree_apply(placed(tree), xs)
    if not torch.equal(got, want):
        raise RuntimeError(f"training (a): the saved model's logits differ "
                           f"from mobilenet_v1_tree_apply by "
                           f"{float((got - want).abs().max())}")
    # -- the same step alone: one batch already on the card, no data path
    # beside it (its first step discarded) — what the pipeline's
    # streaming thread costs the step
    rs = np.random.default_rng(SEED + 1)
    xb = torch.from_numpy(rs.standard_normal(
        (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.float32)).to(
        TRAIN_DEVICE)
    yb = torch.from_numpy(rs.integers(0, TRAIN_CLASSES, TRAIN_BATCH).astype(
        np.int32)).to(TRAIN_DEVICE)
    step = steps[0]
    step.events.clear()
    torch.backends.cudnn.deterministic = False
    params, opt_state = step.params, step.opt_state
    t1 = time.perf_counter()
    for _ in range(TRAIN_ALONE_STEPS):
        params, opt_state, loss = step(params, opt_state, xb, yb)
        float(loss)     # the trainer reads each loss too
    res["alone_host_ms"] = (time.perf_counter() - t1) * 1e3 \
        / TRAIN_ALONE_STEPS
    alone = step.timings()[1:]
    if alone:
        for i, part in enumerate(("forward", "backward", "update")):
            res[f"alone_{part}_ms_p50"] = _percentile(
                [a[i] for a in alone], 0.5)
        res["alone_step_ms_p50"] = _percentile([sum(a) for a in alone],
                                               0.5)
    torch.backends.cudnn.deterministic = det
    res["tree"] = tree
    msg = (f"training (a): MobileNetV1 w{TRAIN_WIDTH} {TRAIN_SIZE}x"
           f"{TRAIN_SIZE} {TRAIN_CLASSES} classes, {TRAIN_SAMPLES} samples x "
           f"{TRAIN_EPOCHS} epochs at batch {TRAIN_BATCH}: {n_steps} steps, "
           f"every loss finite, epoch losses {epoch_losses}, "
           f"{len(statuses)} (1,5) f64 status buffers, "
           f"{TRAIN_EPOCHS} epoch events + 1 completion; samples/s "
           f"{samples_per_s:.1f} (epoch 2), {res['samples_per_s_epoch1']:.1f}"
           f" (epoch 1, with the first step's warm-up); peak card memory "
           f"{peak_mib:.1f} MiB; launches {launches}; scale_bias_cast at "
           f"{tuple(x0.shape)} uint8 vs plain {res['max_abs_err']}; the "
           f"saved .pkl through FilterSingle bit-equal to "
           f"mobilenet_v1_tree_apply on 8 frames")
    if split:
        msg += (f"; step ms p50/p90 (steps 2-{n_steps}, CUDA events): "
                f"forward {res['forward_ms_p50']:.3f}/"
                f"{res['forward_ms_p90']:.3f}, backward "
                f"{res['backward_ms_p50']:.3f}/{res['backward_ms_p90']:.3f}, "
                f"update {res['update_ms_p50']:.3f}/"
                f"{res['update_ms_p90']:.3f}, whole "
                f"{res['step_ms_p50']:.3f}/{res['step_ms_p90']:.3f}; first "
                f"step {res['first_step_ms']:.3f}; the step alone on a card "
                f"batch (p50 of {TRAIN_ALONE_STEPS - 1}): forward "
                f"{res['alone_forward_ms_p50']:.3f}, backward "
                f"{res['alone_backward_ms_p50']:.3f}, update "
                f"{res['alone_update_ms_p50']:.3f}, whole "
                f"{res['alone_step_ms_p50']:.3f} ms (host "
                f"{res['alone_host_ms']:.3f} ms a step)")
    if "profile" in res:
        pr = res["profile"]
        msg += (f"; steps {TRAIN_PROFILED[0] + 1}-{TRAIN_PROFILED[1]} "
                f"profiled: device busy {pr['busy_ms']:.3f} ms of "
                f"{pr['wall_ms']:.3f} ms wall (busy share "
                f"{pr['busy_share']:.3f}), kernel span {pr['span_ms']:.3f} ms")
    print(msg + f" [{card}, {power}]", flush=True)
    return res


def train_card_vs_cpu(card: str, power: str):
    """20b: three train_step steps of each optimizer on the card and on
    the CPU (width 0.25, 32x32, 10 classes, batch 16, f32, TF32 off)."""
    import functools

    import torch

    from nnstreamer_tpu_torch.models.convert import mobilenet_v1_tree_apply
    from nnstreamer_tpu_torch.models.mobilenet import mobilenet_v1_init
    from nnstreamer_tpu_torch.parallel import mesh as M
    from nnstreamer_tpu_torch.parallel.sharded import (train_step,
                                                       trained_tree)
    from nnstreamer_tpu_torch.trainers.torch_optim import _make_optimizer

    sm = TRAIN_SMALL
    rng = np.random.default_rng(SEED + 3)
    xs = rng.standard_normal((3, sm["batch"], sm["size"], sm["size"], 3)
                             ).astype(np.float32)
    ys = rng.integers(0, sm["classes"], (3, sm["batch"])).astype(np.int32)
    tree = mobilenet_v1_init(SEED, sm["classes"], sm["width"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(dev, name, dtype):
        step, params, opt = train_step(
            M.make_mesh("data:1", M.local_devices(dev)[:1]),
            functools.partial(mobilenet_v1_tree_apply, dtype=dtype), tree,
            optimizer=_make_optimizer({"optimizer": name, "lr": sm["lr"]}))
        losses = []
        for x, y in zip(xs, ys):
            params, opt, loss = step(params, opt, x, y)
            losses.append(float(loss))
        return losses, trained_tree(params)

    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k])
        elif isinstance(t, list):
            for v in t:
                yield from leaves(v)
        else:
            yield t

    res = {}
    try:
        for name in ("sgd", "adam", "adamw"):
            (lc, tc), (lh, th) = (run(TRAIN_DEVICE, name, torch.float32),
                                  run("cpu", name, torch.float32))
            rels = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
            diffs = np.concatenate([np.abs(a - b).ravel() for a, b in
                                    zip(leaves(tc), leaves(th))])
            gaps = []
            for a, b, i0 in zip(leaves(tc), leaves(th), leaves(tree)):
                nb = np.linalg.norm(b - i0)
                gaps.append(np.linalg.norm(a - b) / nb if nb else
                            (0.0 if np.array_equal(a, b) else np.inf))
            res[name] = {"first_loss_rel": rels[0], "loss_rel": max(rels),
                         "leaf_max": float(diffs.max()),
                         "update_gap": float(max(gaps)),
                         "within_1e-6": float((diffs <= 1e-6).mean())}
            if rels[0] > TRAIN_SMALL_TOL["first_loss"] or \
                    max(rels) > TRAIN_SMALL_TOL["loss"] or \
                    diffs.max() > TRAIN_SMALL_TOL["leaf"] or \
                    max(gaps) > TRAIN_SMALL_TOL["update_gap"][name]:
                raise RuntimeError(
                    f"training (b) {name}: card vs CPU loss rel {rels}, "
                    f"leaf max {diffs.max()}, update gap {max(gaps)} "
                    f"(limits {TRAIN_SMALL_TOL})")
        lc, _ = run(TRAIN_DEVICE, "sgd", torch.bfloat16)
        lh, _ = run("cpu", "sgd", torch.bfloat16)
        res["bf16_loss_max_diff"] = max(abs(a - b) for a, b in zip(lc, lh))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    print("training (b): 3 steps of MobileNetV1 w0.25 32x32 batch 16 f32 "
          "(TF32 off, lr 1e-4), card vs CPU: " + "; ".join(
              f"{n} first loss rel {r['first_loss_rel']:.3e}, losses rel "
              f"{r['loss_rel']:.3e}, leaves max "
              f"{r['leaf_max']:.3e} ({r['within_1e-6']:.4f} of entries "
              f"within 1e-6), largest leaf update gap {r['update_gap']:.3e}"
              for n, r in res.items() if n != "bf16_loss_max_diff")
          + f"; at bf16 (sgd) the largest loss difference "
          f"{res['bf16_loss_max_diff']:.3e} [{card}, {power}]", flush=True)
    return res


def toy_apply(params, x, train=False):
    """20c's model: ``tests/test_training.py``'s linear toy."""
    return x @ params["w"] + params["b"]


def train_toy(card: str, power: str):
    """20c: ``tests/test_training.py``'s learnable toy case on the card:
    3 epochs of 32 separable samples, sgd at lr 0.5; the epoch losses
    fall."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch(TRAIN_TOY_PIPE, device=TRAIN_DEVICE)
    p["src"].spec = TensorsSpec.parse("8:1,1:1", "float32,int32")
    p["trn"].model_config = {
        "apply": toy_apply,
        "init": {"w": np.zeros((8, 2), np.float32),
                 "b": np.zeros((2,), np.float32)},
        "batch_size": 8, "lr": 0.5, "optimizer": "sgd", "mesh": "data:-1"}
    losses = []
    p.bus.add_watch(lambda m: losses.append(m.data["training_loss"])
                    if isinstance(m.data, dict)
                    and m.data.get("event") == "epoch-completion" else None)
    rng = np.random.default_rng(1)
    stats = []
    with p:
        for _ in range(3):
            for i in range(32):
                y = i % 2
                x = rng.standard_normal(8).astype(np.float32) + \
                    (3.0 if y else -3.0)
                p["src"].push_buffer(Buffer.of(
                    x.reshape(1, 8), np.array([[y]], np.int32)))
        p["src"].end_of_stream()
        if not p.wait_eos(timeout=120):
            raise RuntimeError("training (c): no EOS")
        while True:
            b = p["out"].pull(timeout=0.3)
            if b is None:
                break
            stats.append(b)
    if len(losses) != 3 or not losses[0] > 0 or \
            not losses[-1] < losses[0] or len(stats) != 96:
        raise RuntimeError(f"training (c): epoch losses {losses}, "
                           f"{len(stats)} status buffers")
    print(f"training (c): the toy's epoch losses {losses} fall, 96 status "
          f"buffers [{card}, {power}]", flush=True)
    return {"epoch_losses": losses}


def train_served(root: str, tree, kept, card: str, power: str):
    """20d: (a)'s tree as step 16 of a checkpoint root, swapped into a
    shared MobileNetV1 pool serving the untrained tree."""
    import pickle

    import torch

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.models.mobilenet import mobilenet_v1_init
    from nnstreamer_tpu_torch.runtime import parse_launch
    from nnstreamer_tpu_torch.trainers.checkpoint import save_step

    torch.backends.cudnn.deterministic = True
    ckpts = os.path.join(root, "ckpts")
    save_step(ckpts, 16, tree)
    models = {}
    for tag, params in (("init", mobilenet_v1_init(SEED, TRAIN_CLASSES,
                                                   TRAIN_WIDTH)),
                        ("trained", tree)):
        models[tag] = os.path.join(root, f"serve_{tag}.pkl")
        with open(models[tag], "wb") as f:
            pickle.dump({"apply": "nnstreamer_tpu_torch.models.convert:"
                                  "mobilenet_v1_tree_apply",
                         "params": params,
                         "in_shapes": [(1, TRAIN_SIZE, TRAIN_SIZE, 3)],
                         "in_dtypes": np.dtype("float32")}, f)
    spec = TensorsSpec.parse(f"3:{TRAIN_SIZE}:{TRAIN_SIZE}:1", "uint8")

    def serve(p, frames, first):
        outs = []
        for i, x in enumerate(frames):
            p["src"].push_buffer(Buffer.of(x, pts=first + i))
        for _ in frames:
            b = p["out"].pull(timeout=120)
            if b is None:
                raise RuntimeError("training (d): a frame was lost")
            outs.append(b.tensors[0].torch().reshape(-1).clone())
        return outs

    ref = parse_launch(TRAIN_SERVE_PIPE.format(
        name="alone", norm=NORM, model=models["trained"], props="",
        sink=TRAIN_SERVE_FRAMES + 4), device=TRAIN_DEVICE)
    ref["src"].spec = spec
    with ref:
        want = serve(ref, kept, 0)
    pipe = parse_launch(TRAIN_SERVE_PIPE.format(
        name="net", norm=NORM, model=models["init"],
        props=" share-model=true is-updatable=true",
        sink=TRAIN_SERVE_FRAMES + 4), device=TRAIN_DEVICE)
    pipe["src"].spec = spec
    with pipe:
        before = serve(pipe, kept, 0)
        lc = pipe["net"].pool.lifecycle
        t0 = time.perf_counter()
        ver = lc.stage(f"{ckpts}@latest")
        stage_s = time.perf_counter() - t0
        lc.swap(ver)
        after = serve(pipe, kept, len(kept))
    if lc.baseline.tag != "16" or lc.swaps != 1:
        raise RuntimeError(f"training (d): version {lc.baseline.tag}, "
                           f"{lc.swaps} swaps")
    worst = max(float((a - w).abs().max()) for a, w in zip(after, want))
    labels = [int(a.argmax()) for a in after]
    if labels != [int(w.argmax()) for w in want] or worst > SERVE_TOL:
        raise RuntimeError(f"training (d): after the flip labels {labels} "
                           f"against {[int(w.argmax()) for w in want]}, "
                           f"logits {worst} apart")
    changed = sum(int(b.argmax()) != lab for b, lab in zip(before, labels))
    res = {"version": lc.baseline.tag, "stage_s": stage_s,
           "load_s": ver.load_s, "swap_stall_s": lc.last_swap_stall_s,
           "frames": 2 * len(kept), "max_abs_diff": worst,
           "labels_changed_by_training": changed}
    print(f"training (d): a share-model MobileNetV1 pool at full width "
          f"staged {ckpts}@latest (step 16) in {stage_s:.6f} s (load+place+"
          f"warm {ver.load_s:.6f} s), flip stall "
          f"{lc.last_swap_stall_s * 1e3:.6f} ms; version tag "
          f"{lc.baseline.tag}; {len(kept)} frames after the flip carry the "
          f"trained tree's labels (logits within {worst} of the trained "
          f"model alone), {changed} of them differ from the untrained "
          f"tree's [{card}, {power}]", flush=True)
    return res


def train_grad_guard(card: str, power: str):
    """20e: both wrappers refuse a card input that requires grad under
    grad mode, and launch under no_grad."""
    import torch

    from nnstreamer_tpu_torch.ops import kernels

    x = torch.rand(2, 8, 8, 3, device=TRAIN_DEVICE, requires_grad=True)
    q = torch.randn(1, 2, 64, 64, device=TRAIN_DEVICE,
                    dtype=torch.bfloat16, requires_grad=True)
    refused = []
    for name, call in (("scale_bias_cast",
                        lambda: kernels.scale_bias_cast(x, 2.0, 1.0)),
                       ("flash_attention",
                        lambda: kernels.flash_attention(q, q, q))):
        try:
            call()
        except RuntimeError as e:
            if name in str(e):
                refused.append(name)
    n0 = _par_counts()
    with torch.no_grad():
        kernels.scale_bias_cast(x, 2.0, 1.0)
        kernels.flash_attention(q, q, q)
    if TRAIN_DEVICE == "cuda":
        torch.cuda.synchronize()
    launched = {k: v - n0[k] for k, v in _par_counts().items()}
    want = 1 if TRAIN_DEVICE == "cuda" else 0
    if refused != ["scale_bias_cast", "flash_attention"] and want or \
            launched != {"flash_attention": want, "scale_bias_cast": want}:
        raise RuntimeError(f"training (e): refused {refused}, launched "
                           f"under no_grad {launched}")
    print(f"training (e): both wrappers refuse a card input that requires "
          f"grad ({refused}) and launch under no_grad ({launched}) "
          f"[{card}, {power}]", flush=True)
    return {"refused": refused, "launched": launched}


def train_lint(card: str, power: str):
    """20f: the analyzer over the descriptions phase 20 parsed."""
    from nnstreamer_tpu_torch.analyze import Severity, analyze_description

    descs = sorted({d for ph, d in LAUNCHED if ph == "20"})
    tally, errors = Counter(), []
    for desc in descs:
        diags, _ = analyze_description(desc)
        for d in diags:
            tally[d.severity] += 1
            if d.severity == Severity.ERROR:
                errors.append((desc, str(d)))
    if errors:
        raise RuntimeError(f"training (f): analyzer errors {errors}")
    print(f"training (f): the analyzer over phase 20's {len(descs)} distinct "
          f"descriptions: 0 errors, {tally[Severity.WARNING]} warnings, "
          f"{tally[Severity.INFO]} info [{card}, {power}]", flush=True)
    return {"descriptions": len(descs), "errors": 0,
            "warnings": tally[Severity.WARNING]}


def phase_training(card: str, power: str):
    """Phase 20: (a)-(f) above; (a)'s kernel counts from 0."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nns_train_")
    res = {}
    try:
        data, js, kept = train_dataset(root)
        res["dataset_s"] = time.perf_counter() - t0
        res["full_width"] = train_full_width(root, data, js, kept, card,
                                             power)
        tree = res["full_width"].pop("tree")
        res["launches"] = res["full_width"]["launches"]
        res["card_vs_cpu"] = train_card_vs_cpu(card, power)
        res["toy"] = train_toy(card, power)
        res["served"] = train_served(root, tree, kept, card, power)
        res["grad_guard"] = train_grad_guard(card, power)
        res["lint"] = train_lint(card, power)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"training phase: {res['seconds']:.1f} s (the dataset "
          f"{res['dataset_s']:.1f} s), launches {res['launches']} "
          f"[{card}, {power}]", flush=True)
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels-per-forward":
        return count_forward_kernels(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--serving-legs":
        return serving_legs(sys.argv[2])
    if sys.argv[1:] == ["--obs-detect-child"]:
        return obs_detect_child()
    if sys.argv[1:] == ["--control-disabled-child"]:
        return ctl_disabled_child()
    if len(sys.argv) == 3 and sys.argv[1] == "--edge-server-child":
        return edge_server_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--mqtt-pub-child":
        return mqtt_pub_child(sys.argv[2])
    alone = sys.argv[1:] == ["--decoders"]
    elements_alone = sys.argv[1:] == ["--elements"]
    obs_alone = sys.argv[1:] == ["--obs"]
    control_alone = sys.argv[1:] == ["--control"]
    repairs_alone = sys.argv[1:] == ["--repairs"]
    edge_alone = sys.argv[1:] == ["--edge"]
    mqtt_alone = sys.argv[1:] == ["--mqtt"]
    parallel_alone = sys.argv[1:] == ["--parallel"]
    training_alone = sys.argv[1:] == ["--training"]
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

    if sys.argv[1:] == ["--control-lockdep-child"]:
        return ctl_lockdep_child()
    record_launches()
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
    if control_alone:
        print(json.dumps({"control": phase_control(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if repairs_alone:
        PHASE[0] = "16"
        print(json.dumps({"repairs": phase_repairs(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if edge_alone:
        PHASE[0] = "17"
        print(json.dumps({"edge": phase_edge(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if mqtt_alone:
        PHASE[0] = "18"
        print(json.dumps({"mqtt": phase_mqtt(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if parallel_alone:
        PHASE[0] = "19"
        print(json.dumps({"parallel": phase_parallel(card, power),
                          "card": card, "power_limit": power}))
        return 0
    if training_alone:
        PHASE[0] = "20"
        print(json.dumps({"training": phase_training(card, power),
                          "card": card, "power_limit": power}))
        return 0
    worst, (ms, plain_ms, bound_ms) = phase_kernels(card, power)
    fa_worst, fa = phase_flash_attention(card, power)
    PHASE[0] = "4"
    main_path = phase_main_path(card, power)
    PHASE[0] = "5"
    phase_profile(composite("ssd_mobilenet_v2", "cuda", 3),
                  main_path.pop("frames"), card, power)
    PHASE[0] = "6"
    phase_reference(main_path.pop("model"), main_path.pop("anchors"))
    PHASE[0] = "7"
    vit_path = phase_vit(card, power)
    PHASE[0] = "8"
    serving = phase_serving(card, power)
    PHASE[0] = "9"
    lifecycle = phase_lifecycle(card, power)
    PHASE[0] = "10"
    classify = phase_classify(card, power)
    PHASE[0] = "11"
    yolo = phase_yolo(card, power)
    PHASE[0] = "12"
    decoders = phase_decoders(card, power)
    PHASE[0] = "13"
    elements = phase_elements(card, power)
    PHASE[0] = "14"
    obs = phase_obs(card, power, serving["shared"])
    PHASE[0] = "15"
    control = phase_control(card, power)
    PHASE[0] = "16"
    repairs = phase_repairs(card, power)
    PHASE[0] = "17"
    edge = phase_edge(card, power)
    PHASE[0] = "18"
    mqtt = phase_mqtt(card, power)
    PHASE[0] = "19"
    parallel = phase_parallel(card, power,
                              serving["shared"]["frames_per_s"])
    PHASE[0] = "20"
    training = phase_training(card, power)

    print(json.dumps({"main_path": main_path, "vit_path": vit_path,
                      "serving": serving, "lifecycle": lifecycle,
                      "classify": classify, "yolo": yolo,
                      "decoders": decoders, "elements": elements,
                      "obs": obs, "control": control, "repairs": repairs,
                      "edge": edge, "mqtt": mqtt, "parallel": parallel,
                      "training": training,
                      "card": card, "power_limit": power}, default=str))
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
                   "obs_detection": obs["detection"]["launches"],
                   "control": control["launches"]["scale_bias_cast"],
                   "repairs_prefetch": repairs["prefetch"]["launches"],
                   "edge_offload_server": edge["offload"]["launches"],
                   "edge_devch": edge["devch"]["launches"],
                   "edge_vit": edge["vit"]["launches"]["scale_bias_cast"],
                   "mqtt_camera": mqtt["camera"]["launches"],
                   "mqtt_vit": mqtt["vit"]["launches"]["scale_bias_cast"],
                   "parallel": parallel["launches"]["scale_bias_cast"],
                   "training": training["launches"]["scale_bias_cast"]}
    if mqtt["grpc"]["ran"]:
        sbc_by_path["mqtt_grpc"] = mqtt["grpc"]["launches"]
    fa_by_path = {"vit": vit_path["flash_launches"],
                  "serving_shared": served["shared"]["flash_attention"],
                  "serving_unshared": served["unshared"]["flash_attention"],
                  "lifecycle": lifecycle["launches"]["flash_attention"],
                  "obs_vit_serving": obs["vit_serving"]["launches"][
                      "flash_attention"],
                  "control": control["launches"]["flash_attention"],
                  "repairs_single": repairs["single"]["launches"],
                  "edge_vit": edge["vit"]["launches"]["flash_attention"],
                  "mqtt_vit": mqtt["vit"]["launches"]["flash_attention"],
                  "parallel": parallel["launches"]["flash_attention"],
                  "training": training["launches"]["flash_attention"]}
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
