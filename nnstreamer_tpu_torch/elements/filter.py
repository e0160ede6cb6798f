"""``tensor_filter`` — the NN invoke element.

Counterpart of the JAX package's ``elements/filter.py`` (parity: the
reference's tensor_filter.c hot path, throttling and stats, and
tensor_filter_common.c open_fw): open the framework, negotiate (including
the SET_INPUT_INFO reshape and the fused prologue/epilogue from
runtime/fusion.py), and invoke — once per buffer, once per micro-batched
window (``batch=``, runtime/batching.py), or through a model shared by
many pipelines (``share-model=true``, runtime/serving.py).  Inputs are
handed to the sub-plugin as tensors on its device (a host numpy
framework, ``HOST_INVOKE``, gets the buffer's tensors as numpy arrays
through one packed device→host copy); PyTorch launches the work
asynchronously, so the streaming thread runs ahead of the card, and only
a sampled dispatch (at most one a ``stat-sample-interval-ms``) waits for
it to time the invoke.

Model lifecycle: ``is-updatable=true`` lets a RELOAD_MODEL event swap the
model — through the pool's lifecycle (``PoolEntry.reload_model``: staged
and warmed off the dispatch path, flipped at a window boundary or
canaried per the pool-level ``canary=<tag>:1/N``) for a pooled filter,
through the sub-plugin's ``prepare_swap``/``commit_swap`` otherwise;
errors go to the bus.  ``custom=donate`` marks the tensors each dispatch
was handed as donated, so a later read raises.

Observability and faults: ``latency=1`` makes every dispatch a blocking
sample, ``latency-report=true`` posts LATENCY bus messages when the mean
moves past ±25% (``utils/stats.py``), a sampled dispatch's host-prep /
device / host-drain split goes to the registry's ``nns_invoke_*``
histograms and the tracer; ``tenant=`` names who a pooled stream's frames
are billed to (``obs/tenantstat.py``); ``chaos=<spec>`` scopes a fault
plan to this element (``chaos/plan.py``), besides the process-wide
``NNS_TPU_TORCH_CHAOS``; the model name keys the cost rows
(``obs/xlacost.py``).

Not in this slice (later work): mesh placement and pipeline-stage
handoff.
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Any, List, Optional

from ..chaos import hooks as _chaos_hooks
from ..chaos.plan import FaultPlan, apply_invoke_fault
from ..core import Buffer, Caps, Tensor, TensorFormat, TensorsSpec
from ..decoders import drain_once
from ..filters.api import FilterError, FilterProps, FilterSubplugin
from ..filters.registry import detect_framework, find_filter
from ..runtime.element import Element, NegotiationError, Pad, StreamError
from ..obs import hooks as _hooks
from ..obs import transfer as _xfer
from ..obs.tracer import TRACE_META_KEY
from ..runtime.events import Event, EventKind, Message, MessageKind
from ..runtime.registry import register_element
from ..utils.stats import STAT_SAMPLE_INTERVAL, DispatchSampler, InvokeStats


def _parse_combination(s: str) -> Optional[List[int]]:
    if not s:
        return None
    return [int(x) for x in str(s).split(",") if str(x).strip() != ""]


@register_element("tensor_filter")
class TensorFilter(Element):
    FACTORY = "tensor_filter"

    def __init__(self, name=None, framework: str = "auto", model: Any = None,
                 accelerator: str = "", custom: str = "",
                 input_combination: str = "", output_combination: str = "",
                 invoke_dynamic: bool = False, is_updatable: bool = False,
                 shared_tensor_filter_key: str = "", latency: int = 0,
                 latency_report: bool = False, inputtype: str = "",
                 input: str = "", outputtype: str = "", output: str = "",
                 batch: int = 1, batch_timeout_ms: float = 1.0,
                 batch_buckets: str = "", share_model: bool = False,
                 stat_sample_interval_ms: Optional[float] = None,
                 priority: str = "normal", deadline_ms: float = 0.0,
                 slo_ms: float = 0.0, queue_limit: int = 0,
                 canary: str = "", tenant: str = "", chaos: str = "",
                 **props):
        self.framework = framework
        self.model = model
        self.accelerator = accelerator
        self.custom = custom
        self.input_combination = input_combination
        self.output_combination = output_combination
        self.invoke_dynamic = invoke_dynamic
        # RELOAD_MODEL allowed (hot swap; pooled: through the lifecycle)
        self.is_updatable = is_updatable
        self.shared_tensor_filter_key = shared_tensor_filter_key
        self.latency = latency          # 1 = every dispatch a sample
        self.latency_report = latency_report  # LATENCY bus messages
        self.inputtype, self.input = inputtype, input
        self.outputtype, self.output = outputtype, output
        # dynamic micro-batching (runtime/batching.py): batch>1 coalesces
        # in-flight buffers into ONE program call per window; buckets
        # bound the set of window shapes; timeout bounds added latency
        self.batch = batch
        self.batch_timeout_ms = batch_timeout_ms
        self.batch_buckets = batch_buckets
        # shared-model serving (runtime/serving.py): share-model=true
        # attaches this element to the process-wide ModelPool — N filters
        # on the same model share ONE sub-plugin instance (one weight
        # copy) and, with batch>1, one CROSS-pipeline coalescing window
        self.share_model = share_model
        # cadence of the blocking latency sample — None = the default
        # utils.stats.STAT_SAMPLE_INTERVAL
        self.stat_sample_interval_ms = stat_sample_interval_ms
        # SLO-aware admission (runtime/admission.py, share-model only):
        # priority names this STREAM's class (high/normal/low),
        # deadline-ms its per-frame deadline (0 = the pool SLO),
        # queue-limit bounds its parked frames (0 = 16x batch); slo-ms
        # is POOL-level — >0 arms the admission controller
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.slo_ms = slo_ms
        self.queue_limit = queue_limit
        # canary="<version>:1/N" (or "1/N") is POOL-level: a reload stages
        # the new version and routes 1-in-N of the pool's streams to it
        self.canary = canary
        # tenant attribution (obs/tenantstat.py, share-model only): who
        # this STREAM's frames are billed to; "" = "default"
        self.tenant = tenant
        # a fault plan scoped to THIS element (chaos/plan.py grammar);
        # the process-wide NNS_TPU_TORCH_CHAOS plan applies regardless
        self.chaos = chaos
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self.subplugin: Optional[FilterSubplugin] = None
        self.in_spec: Optional[TensorsSpec] = None
        self.out_spec: Optional[TensorsSpec] = None
        self.invoke_stats = InvokeStats()
        self._sampler = DispatchSampler(self.invoke_stats)
        self._in_combi = None
        self._out_combi = None
        self._throttle_interval = 0.0
        self._last_invoke_ts = 0.0
        self._dyn_spec: Optional[TensorsSpec] = None
        self._fused_pre: list = []  # op chains inlined by runtime/fusion.py
        self._fused_post: list = []  # epilogue fns (decoder overlay fusion)
        self._fused_post_decoder = None  # Decoder obj to notify on unfuse
        self._batcher = None         # MicroBatcher when batch>1 (start())
        self._buckets: tuple = (1,)
        self._pool_entry = None      # serving.PoolEntry (share-model=true)
        self._pool_attached = False  # registered as a live pool stream
        self._pool_batched = False   # frames go through the SharedBatcher
        self._chaos_plan = None      # parsed from the chaos= prop (start)

    # -- open ----------------------------------------------------------------

    def _user_spec(self, dims: str, types: str) -> Optional[TensorsSpec]:
        if not dims or not types:
            return None
        return TensorsSpec.parse(dims, types)

    def open_fw(self) -> None:
        """Resolve framework + configure the sub-plugin (parity:
        gst_tensor_filter_common_open_fw)."""
        if self.subplugin is not None:
            return
        fw_name = self.framework or "auto"
        if fw_name == "auto":
            fw_name = detect_framework(self.model)
        cls = find_filter(fw_name)
        fprops = FilterProps(
            framework=fw_name, model=self.model,
            accelerator=self.accelerator, custom=self.custom,
            input_spec=self._user_spec(self.input, self.inputtype),
            output_spec=self._user_spec(self.output, self.outputtype),
            device=self.device,
            shared_key=self.shared_tensor_filter_key or None,
            is_updatable=bool(self.is_updatable))
        if self.share_model:
            if self.invoke_dynamic:
                raise ValueError(
                    f"{self.name}: share-model=true cannot combine with "
                    "invoke-dynamic (per-buffer reshapes would rebuild the "
                    "shared instance under every sharer)")
            from ..runtime.serving import MODEL_POOL, pool_key

            self._pool_entry = MODEL_POOL.acquire(
                pool_key(fw_name, fprops),
                lambda: cls.open_shared(fprops), cls.close_shared)
            self.subplugin = self._pool_entry.subplugin
        else:
            sp = cls()
            sp.configure(fprops)
            if self._fused_pre and hasattr(sp, "set_fused_pre"):
                sp.set_fused_pre(self._fused_pre)
            if self._fused_post and hasattr(sp, "set_fused_post"):
                sp.set_fused_post(self._fused_post)
            self.subplugin = sp
        self.in_spec, self.out_spec = self.subplugin.get_model_info()
        mn = getattr(self.subplugin, "model_name", None)
        if callable(mn):
            # obs join key: this element's nns_invoke_device_seconds
            # series measures this model's programs (obs/xlacost.py)
            from ..obs import xlacost as _xlacost

            _xlacost.map_source(self.name, mn())
        self._in_combi = _parse_combination(self.input_combination)
        # output-combination tokens: iN (input passthrough) / oN (model out)
        self._out_combi = [t.strip() for t in str(
            self.output_combination).split(",") if t.strip()] or None

    def start(self) -> None:
        b = int(self.batch or 1)
        if str(self.chaos or "").strip():
            self._chaos_plan = FaultPlan.parse(str(self.chaos))
        if self._pool_entry is not None:
            # shared-model serving: this element becomes one STREAM of
            # the pool entry.  batch* properties are pool-level — the
            # attach validates them against the settings other sharers
            # fixed, and raises on conflict (caught by Pipeline.start).
            self._pool_batched = self._pool_entry.attach(
                self, b, float(self.batch_timeout_ms), self.batch_buckets,
                slo_ms=float(self.slo_ms or 0.0),
                priority=self.priority,
                deadline_ms=float(self.deadline_ms or 0.0),
                queue_limit=int(self.queue_limit or 0),
                canary=str(self.canary or ""),
                tenant=str(self.tenant or ""))
            self._pool_attached = True
            return
        if b <= 1:
            return
        if self.invoke_dynamic:
            raise ValueError(
                f"{self.name}: batch={b} requires static shapes; "
                "invoke-dynamic streams reshape per buffer and cannot "
                "share a bucketed window")
        from ..runtime.batching import MicroBatcher, parse_buckets

        self._buckets = parse_buckets(self.batch_buckets, b)
        self._batcher = MicroBatcher(
            max_batch=b, timeout_s=float(self.batch_timeout_ms) / 1e3,
            flush_fn=self._invoke_microbatch, error_fn=self.post_error,
            name=self.name)
        self._batcher.start()

    def stop(self) -> None:
        if self._pool_entry is not None:
            from ..runtime.serving import MODEL_POOL

            entry, self._pool_entry = self._pool_entry, None
            self._pool_batched = False
            if self._pool_attached:
                self._pool_attached = False
                try:
                    entry.detach(self)  # flushes THIS stream's parked
                    # frames; survivors keep dispatching on the entry
                except Exception as e:  # noqa: BLE001 - report, keep
                    # stopping: the refcount must still drop
                    self.post_error(e)
            MODEL_POOL.release(entry)
            self.subplugin = None
            return
        if self._batcher is not None:
            try:
                self._batcher.flush()  # drain, best effort: downstream
                # may already be stopping, but frames must not vanish
            except Exception as e:  # noqa: BLE001 - report, keep stopping
                self.post_error(e)
            self._batcher.stop()
            self._batcher = None
        if self.subplugin is not None:
            self.subplugin.close()
            self.subplugin = None

    def on_eos(self) -> None:
        # partial-batch flush BEFORE the EOS event forwards downstream:
        # no frame loss, and sinks see data-then-EOS in order
        if self._pool_entry is not None and self._pool_attached:
            try:
                # per-stream flush: only THIS stream's parked frames
                # must drain; other pipelines' windows stay open
                self._pool_entry.flush_stream(self)
            except Exception as e:  # noqa: BLE001 - report, let EOS
                # propagate so wait_eos() terminates
                self.post_error(e)
            return
        if self._batcher is not None:
            try:
                self._batcher.flush()
            except Exception as e:  # noqa: BLE001 - the EOS path has no
                # guarded caller (Queue._loop forwards unguarded): a
                # flush failure must reach the bus, and EOS must still
                # propagate so wait_eos() terminates
                self.post_error(e)

    # -- negotiation ---------------------------------------------------------

    def pad_template_caps(self, pad: Pad) -> Caps:
        if pad.direction.value == "sink":
            if self.invoke_dynamic:
                return Caps.any_tensors()
            try:
                self.open_fw()
            except (FilterError, KeyError, ValueError) as e:
                raise NegotiationError(f"{self.name}: open failed: {e}",
                                       reason="open", sink_pad=pad) from e
            if self._in_combi is not None:
                # model sees a subset; pad accepts anything containing it
                return Caps.any_tensors()
            # Preferred: exact model input caps. Fallback: any tensors —
            # caps_negotiated then tries the SET_INPUT_INFO reshape path.
            exact = Caps.from_spec(self.in_spec)
            return Caps(structs=exact.structs + Caps.any_tensors().structs)
        return Caps.any_tensors()

    def caps_negotiated(self, pad: Pad) -> None:
        if self.invoke_dynamic:
            return
        self.open_fw()
        spec = pad.spec
        if spec is None or self._in_combi is not None:
            return
        if not spec.is_static():
            # flexible input: per-buffer schemas can't carry a fixed
            # overlay epilogue — withdraw the decoder fusion so the
            # decoder renders for itself (mirror of transform _unfuse)
            if self._fused_post:
                self._fused_post.clear()
                if self._fused_post_decoder is not None:
                    self._fused_post_decoder.fused_upstream = False
            return
        prog = getattr(self.subplugin, "_program", None)
        stale = prog is not None and \
            (prog.with_pre != bool(self._fused_pre)
             or prog.with_post != bool(self._fused_post))
        if self._fused_pre or self._fused_post or stale:
            # fused prologue: the program must be specialized to the RAW
            # upstream schema even when it happens to be compatible with
            # the model's declared input
            try:
                self.in_spec, self.out_spec = \
                    self.subplugin.set_input_info(spec)
            except FilterError as e:
                raise NegotiationError(
                    f"{self.name}: fused prologue rejects input "
                    f"{spec}: {e}") from e
            return
        if not spec.is_compatible(self.in_spec):
            if self._shared_by_others():
                # a pooled model must not be rebuilt under the other
                # sharers' feet: sharers negotiate identical schemas
                raise NegotiationError(
                    f"{self.name}: input {spec} incompatible with the "
                    f"shared model's {self.in_spec}, which "
                    f"{self._pool_entry.refcount - 1} other filter(s) "
                    f"depend on — share-model sharers must negotiate "
                    f"identical input schemas")
            try:
                self.in_spec, self.out_spec = \
                    self.subplugin.set_input_info(spec)
            except FilterError as e:
                raise NegotiationError(
                    f"{self.name}: input {spec} incompatible with model "
                    f"{self.in_spec}: {e}") from e

    def _shared_by_others(self) -> bool:
        """Whether other elements currently hold the same pooled model
        (reshaping it would swap the program under them)."""
        return self._pool_entry is not None and self._pool_entry.refcount > 1

    def propose_src_caps(self, pad: Pad) -> Caps:
        self.open_fw()
        rate = Fraction(0, 1)
        if self.sinkpad.spec is not None:
            rate = self.sinkpad.spec.rate
        if self.invoke_dynamic:
            return Caps.from_spec(TensorsSpec(
                format=TensorFormat.FLEXIBLE, rate=rate))
        out = self.out_spec.with_rate(rate)
        if self._out_combi is not None and self.sinkpad.spec is not None:
            out = self._combined_out_spec(self.sinkpad.spec).with_rate(rate)
        return Caps.from_spec(out)

    def _combined_out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        """output-combination 'iN,...,oM,...' merges input passthroughs and
        model outputs (parity: tensor_filter.c:848-880)."""
        tensors = []
        for tok in str(self.output_combination).split(","):
            tok = tok.strip()
            if tok.startswith("i"):
                tensors.append(in_spec.tensors[int(tok[1:])])
            elif tok.startswith("o"):
                tensors.append(self.out_spec.tensors[int(tok[1:])])
        return TensorsSpec(tensors=tuple(tensors))

    # -- hot path ------------------------------------------------------------

    def chain(self, pad: Pad, buf: Buffer) -> None:
        sp = self.subplugin
        if sp is None:
            # checked BEFORE the QoS throttle: a misconfigured filter must
            # report, not silently drop every buffer as "throttled"
            raise StreamError(f"{self.name}: no sub-plugin opened")
        if self._throttled():
            return  # QoS drop (parity: tensor_filter.c:511)
        if self._pool_batched and self._pool_entry is not None:
            if self._chaos_plan is not None:
                # element-scoped faults on a pooled stream apply at
                # admission (the pool dispatch belongs to every sharer;
                # the process-wide plan covers it there)
                apply_invoke_fault(self._chaos_plan, self.name)
            # shared-model serving: park the buffer in the CROSS-pipeline
            # window; the pool dispatch demuxes the result back here
            self._pool_entry.submit(self, buf)
            return
        if self._batcher is not None:
            # micro-batching: park the buffer in the coalescing window;
            # the window flush (full/deadline/EOS) dispatches it
            self._batcher.submit(buf)
            return
        if self._pool_entry is not None:
            # per-frame pooled stream: a live canary may route THIS
            # stream's frames through the staged version's instance
            sp = self._pool_entry.subplugin_for(self)
        # model-path fault seam (unbatched dispatch): the element plan AND
        # the process-wide plan both apply
        self._chaos_invoke()
        tensors = buf.tensors
        if self._in_combi is not None:
            tensors = [tensors[i] for i in self._in_combi]
        if self.invoke_dynamic:
            self._reshape_dynamic(buf)
        # the sample gate opens BEFORE input prep: host-prep is part of
        # what this element spends per dispatch
        sample, t0 = self._sampler.begin(self._sample_interval(),
                                         force=bool(self.latency))
        if getattr(sp, "HOST_INVOKE", False):
            # a host numpy framework: the buffer's device tensors cross
            # in one packed copy
            inputs = drain_once(tensors)
        else:
            inputs = [t.torch(sp.device) for t in tensors]
        t1 = time.monotonic()
        outputs = sp.invoke(inputs)
        if getattr(sp, "_donate", False):
            self._mark_donated(buf)
        t2 = self._sampler.end(outputs, t0, sample)
        self._report_latency()
        out_tensors = [Tensor(o) for o in outputs]
        if self._out_combi is not None:
            out_tensors = self._combine_outputs(buf, out_tensors)
        out = Buffer(tensors=out_tensors, pts=buf.pts,
                     duration=buf.duration, offset=buf.offset,
                     meta=dict(buf.meta),
                     format=TensorFormat.FLEXIBLE if self.invoke_dynamic
                     else TensorFormat.STATIC)
        if sample:
            # phases recorded (and trace marks planted) BEFORE the push:
            # a sink reached inline closes the trace record
            t3 = time.monotonic()
            self._attribute_phases(t0, t1, t2, t3, bucket=1)
            tracer = _hooks.tracer
            if tracer is not None:
                tracer.invoke_split([(self.name, out)], t0, t1, t2, t3)
        self.push(out)

    def _chaos_invoke(self) -> None:
        """The invoke fault seam of this element's own dispatches: its
        ``chaos=`` plan, then the process-wide plan."""
        if self._chaos_plan is not None:
            apply_invoke_fault(self._chaos_plan, self.name)
        ch = _chaos_hooks.plan
        if ch is not None:
            apply_invoke_fault(ch, self.name)

    def _report_latency(self) -> None:
        """``latency-report=true``: a LATENCY bus message whenever the
        mean invoke latency moved past the threshold."""
        if self.latency_report:
            rep = self.invoke_stats.latency_to_report()
            if rep is not None:
                self.post_message(Message(
                    MessageKind.LATENCY, self.name,
                    data={"latency_us": rep}))

    def _attribute_phases(self, t0: float, t1: float, t2: float,
                          t3: float, bucket: int) -> None:
        """One sampled dispatch's host-prep (t0→t1) / device (t1→t2) /
        host-drain (t2→t3) split into the element's InvokeStats and the
        registry's ``nns_invoke_*`` histograms."""
        from ..obs.metrics import observe_invoke_phases

        self.invoke_stats.record_phases(t1 - t0, t2 - t1, t3 - t2)
        observe_invoke_phases("element", self.name, bucket,
                              t1 - t0, t2 - t1, t3 - t2)

    def _sample_interval(self) -> float:
        """Seconds between blocking stats samples (utils/stats.py
        DispatchSampler): ``stat-sample-interval-ms``, else the default."""
        return STAT_SAMPLE_INTERVAL if self.stat_sample_interval_ms is None \
            else float(self.stat_sample_interval_ms) / 1e3

    def _invoke_microbatch(self, bufs: List[Buffer]) -> None:
        """Window flush: dispatch 1..batch queued buffers as one program
        call (padded to a bucket), then unbatch the outputs back into
        per-frame Buffers in arrival order, pts/offset/meta preserved.
        Runs on the producer thread (full window) or the coalescer's
        timer thread (deadline/EOS) — never concurrently (MicroBatcher
        serializes flushes)."""
        sp = self.subplugin
        if sp is None:
            raise StreamError(f"{self.name}: no sub-plugin opened")
        # model-path fault seam: a fail-invoke loses the whole window
        self._chaos_invoke()
        sample, t0 = self._sampler.begin(self._sample_interval(),
                                         force=bool(self.latency))
        # transfer-label context for the window: deadline/EOS flushes run
        # on the coalescer's timer thread, which carries no chain context
        xctx = None
        pushed = _xfer.ACTIVE
        if pushed:
            traces = tuple(
                tr for tr in (b.meta.get(TRACE_META_KEY) for b in bufs)
                if tr is not None) or None
            xctx = _xfer.push_context(
                self.pipeline.name if self.pipeline is not None else "",
                self.name, traces)
        try:
            self._invoke_window(sp, bufs, sample, t0)
        finally:
            if pushed:
                _xfer.pop_context(xctx)

    def _invoke_window(self, sp: Any, bufs: List[Buffer], sample: bool,
                       t0: float) -> None:
        from ..runtime.batching import pick_bucket

        frames = [self._pool_frame_inputs(buf) for buf in bufs]
        bucket = pick_bucket(len(frames), self._buckets)
        t1 = time.monotonic()
        if getattr(sp, "SUPPORTS_BATCH", False):
            outs = sp.invoke_batched(frames, bucket)
        else:
            # framework without a batched entry point: the window still
            # coalesces (ordering, EOS flush, occupancy stats) but each
            # frame dispatches separately
            outs = [sp.invoke(list(f)) for f in frames]
        if getattr(sp, "_donate", False):
            for buf in bufs:
                self._mark_donated(buf)
        t2 = self._sampler.end([o for out in outs for o in out], t0, sample,
                               frames=len(bufs))
        self._report_latency()
        if sample:
            tracer = _hooks.tracer
            if tracer is not None:
                # marks planted BEFORE the demux; each buffer's own demux
                # mark closes its drain span
                tracer.invoke_split([(self.name, b) for b in bufs],
                                    t0, t1, t2)
        for buf, out in zip(bufs, outs):
            self._pool_emit(buf, out)
        if sample:
            # host-drain of the window: unbatch + per-frame wrap + the
            # downstream handoff of every frame demuxed above
            self._attribute_phases(t0, t1, t2, time.monotonic(),
                                   bucket=bucket)

    # -- serving-pool hooks (runtime/serving.py drives these) ----------------

    def _pool_frame_inputs(self, buf: Buffer) -> List[Any]:
        """Model inputs of one parked frame, input-combination applied.
        Device-resident tensors pass through as they are; host-resident
        ones stay numpy, so the window stacks them on the host and
        copies the stack to the card once."""
        tensors = buf.tensors
        if self._in_combi is not None:
            tensors = [tensors[i] for i in self._in_combi]
        return [t.torch() if t.is_device else t.np() for t in tensors]

    def _mark_donated(self, buf: Buffer) -> None:
        """``custom=donate``: mark exactly the tensors a dispatch was
        handed (the input-combination subset) as donated, so a retained
        reference raises instead of reading memory the card may reuse."""
        tensors = buf.tensors
        if self._in_combi is not None:
            tensors = [tensors[i] for i in self._in_combi]
        for t in tensors:
            t.mark_donated()

    def _pool_emit(self, buf: Buffer, out: List[Any]) -> None:
        """Demux one dispatch result onto THIS filter's downstream pad —
        the owner's flush context: output-combination, pts/offset/meta
        preservation, and any downstream failure surfacing on THIS
        element's bus."""
        tracer = _hooks.tracer
        if tracer is not None:
            tracer.batch_demuxed(self, buf)
        out_tensors = [Tensor(o) for o in out]
        if self._out_combi is not None:
            out_tensors = self._combine_outputs(buf, out_tensors)
        self.push(Buffer(
            tensors=out_tensors, pts=buf.pts, duration=buf.duration,
            offset=buf.offset, meta=dict(buf.meta),
            format=TensorFormat.STATIC))

    def _combine_outputs(self, in_buf: Buffer, outputs: List[Tensor]
                         ) -> List[Tensor]:
        combined = []
        for tok in str(self.output_combination).split(","):
            tok = tok.strip()
            if tok.startswith("i"):
                combined.append(in_buf.tensors[int(tok[1:])])
            elif tok.startswith("o"):
                combined.append(outputs[int(tok[1:])])
        return combined

    def _reshape_dynamic(self, buf: Buffer) -> None:
        spec = buf.spec()
        if self._dyn_spec is not None and spec.is_compatible(self._dyn_spec):
            return
        self.in_spec, self.out_spec = self.subplugin.set_input_info(spec)
        self._dyn_spec = spec

    def _throttled(self) -> bool:
        if self._throttle_interval <= 0:
            return False
        now = time.monotonic()
        if now - self._last_invoke_ts < self._throttle_interval:
            return True
        self._last_invoke_ts = now
        return False

    # -- events --------------------------------------------------------------

    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.QOS_THROTTLE:
            rate = event.data.get("rate")
            self._throttle_interval = float(1 / rate) if rate else 0.0
        super().handle_upstream_event(pad, event)

    def handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind != EventKind.RELOAD_MODEL:
            super().handle_event(pad, event)
            return
        if not self.is_updatable:
            self.post_error(FilterError(f"{self.name}: model is not "
                                        "updatable"))
            return
        from ..runtime.lifecycle import LifecycleError

        try:
            if self._pool_entry is not None:
                # the reload steers the POOL: staged and warmed off the
                # dispatch path, then swapped at a window boundary (or
                # canaried per the pool's canary=) for every sharer
                self._pool_entry.reload_model(
                    event.data["model"],
                    version=str(event.data.get("version", "")))
                return
            if self.subplugin is None:
                raise FilterError(f"{self.name}: no sub-plugin opened")
            self.subplugin.handle_event(event)
            self.in_spec, self.out_spec = self.subplugin.get_model_info()
        except (FilterError, LifecycleError, ValueError, KeyError) as e:
            self.post_error(e)

    # -- introspection props -------------------------------------------------

    @property
    def latency_us(self) -> int:
        return self.invoke_stats.latency_us

    @property
    def throughput_milli_fps(self) -> int:
        return self.invoke_stats.throughput_milli_fps

    @property
    def dispatch_milli_fps(self) -> int:
        """1000×dispatches/s — below throughput_milli_fps exactly when
        micro-batching is coalescing."""
        return self.invoke_stats.dispatch_milli_fps

    @property
    def batch_occupancy(self) -> float:
        """Realized mean frames per dispatch (1.0 unbatched)."""
        return self.invoke_stats.avg_batch_occupancy

    @property
    def pool(self):
        """The shared serving-pool entry (``share-model=true``), else
        None.  Its ``stats`` carry the TRUE cross-pipeline dispatch
        counts; this element's own ``invoke_stats`` count the dispatches
        its frames rode in."""
        return self._pool_entry

    @property
    def pool_streams(self) -> int:
        """Streams currently attached to the shared pool entry (0 when
        not sharing)."""
        return self._pool_entry.attached_streams \
            if self._pool_entry is not None else 0

    @property
    def pool_stream_occupancy(self) -> float:
        """Mean distinct pipelines per shared dispatch (0.0 when not
        sharing)."""
        return self._pool_entry.stats.avg_stream_occupancy \
            if self._pool_entry is not None else 0.0
