"""tensor_query — offload a pipeline stage to a server pipeline.

Counterpart of the JAX package's ``edge/query.py``.  Parity targets (the
reference's ``gst/nnstreamer/tensor_query/`` and ``gst/edge/``):
- ``tensor_query_client`` — sink chain serializes the buffer, sends it to
  the server, and pushes the answer on its src pad; outstanding requests
  beyond ``max-request`` drop the input instead of queueing unboundedly.
- ``tensor_query_serversrc`` — accepts client connections, stamps each
  incoming query with ``client_id`` meta, and pushes it into the server
  pipeline.
- ``tensor_query_serversink`` — reads the ``client_id`` meta off the
  processed buffer and sends it back to exactly that client; metaless
  frames are dropped, and a run of them errors the pipeline.
- the query-server registry pairing src/sink by ``id`` and holding the
  server's caps for client negotiation.
- ``edgesink``/``edgesrc`` — topic pub/sub over the same transports.

On the card: with ``connect-type=inproc`` the round trip is a queue hop
carrying card tensors by reference.  ``tcp`` uses the MetaInfo-headed
wire codec: a card frame leaves the card once (``Tensor.tobytes`` in the
packed path), arrives at the server as host tensors, and the server
pipeline's first card element uploads it.  Two endpoints of one process
that pass the device-channel handshake (:mod:`.devicechannel`) keep card
frames on the card in both directions.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from ..chaos.plan import apply_wire_op
from ..chaos.retrypolicy import RetryPolicy
from ..core import Buffer, Caps, TensorFormat, TensorsSpec
from ..obs import hooks as _hooks
from ..obs import tracectx
from ..obs.metrics import LinkMetrics
from ..obs.tracer import TRACE_META_KEY
from ..runtime.element import (
    Element,
    NegotiationError,
    Pad,
    SinkElement,
    SourceElement,
    StreamError,
)
from ..runtime.registry import register_element
from ..utils.log import loge, logw
from .ntputil import PeerClock, async_ntp_epoch_fn
from .transport import Envelope, connect, make_server
from .wire import MSG_PUBLISH, MSG_QUERY, MSG_REPLY, MSG_SUBSCRIBE


def _parse_ntp_servers(spec: str):
    """``host[:port],host[:port]`` → [(host, port)] (port 123 default)."""
    out = []
    for tok in str(spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        h, _, p = tok.rpartition(":")
        out.append((h or tok, int(p) if p.isdigit() else 123))
    return out


# -- query server registry ----------------------------------------------------


class _QueryServerEntry:
    """Shared state of one query server ``id``: the transport (owned by
    serversrc) and the sink-side caps registered for client negotiation."""

    def __init__(self):
        self.transport = None
        self.sink_caps: str = ""


_REG_LOCK = threading.Lock()
_SERVERS: Dict[int, _QueryServerEntry] = {}


def query_server_entry(server_id: int) -> _QueryServerEntry:
    with _REG_LOCK:
        if server_id not in _SERVERS:
            _SERVERS[server_id] = _QueryServerEntry()
        return _SERVERS[server_id]


# -- client -------------------------------------------------------------------


@register_element("tensor_query_client")
class TensorQueryClient(Element):
    """Acts like a remote tensor_filter: every buffer round-trips through
    the server pipeline.

    The hot path is PIPELINED (parity: the reference's async answer queue
    — the edge thread keeps receiving while
    the sink chain blocks on ``g_async_queue_timeout_pop``): ``chain``
    sends without waiting, up to ``max_request`` requests ride the link
    concurrently, and a reader thread completes them as replies arrive —
    matched by ``seq``, out-of-order safe, pushed downstream in stream
    order.  On a high-RTT transport throughput is therefore bounded by
    bandwidth and server speed, not by requests × RTT (a send-then-recv
    chain would cap throughput at 1/RTT).
    A request that outlives ``timeout`` is dropped so one lost reply
    cannot head-of-line-block the stream; a dead connection fails over
    mid-stream to ``alternate_hosts`` and resends what was in flight.

    Matching is exact when the server echoes ``query_seq`` meta (our
    serversrc always does).  If the server pipeline strips it (replies
    carry seq 0), pairing degrades to arrival order — the reference's
    semantics — with ordering tombstones so an expired request's late
    reply is absorbed in place rather than shifting later answers.  A
    server that silently DROPS queries in this mode skews FIFO pairing
    irreparably (no client can distinguish the dropped request's
    successor reply from its own); the client keeps the stream live,
    surfaces the drops as timeouts, and logs a loud diagnostic.
    """

    FACTORY = "tensor_query_client"

    def __init__(self, name=None, host: str = "localhost", port: int = 0,
                 dest_host: str = "", dest_port: int = 0,
                 connect_type: str = "tcp", timeout: int = 10000,
                 max_request: int = 8, caps=None, silent: bool = True,
                 alternate_hosts: str = "", topic: str = "",
                 trace: bool = True, ntp_servers: str = "",
                 device_channel: bool = True,
                 chaos: str = "", **props):
        self.host = host
        self.port = port
        self.dest_host = dest_host      # server address (falls back to host)
        self.dest_port = dest_port
        self.connect_type = connect_type
        # hybrid (ROADMAP item 5b; the transport raises until then):
        # host:port is the BROKER, topic names the server whose TCP data
        # address is discovered through it
        self.topic = topic
        self.timeout = timeout          # ms, parity: client timeout prop
        self.max_request = max_request
        self.caps = caps                # explicit out-caps override
        self.silent = silent
        # failover list "host:port,host:port" tried in order when the
        # primary is unreachable (parity: the reference's reconnect to
        # alternate servers)
        self.alternate_hosts = alternate_hosts
        # distributed tracing: propagate a sampled buffer's trace
        # context to the server and absorb its spans from the reply
        # (Documentation/observability.md, "Distributed tracing")
        self.trace = trace
        # optional SNTP servers "host[:port],..." — a wall-clock
        # cross-check for span alignment; the query link itself already
        # yields in-band 4-timestamp offset samples (every traced
        # round-trip is one), which assume symmetric path delay
        self.ntp_servers = ntp_servers
        # same-process fast path (edge/devicechannel.py): probe whether
        # the server shares this process's device world — if so, card-
        # resident frames stay on the card and only control metadata rides
        # the socket, both directions.  Falls back to plain TCP
        # transparently on any mismatch; device-channel=false never
        # probes.
        self.device_channel = device_channel
        # element-scoped fault injection on THIS link (grammar in
        # chaos/plan.py); the process-wide NNS_TPU_TORCH_CHAOS plan applies
        # at the transport layer regardless
        self.chaos = chaos
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._conn = None
        self._seq = 0
        self.dropped = 0
        self.timeouts = 0
        self.connected_addr = None  # (host, port) actually in use
        # per-peer clock-offset estimate fed by traced round-trips
        # (edge/ntputil.py): minimum-delay filter over recent exchanges
        self.peer_clock = PeerClock()
        self._metrics = None  # LinkMetrics of the live connection
        # the shared edge reconnect policy (chaos/retrypolicy.py):
        # jittered exponential backoff between failover sweeps + a
        # circuit breaker whose state exports on the LINK row
        self._retry = RetryPolicy(name=self.name, base_s=0.2, max_s=2.0,
                                  fail_threshold=6, open_s=2.0)
        self._chaos_plan = None  # parsed from chaos= in start()
        self._epoch_fn = async_ntp_epoch_fn(_parse_ntp_servers(ntp_servers)) \
            if str(ntp_servers or "").strip() else None
        self._clock_disagree = 0  # consecutive cross-check failures
        # seq → [input Buffer, reply Envelope|None, deadline, last-sent
        # conn]; insertion order IS stream order — replies flush from
        # the head.  An entry
        # with input None is an ordering TOMBSTONE: an expired request in
        # seq-less mode, kept one more timeout window so its late reply
        # is consumed in place instead of shifting every later seq-0
        # reply onto the wrong request.
        self._inflight: "OrderedDict[int, list]" = OrderedDict()
        # None until the first reply reveals the server's behavior:
        # True → server strips query_seq, replies pair FIFO (seq-less);
        # False → seqs are preserved, matching is exact.  While unknown,
        # expiry is conservative (tombstones) so a slow FIRST request
        # can't shift the pairing either way.
        self._seqless: Optional[bool] = None
        self._tomb_absorbs = 0  # seq-0 replies eaten by tombstones, unsettled
        self._cascade_cycles = 0  # absorb→expiry cycles (degradation signal)
        self._iflock = threading.Lock()
        self._pushing = 0  # answers popped but not yet pushed downstream
        self._connlock = threading.Lock()  # serializes conn swaps
        self._reader_run = threading.Event()
        self._reader_thread: Optional[threading.Thread] = None

    # -- connection -----------------------------------------------------------

    def _server_addrs(self):
        primary_port = int(self.dest_port or self.port)
        addrs = [(self.dest_host or self.host, primary_port)]
        for tok in str(self.alternate_hosts or "").split(","):
            tok = tok.strip()
            if not tok:
                continue
            h, _, p = tok.rpartition(":")
            # a bare hostname inherits the primary's port (port 0 would
            # make the failover entry unconditionally unreachable)
            addrs.append((h or tok,
                          int(p) if p.isdigit() else primary_port))
        return addrs

    def _attach_metrics(self, conn, host, port) -> None:
        """Bind the per-connection nns_edge_* stats: the element-level
        numbers (RTT, in-flight, timeouts) and the transport's byte
        counters share one LinkMetrics keyed by peer address, so the
        counters survive reconnects monotonically."""
        self._metrics = LinkMetrics.get(self.name, f"{host}:{port}",
                                        kind="query")
        conn.metrics = self._metrics
        self._retry.metrics = self._metrics
        self._retry._sync_metrics()

    def _probe_devch(self, conn, timeout: float = 1.0) -> None:
        """Device-channel handshake on a fresh connection (no-op when
        the element opted out): on success, device-resident frames ride
        the same-process fast path with only control metadata on the
        socket —
        else the connection stays in plain TCP framing."""
        if not bool(self.device_channel):
            return
        try:
            conn.request_devch(timeout=timeout)
        except Exception:  # noqa: BLE001 - probe must never kill connect
            pass

    def _ensure_conn(self):
        with self._connlock:
            if self._conn is None:
                errors = []
                for host, port in self._server_addrs():
                    try:
                        self._conn = connect(host, port, self.connect_type)
                        self.connected_addr = (host, port)
                        self._attach_metrics(self._conn, host, port)
                        self._probe_devch(self._conn)
                        break
                    except OSError as e:
                        errors.append(f"{host}:{port}: {e}")
                if self._conn is None:
                    raise NegotiationError(
                        f"{self.name}: no query server reachable "
                        f"({'; '.join(errors)})")
            return self._conn

    # -- negotiation ----------------------------------------------------------

    def pad_template_caps(self, pad: Pad) -> Caps:
        return Caps.any_tensors()

    def propose_src_caps(self, pad: Pad) -> Caps:
        from ..runtime.parser import parse_caps_string

        rate = self.sinkpad.spec.rate if self.sinkpad.spec else None
        if self.caps:
            return self.caps if isinstance(self.caps, Caps) \
                else parse_caps_string(str(self.caps))
        # ask the server what its pipeline outputs (registry caps exchange,
        # parity: tensor_query_server get/set caps)
        caps_str = self._ensure_conn().request_caps(timeout=2.0)
        if caps_str:
            try:
                return parse_caps_string(caps_str)
            except Exception:  # noqa: BLE001 - fall back to flexible
                logw("%s: unparseable server caps %r", self.name, caps_str)
        spec = TensorsSpec(format=TensorFormat.FLEXIBLE)
        if rate:
            spec = spec.with_rate(rate)
        return Caps.from_spec(spec)

    # -- hot path -------------------------------------------------------------

    def chain(self, pad: Pad, buf: Buffer) -> None:
        conn = self._ensure_conn()
        with self._iflock:
            live = sum(1 for e in self._inflight.values()
                       if e[0] is not None)
            if 0 < int(self.max_request) <= live:
                # server too slow: drop the input rather than queue
                # unboundedly (parity: max-request drop); tombstones
                # don't count — they hold ordering, not server work
                self.dropped += 1
                return
            self._seq += 1
            seq = self._seq
            now = time.monotonic()
            # entry: [input, reply, deadline, conn-last-sent-on,
            # send-time, resends] — the 4th field lets chain and the
            # failover resend coordinate so a request is never
            # DUPLICATED on the new connection (a seq-stripping server
            # would answer twice and the second seq-0 reply would shift
            # every later answer); the 5th times the round-trip and
            # doubles as the trace context's t1; the 6th caps mid-
            # stream retries at ONE — under repeated connection flaps
            # an already-resent request counts as a timeout instead of
            # riding (and stalling) every new connection
            self._inflight[seq] = [
                buf, None, now + float(self.timeout) / 1000.0, conn, now,
                0]
            self._update_inflight_locked()
        env = Envelope(MSG_QUERY, seq=seq, buffer=buf)
        if self.trace:
            tr = buf.meta.get(TRACE_META_KEY)
            if tr is not None:
                env.trace = tracectx.request_ctx(tr, now)
        ch = self._chaos_plan
        if ch is not None:
            # element-scoped wire faults on the REQUEST path (the
            # process-wide plan already applies inside the transport)
            op = ch.wire(self.name, "tx", env)
            if op is not None:
                # disconnect: the reader sees a dead conn → failover
                apply_wire_op(op, conn.send, conn.close)
                return  # dropped frames surface as timeouts, never lost
        if not conn.send(env):
            # Serialize against a failover in flight: taking _connlock
            # waits until its resend snapshot has run, so either it
            # already resent this entry IN ORDER with the older seqs
            # (entry now tagged with the new conn → we skip) or it
            # finished before this entry existed (we send — again in
            # order, after all its resends).  Sending without this wait
            # could put the NEWEST seq on the wire before the older
            # resends, mispairing seq-less (FIFO) replies.
            with self._connlock:
                cur = self._conn
            if cur is not None and cur is not conn:
                with self._iflock:
                    ent = self._inflight.get(seq)
                    resend = ent is not None and ent[3] is conn
                    if resend:
                        ent[3] = cur
                if resend:
                    cur.send(env)
            else:
                # connection died under us: the entry stays in flight and
                # the reader thread's failover resends it
                logw("%s: send failed, awaiting failover", self.name)

    def _reply_arrived(self, ent, env, t4: float) -> None:
        """Attach a reply to its in-flight entry (caller holds
        ``_iflock``): record the round-trip, and — when the reply
        carries a trace context — absorb the server's spans into the
        input buffer's trace, feeding the per-exchange clock offset
        into :attr:`peer_clock`."""
        ent[1] = env
        rtt = t4 - ent[4]
        if self._metrics is not None:
            self._metrics.observe_rtt(rtt)
        if env.trace is not None and ent[0] is not None:
            tr = ent[0].meta.get(TRACE_META_KEY)
            if tr is not None:
                est = tracectx.absorb_reply(tr, env.trace, t4,
                                            link=self.name)
                if est is not None:
                    self.peer_clock.add(*est)
                    self._clock_cross_check(env.trace, est)

    def _clock_cross_check(self, ctx, est) -> None:
        """``ntp-servers=`` wall-clock cross-check of the in-band span
        placement: wall clocks say the reply left the server
        ``lag_wall`` before now, the in-band estimate says ``delay/2``.
        A persistent gap beyond the error budget means the network path
        is asymmetric (or a clock is unsynchronized) and remote spans
        are skewed — exactly what lint NNS506 warns about when no NTP
        is configured.  The epoch callable is the async (arithmetic-
        only) variant, so this is safe on the reply path."""
        epoch3 = ctx.get("epoch3_us")
        if self._epoch_fn is None or not isinstance(epoch3, (int, float)):
            return
        offset, delay = est
        lag_wall = (self._epoch_fn() - float(epoch3)) / 1e6
        if abs(lag_wall - delay / 2.0) <= max(delay, 0.005):
            self._clock_disagree = 0
            return
        self._clock_disagree += 1
        if self._clock_disagree == 5:  # persistent, not a one-off spike
            self._clock_disagree = 0
            logw("%s: NTP wall clocks disagree with the in-band span "
                 "placement by %.1f ms (rtt %.1f ms) — asymmetric "
                 "network path or unsynchronized server clock; remote "
                 "trace spans may be skewed", self.name,
                 abs(lag_wall - delay / 2.0) * 1e3, delay * 1e3)

    def start(self) -> None:
        if str(self.chaos or "").strip():
            from ..chaos.plan import FaultPlan

            self._chaos_plan = FaultPlan.parse(str(self.chaos))
        self._reader_run.set()
        from ..obs import prof as _prof

        self._reader_thread = _prof.named_thread(
            "edge-replies", self.name, self._reader_loop)
        self._reader_thread.start()
        super().start()

    def _reader_loop(self) -> None:
        while self._reader_run.is_set():
            conn = self._conn
            if conn is None:
                time.sleep(0.02)
                continue
            env = conn.recv(timeout=0.1)
            envs = [env] if env is not None else []
            ch = self._chaos_plan
            if envs and ch is not None:
                # element-scoped wire faults on the REPLY path
                op = ch.wire(self.name, "rx", env)
                if op is not None:
                    envs = []
                    apply_wire_op(op, envs.append,
                                  conn.close)
            for e in envs:
                if e.mtype == MSG_REPLY:
                    self._process_reply(e, time.monotonic())
                    self._flush_ready()
            self._expire(time.monotonic())
            if env is None and not conn.is_alive():
                self._failover(conn)
                # compensate for the flush=False expiries inside the
                # failover window: a head removal there can leave
                # completed replies parked with no future event to
                # flush them (e.g. out-of-order B answered, A expired)
                self._flush_ready()

    def _process_reply(self, env: Envelope, t4: float) -> None:
        """Match one MSG_REPLY against the in-flight order (exact by
        seq, else arrival-order with tombstone absorption)."""
        with self._iflock:
            if env.seq != 0:
                ent = self._inflight.get(env.seq)
                if ent is not None:
                    if ent[0] is None:
                        # a tombstoned request's own seq'd reply: too
                        # late to deliver, but proof the server
                        # preserves seqs — consume the tombstone so it
                        # stops parking later completed replies
                        del self._inflight[env.seq]
                    else:
                        self._reply_arrived(ent, env, t4)
                    if self._seqless is not False:
                        # seqs are flowing (again): exact matching
                        # needs no ordering tombstones — purge any
                        # left from the unknown/seq-less phase so
                        # they don't park completed replies behind
                        # a dead head entry
                        self._seqless = False
                        self._purge_tombstones_locked()
            elif self._inflight:
                # server pipeline lost the query_seq meta: fall
                # back to arrival-order matching (oldest pending)
                self._seqless = True
                for seq, e in self._inflight.items():
                    if e[1] is not None:
                        continue
                    if e[0] is None:
                        # tombstone of an expired request: treat
                        # this as its late reply — consume &
                        # discard so the NEXT reply pairs with
                        # the right request instead of shifting
                        # by one.  If the absorbed reply was in
                        # fact a live request's on-time answer
                        # (the server silently DROPPED the
                        # tombstone's query — indistinguishable
                        # from a stall, see _expire), that victim
                        # surfaces as a visible timeout and the
                        # absorb→expiry cycle counter raises a
                        # loud diagnostic.
                        del self._inflight[seq]
                        self._tomb_absorbs += 1
                    else:
                        self._reply_arrived(e, env, t4)
                        self._tomb_absorbs = 0
                        self._cascade_cycles = 0
                    break

    def _flush_ready(self) -> None:
        """Pop completed requests from the HEAD of the in-flight order and
        push their answers — replies may complete out of order, buffers
        still leave in stream order.  ``_pushing`` stays non-zero from pop
        to push so ``on_eos`` cannot see "drained" between the two and
        let EOS overtake the final buffer."""
        while True:
            with self._iflock:
                if not self._inflight:
                    return
                seq = next(iter(self._inflight))
                ent = self._inflight[seq]
                if ent[1] is None:
                    return
                self._inflight.popitem(last=False)
                self._update_inflight_locked()
                self._pushing += 1
            try:
                inbuf, env = ent[0], ent[1]
                out = env.buffer
                if out is None:
                    continue
                # metadata comes from the *incoming* buffer (reference
                # copies GST_BUFFER_COPY_METADATA from input onto answer);
                # the trace key stays the CLIENT's — over inproc the
                # answer still carries the server pipeline's own planted
                # trace dict, which must not shadow the local one
                out = dataclasses.replace(
                    out, pts=inbuf.pts, duration=inbuf.duration,
                    offset=inbuf.offset,
                    meta={**inbuf.meta,
                          **{k: v for k, v in out.meta.items()
                             if k not in ("client_id", "query_seq",
                                          TRACE_META_KEY)}})
                self.push(out)
            finally:
                with self._iflock:
                    self._pushing -= 1

    def _update_inflight_locked(self) -> None:
        """Refresh the nns_edge_inflight gauge (caller holds _iflock);
        tombstones hold ordering, not server work, so they don't count."""
        if self._metrics is not None:
            self._metrics.set_inflight(sum(
                1 for e in self._inflight.values()
                if e[0] is not None and e[1] is None))

    def _purge_tombstones_locked(self) -> int:
        """Drop every ordering tombstone (caller holds ``_iflock``).
        Returns how many were removed — a removed HEAD tombstone can
        unblock completed replies, so callers re-run ``_flush_ready``
        (outside the lock) when this is non-zero."""
        stale = [s for s, e in self._inflight.items()
                 if e[0] is None and e[1] is None]
        for s in stale:
            del self._inflight[s]
        return len(stale)

    def _expire(self, now: float, flush: bool = True) -> None:
        """``flush=False`` for callers holding ``_connlock``:
        _flush_ready pushes downstream, which must never happen under
        that lock (chain's _ensure_conn path) — the reader loop re-runs
        _expire with flushing right after failover returns."""
        expired, removed = [], 0
        with self._iflock:
            for seq, ent in list(self._inflight.items()):
                if ent[1] is not None or ent[2] > now:
                    continue
                if ent[0] is not None and self._seqless is not False:
                    # seq-less replies pair by arrival order: leave an
                    # ordering tombstone for one more window so the late
                    # reply (if any) is absorbed in place.  This is the
                    # correctness-safe choice for BOTH failure stories —
                    # a slow server (each tombstone absorbs its own late
                    # answer, stream recovers) and a query-dropping
                    # server (each tombstone eats the NEXT on-time
                    # answer; frames are discarded as visible timeouts,
                    # never silently mispaired).  The two are
                    # indistinguishable from the client, so the dropping
                    # case cannot be "fixed" without risking mispaired
                    # data; it is surfaced via _cascade_cycles below.
                    if self._tomb_absorbs > 0:
                        self._tomb_absorbs -= 1
                        self._cascade_cycles += 1
                    ent[0] = None
                    ent[2] = now + float(self.timeout) / 1000.0
                    expired.append(seq)
                elif ent[0] is not None:
                    expired.append(seq)
                    del self._inflight[seq]
                    removed += 1
                else:
                    # tombstone past its grace window: no reply is coming
                    # (e.g. the server dropped the query) — removing it
                    # cannot shift pairing
                    del self._inflight[seq]
                    removed += 1
            if expired or removed:
                self._update_inflight_locked()
        for seq in expired:
            self.timeouts += 1
            if self._metrics is not None:
                self._metrics.timeout()
            logw("%s: no answer for request %d within %sms",
                 self.name, seq, self.timeout)
        if self._cascade_cycles >= 3:
            # absorb→expiry cycles are self-sustaining: either the
            # server pipeline is persistently slower than `timeout` or
            # it silently drops queries — both deliver zero frames in
            # seq-less mode and the client cannot tell them apart
            self._cascade_cycles = 0
            loge("%s: seq-less reply pairing is degraded — the query "
                 "server strips query_seq meta AND answers are "
                 "persistently late or missing; frames are being "
                 "dropped.  Preserve query_seq meta in the server "
                 "pipeline or raise timeout= (current %sms)",
                 self.name, self.timeout)
        if removed and flush:
            # any head removal can unblock later already-completed
            # replies (incl. seq'd replies parked behind a tombstone)
            self._flush_ready()

    def _failover(self, dead) -> None:
        """Mid-stream reconnect: try every configured address — the one
        that just died last (its server may have restarted) — and resend
        whatever is still in flight on the new connection."""
        dropped_tomb = False
        reconnected = False
        errors = []
        spent: list = []
        with self._connlock:
            if self._conn is not dead:
                return  # someone else already failed over
            try:
                dead.close()
            except Exception:  # noqa: BLE001
                pass
            self._conn = None
            addrs = self._server_addrs()
            if self.connected_addr in addrs:
                addrs = [a for a in addrs if a != self.connected_addr] + \
                    [self.connected_addr]
            # Retry window: long enough to ride out a restarting server
            # (at least 3 s, the JAX package's window).  Capped at 10 s: _connlock is held throughout (chain()
            # blocks in _ensure_conn), so the window must not scale with
            # a large `timeout` (30 s first-invoke timeouts would stall
            # upstream that long on a permanently dead server).
            retry_deadline = time.monotonic() + min(
                max(3.0, float(self.timeout) / 1000.0), 10.0)
            attempt = 0
            # the deadline (not an attempt count) bounds the loop, and
            # each connect gets a short timeout so one unreachable
            # address cannot blow through the cap
            while not reconnected and time.monotonic() < retry_deadline:
                if attempt:
                    # jittered exponential backoff between sweeps — the
                    # shared edge retry policy (chaos/retrypolicy.py)
                    # replaces the old fixed-rate 0.3 s hammer; capped
                    # so the sweeps still fit the failover window
                    # nns-lint: disable=NNS602 -- deliberate: _connlock
                    # IS the failover critical section (senders MUST
                    # block until a live conn exists or the window
                    # expires); the wait is capped at 10 s above
                    self._retry.wait(max_s=max(
                        retry_deadline - time.monotonic(), 0.05))
                    # deadlines keep passing while we hold _connlock:
                    # surface per-request timeouts (only takes _iflock —
                    # lock order _connlock → _iflock holds; no flush
                    # under _connlock, the reader loop flushes next)
                    self._expire(time.monotonic(), flush=False)
                attempt += 1
                for host, port in addrs:
                    # re-check between addresses too: each blocking
                    # connect can cost seconds, and a long alternate
                    # list would otherwise hold _connlock far past the
                    # cap (first sweep always tries every address)
                    if attempt > 1 and \
                            time.monotonic() >= retry_deadline:
                        break
                    try:
                        conn = connect(host, port, self.connect_type,
                                       timeout=2.5)
                    except OSError as e:
                        errors.append(f"{host}:{port}: {e}")
                        continue
                    self._conn = conn
                    self.connected_addr = (host, port)
                    self._attach_metrics(conn, host, port)
                    # re-probe: the replacement server may be a
                    # different process (no shared device world)
                    self._probe_devch(conn)
                    self._metrics.reconnect()
                    self._retry.success()
                    # a different server means a different clock: old
                    # offset samples no longer apply
                    self.peer_clock = PeerClock()
                    with self._iflock:
                        # a different server may strip (or preserve) seqs
                        # differently — re-learn, staying conservative
                        self._seqless = None
                        self._tomb_absorbs = 0
                        self._cascade_cycles = 0
                        # tombstones: their late replies died with the
                        # old connection
                        dropped_tomb = self._purge_tombstones_locked() > 0
                        now = time.monotonic()
                        pending = []
                        for seq, ent in self._inflight.items():
                            if ent[1] is not None:
                                continue
                            if ent[3] is conn:
                                # chain()'s failed-send fallback already
                                # sent this one on the NEW connection —
                                # resending would duplicate the query
                                # (two seq-0 answers shift the pairing)
                                continue
                            if ent[5] >= 1:
                                # already resent on an earlier reconnect:
                                # at most ONE mid-stream retry per
                                # request — under repeated flaps the
                                # old deadline-extension made an entry
                                # immortal (stalling EOS and double-
                                # counting server work); it now counts
                                # as a timeout instead
                                spent.append(seq)
                                continue
                            # reconnecting may have outlived the original
                            # deadline (set at enqueue): restart the clock
                            # so the resends aren't immediately expired as
                            # spurious timeouts while the server redoes
                            # the work
                            ent[2] = now + float(self.timeout) / 1000.0
                            # tag with the new conn so chain()'s failed-
                            # send fallback knows not to duplicate it
                            ent[3] = conn
                            ent[4] = now  # RTT clock restarts with the resend
                            ent[5] += 1
                            pending.append((seq, ent[0]))
                        for seq in spent:
                            del self._inflight[seq]
                        if spent or pending:
                            self._update_inflight_locked()
                    for seq in spent:
                        self.timeouts += 1
                        if self._metrics is not None:
                            self._metrics.timeout()
                    if spent:
                        logw("%s: %d request(s) dropped after a second "
                             "connection loss (resent at most once)",
                             self.name, len(spent))
                    for seq, buf in pending:
                        conn.send(Envelope(MSG_QUERY, seq=seq, buffer=buf))
                    logw("%s: failed over to %s:%s (%d requests resent)",
                         self.name, host, port, len(pending))
                    reconnected = True
                    break
                if not reconnected:
                    # one failure per SWEEP (not per address): the
                    # backoff/breaker tracks the outage, not the length
                    # of the alternate list
                    self._retry.failure(
                        errors[-1] if errors else "unreachable",
                        what="failover reconnect")
        if reconnected:
            if dropped_tomb or spent:
                # a removed head tombstone can unblock completed replies
                # parked behind it — same invariant as _expire.  Flushed
                # AFTER releasing _connlock: _flush_ready pushes
                # downstream, and a full sink would otherwise hold the
                # lock against chain() → _ensure_conn() (deadlock).
                self._flush_ready()
            return
        self.post_error(StreamError(
            f"{self.name}: connection lost and no server reachable "
            f"({'; '.join(errors)})"))
        self._reader_run.clear()

    def on_eos(self) -> None:
        """Drain in-flight requests before EOS propagates (answers still
        on the wire must not be cut off by downstream teardown)."""
        deadline = time.monotonic() + float(self.timeout) / 1000.0
        while time.monotonic() < deadline:
            with self._iflock:
                if not self._pushing and all(
                        e[0] is None and e[1] is None
                        for e in self._inflight.values()):
                    # empty, or ordering tombstones only: tombstones
                    # hold no deliverable data and there is nothing
                    # behind them to protect — don't stall EOS a full
                    # grace window for them
                    self._inflight.clear()
                    return
            time.sleep(0.005)

    def stop(self) -> None:
        self._reader_run.clear()
        if self._reader_thread is not None:
            self._reader_thread.join(timeout=2.0)
            self._reader_thread = None
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        if self._epoch_fn is not None:
            self._epoch_fn.stop()  # retire the SNTP refresh thread
        with self._iflock:
            self._inflight.clear()


# -- server source ------------------------------------------------------------


@register_element("tensor_query_serversrc")
class TensorQueryServerSrc(SourceElement):
    """Entry of the server pipeline: owns the transport, stamps queries
    with ``client_id`` routing meta."""

    FACTORY = "tensor_query_serversrc"

    def __init__(self, name=None, host: str = "localhost", port: int = 0,
                 connect_type: str = "tcp", id: int = 0, caps=None,
                 num_buffers: int = -1, topic: str = "",
                 data_host: str = "127.0.0.1", data_port: int = 0,
                 advertise_host: str = "", **props):
        self.host = host
        self.port = port
        self.connect_type = connect_type
        # the hybrid properties (ROADMAP item 5b; the transport raises
        # until then): topic registered at the broker (host:port), the
        # data plane bound at data_host:data_port (0.0.0.0/0 for
        # cross-host), advertise advertise_host when the bind address
        # isn't what clients should dial
        self.topic = topic
        self.data_host = data_host
        self.data_port = data_port
        self.advertise_host = advertise_host
        self.id = id
        self.caps = caps
        self.num_buffers = num_buffers
        super().__init__(name, **props)
        if isinstance(self.caps, str):
            from ..runtime.parser import parse_caps_string

            self.caps = parse_caps_string(self.caps)
        self._queue: "queue.Queue[Envelope]" = queue.Queue(maxsize=64)
        self._server = None
        self._count = 0

    def output_spec(self) -> TensorsSpec:
        if self.caps is not None:
            return self.caps.to_spec()
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def _on_message(self, client_id: int, env: Envelope) -> None:
        if env.mtype != MSG_QUERY or env.buffer is None:
            return
        if env.trace is not None:
            # t2 of the NTP-style exchange: stamped at transport
            # delivery, before any queueing in the server pipeline
            env.trace["t2"] = time.monotonic()
        try:
            self._queue.put_nowait(env)
        except queue.Full:
            logw("%s: query queue full, dropping client %d request",
                 self.name, client_id)

    def start(self) -> None:
        entry = query_server_entry(int(self.id))
        if self._server is None:
            self._server = make_server(self.host, int(self.port),
                                       self.connect_type)
            self._server.on_message = self._on_message
            self._server.caps_provider = lambda: entry.sink_caps
            self._server.start()
            # expose the actual port (port=0 binds an ephemeral one)
            self.port = getattr(self._server, "port", self.port)
            # after the bind so the peer label carries the real port
            # (no client can dial in before the port is known anyway)
            self._server.metrics = LinkMetrics.get(
                self.name, f"{self.host}:{self.port}", kind="query-server")
        entry.transport = self._server
        super().start()

    def stop(self) -> None:
        super().stop()
        if self._server is not None:
            self._server.stop()
            entry = query_server_entry(int(self.id))
            if entry.transport is self._server:
                entry.transport = None
            self._server = None

    def create(self) -> Optional[Buffer]:
        if 0 <= int(self.num_buffers) <= self._count:
            return None
        while self._running.is_set():
            try:
                env = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._count += 1
            buf = env.buffer
            # shallow-copy: never mutate the client's buffer (inproc
            # passes it by reference)
            buf = dataclasses.replace(buf, meta=dict(buf.meta))
            buf.meta["client_id"] = env.client_id
            buf.meta["query_seq"] = env.seq
            if env.trace is not None:
                # continue the client's trace in THIS process: the
                # planted dict collects hook marks through the server
                # pipeline and serversink echoes them in the reply
                tracectx.plant_server_trace(buf.meta, env.trace,
                                            self.name)
            return buf
        return None


# -- server sink --------------------------------------------------------------


@register_element("tensor_query_serversink")
class TensorQueryServerSink(SinkElement):
    """Exit of the server pipeline: routes each answer to the client that
    asked, via the ``client_id`` meta."""

    FACTORY = "tensor_query_serversink"

    def __init__(self, name=None, id: int = 0,
                 metaless_frame_limit: int = 2, **props):
        self.id = id
        self.metaless_frame_limit = metaless_frame_limit
        super().__init__(name, **props)
        self._metaless = 0

    def caps_negotiated(self, pad: Pad) -> None:
        # register the server pipeline's output caps so clients can
        # negotiate against them (parity: serversink set_caps →
        # gst_tensor_query_server_set_caps)
        if pad.caps is not None:
            query_server_entry(int(self.id)).sink_caps = str(pad.caps)

    def render(self, buf: Buffer) -> None:
        client_id = buf.meta.get("client_id")
        if client_id is None:
            self._metaless += 1
            logw("%s: no client_id meta on buffer — an element in the "
                 "server pipeline dropped routing meta", self.name)
            if self._metaless >= int(self.metaless_frame_limit):
                raise StreamError(
                    f"{self.name}: {self._metaless} metaless frames; "
                    "check elements used in the query-server pipeline")
            return
        self._metaless = 0
        entry = query_server_entry(int(self.id))
        if entry.transport is None:
            raise StreamError(
                f"{self.name}: no serversrc transport for id={self.id}")
        # echo a remote-origin trace back to the requester: marks
        # collected server-side + t2/t3 for its clock alignment
        ctx = tracectx.reply_ctx(buf.meta.get(TRACE_META_KEY))
        entry.transport.send(
            int(client_id),
            Envelope(MSG_REPLY, client_id=int(client_id),
                     seq=int(buf.meta.get("query_seq", 0)), buffer=buf,
                     trace=ctx))


# -- edge pub/sub -------------------------------------------------------------


@register_element("edgesink")
class EdgeSink(SinkElement):
    """Publish a tensor stream: subscribers (edgesrc) receive every
    rendered buffer for their topic.

    Parity: the reference's ``edge_sink`` (an nns_edge server publishing
    with ``topic``)."""

    FACTORY = "edgesink"

    def __init__(self, name=None, host: str = "localhost", port: int = 0,
                 connect_type: str = "tcp", topic: str = "",
                 data_host: str = "127.0.0.1", data_port: int = 0,
                 advertise_host: str = "", ntp_servers: str = "",
                 **props):
        self.host = host
        self.port = port
        self.connect_type = connect_type
        self.topic = topic
        self.data_host = data_host          # hybrid data-plane bind
        self.data_port = data_port
        self.advertise_host = advertise_host
        # one-way hop: trace alignment leans on wall clocks — with NTP
        # servers configured the epoch stamp is disciplined, otherwise
        # it is the local clock (subscriber-side spans may skew)
        self.ntp_servers = ntp_servers
        super().__init__(name, **props)
        self._server = None
        self.published = 0
        self._epoch_fn = async_ntp_epoch_fn(_parse_ntp_servers(ntp_servers)) \
            if str(ntp_servers or "").strip() else None

    def _epoch_us(self) -> int:
        return int(self._epoch_fn()) if self._epoch_fn is not None \
            else int(time.time() * 1e6)

    def start(self) -> None:
        if self._server is None:
            self._server = make_server(self.host, int(self.port),
                                       self.connect_type)
            self._server.caps_provider = lambda: (
                str(self.sinkpad.caps) if self.sinkpad.caps else "")
            self._server.start()
            self.port = getattr(self._server, "port", self.port)
            # after the bind so the peer label carries the real port
            self._server.metrics = LinkMetrics.get(
                self.name, f"{self.host}:{self.port}", kind="edge-pub")

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._epoch_fn is not None:
            self._epoch_fn.stop()

    def render(self, buf: Buffer) -> None:
        if self._server is None:
            raise StreamError(f"{self.name}: not started")
        env = Envelope(MSG_PUBLISH, info=str(self.topic), buffer=buf)
        tr = buf.meta.get(TRACE_META_KEY)
        if tr is not None:
            env.trace = tracectx.oneway_ctx(tr, self._epoch_us())
        self.published += self._server.publish(env)


@register_element("edgesrc")
class EdgeSrc(SourceElement):
    """Subscribe to a published tensor stream by topic.

    Parity: the reference's ``edge_src`` (an nns_edge client with
    ``dest-host``/``dest-port``/``topic``)."""

    FACTORY = "edgesrc"

    def __init__(self, name=None, dest_host: str = "localhost",
                 dest_port: int = 0, connect_type: str = "tcp",
                 topic: str = "", caps=None, num_buffers: int = -1,
                 ntp_servers: str = "", reconnect: bool = True,
                 reconnect_timeout_s: float = 30.0,
                 device_channel: bool = True, **props):
        self.dest_host = dest_host
        self.dest_port = dest_port
        self.connect_type = connect_type
        self.topic = topic
        self.caps = caps
        self.num_buffers = num_buffers
        # NTP-disciplined local epoch for one-way trace alignment (the
        # publisher should configure the same; see edgesink)
        self.ntp_servers = ntp_servers
        # self-healing: a dead publisher connection re-dials (and
        # re-subscribes) through the shared backoff/breaker policy
        # instead of spinning on a dead socket forever; an outage
        # longer than reconnect-timeout-s becomes a clean bus error
        self.reconnect = reconnect
        self.reconnect_timeout_s = reconnect_timeout_s
        # same-process fast path: announce our device fingerprint to the
        # publisher — on a match, published card-resident frames stay
        # on the card and only control frames ride the subscription socket
        # (transparent TCP fallback otherwise; see edgesink)
        self.device_channel = device_channel
        super().__init__(name, **props)
        if isinstance(self.caps, str):
            from ..runtime.parser import parse_caps_string

            self.caps = parse_caps_string(self.caps)
        self._conn = None
        self._count = 0
        self._metrics = None
        self._retry = RetryPolicy(name=self.name, base_s=0.2, max_s=2.0,
                                  fail_threshold=6, open_s=2.0)
        self._epoch_fn = async_ntp_epoch_fn(_parse_ntp_servers(ntp_servers)) \
            if str(ntp_servers or "").strip() else None

    def _epoch_us(self) -> int:
        return int(self._epoch_fn()) if self._epoch_fn is not None \
            else int(time.time() * 1e6)

    def _ensure_conn(self):
        if self._conn is None:
            self._conn = connect(self.dest_host, int(self.dest_port),
                                 self.connect_type)
            self._metrics = LinkMetrics.get(
                self.name, f"{self.dest_host}:{self.dest_port}",
                kind="edge-sub")
            self._conn.metrics = self._metrics
            self._retry.metrics = self._metrics
            self._retry._sync_metrics()
            self._conn.send(Envelope(MSG_SUBSCRIBE, info=str(self.topic)))
            if bool(self.device_channel):
                try:
                    self._conn.request_devch()
                except Exception:  # noqa: BLE001 - probe never kills
                    pass  # the subscription; plain TCP continues
        return self._conn

    def _reconnect(self, dead) -> Optional[object]:
        """Publisher gone mid-stream: re-dial + re-subscribe through
        the shared retry policy (backoff + breaker) until it answers,
        stop() interrupts, or the outage outlives
        ``reconnect-timeout-s`` (→ StreamError on the bus)."""
        try:
            dead.close()
        except Exception:  # noqa: BLE001
            pass
        self._conn = None
        deadline = time.monotonic() + float(self.reconnect_timeout_s)
        while self._running.is_set():
            if time.monotonic() >= deadline:
                raise StreamError(
                    f"{self.name}: publisher unreachable for "
                    f"{self.reconnect_timeout_s}s (gave up reconnecting)")
            if not self._retry.wait(max_s=max(
                    deadline - time.monotonic(), 0.05)):
                return None
            if not self._running.is_set():
                return None
            try:
                conn = self._ensure_conn()
            except OSError as e:
                self._retry.failure(e, what="re-subscribe")
                continue
            self._retry.success()
            if self._metrics is not None:
                self._metrics.reconnect()
            return conn
        return None

    def output_spec(self) -> TensorsSpec:
        if self.caps is not None:
            return self.caps.to_spec()
        from ..runtime.parser import parse_caps_string

        caps_str = self._ensure_conn().request_caps(timeout=2.0)
        if caps_str:
            try:
                return parse_caps_string(caps_str).to_spec()
            except Exception:  # noqa: BLE001
                logw("%s: unparseable publisher caps %r", self.name,
                     caps_str)
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def start(self) -> None:
        self._ensure_conn()
        super().start()

    def stop(self) -> None:
        super().stop()
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        if self._epoch_fn is not None:
            self._epoch_fn.stop()

    def create(self) -> Optional[Buffer]:
        if 0 <= int(self.num_buffers) <= self._count:
            return None
        conn = self._ensure_conn()
        while self._running.is_set():
            env = conn.recv(timeout=0.1)
            if env is None:
                if bool(self.reconnect) and not conn.is_alive():
                    conn = self._reconnect(conn)
                    if conn is None:
                        return None
                continue
            if env.mtype != MSG_PUBLISH or env.buffer is None:
                continue
            self._count += 1
            buf = env.buffer
            if env.trace is not None and _hooks.tracer is not None:
                # inproc publish shares the buffer object: never mutate
                # the publisher's meta in place
                buf = dataclasses.replace(buf, meta=dict(buf.meta))
                tracectx.plant_oneway(buf.meta, env.trace,
                                      self._epoch_us(), link=self.name,
                                      source_name=self.name)
            return buf
        return None
