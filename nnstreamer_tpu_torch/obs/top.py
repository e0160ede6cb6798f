"""``nns-top`` — live per-pipeline terminal view (gst-top / NNShark
parity for this runtime), fleet-capable.

Counterpart of the JAX package's ``obs/top.py``, reading the same
snapshot keys.  The MESH section renders the ``mesh`` table
(``obs/meshstat.py``: one row per data shard, its device, frames, share,
imbalance, pad and replicated dispatches); the port compiles no XLA
programs, so there is no COMPILE section; LINK rows render from the edge
links (``edge/``).

Renders, per registered pipeline, one row per element: frames/s in/out
(counter deltas between two registry snapshots), queue depth/capacity,
rolling invoke latency, dispatches/s, batch occupancy — plus one row per
serving-pool entry (refcount, attached streams, cross-stream dispatch
rate, frames/dispatch, stream occupancy, parked frames) and one LINK
row per edge connection (tx/rx bytes and messages per second, RTT,
in-flight, timeouts, reconnects — the ``nns_edge_*`` family).  When an
``obs/watch.py`` watchdog exported alert state into the scraped
registry, an ALERTS section renders every rule's firing state and
cumulative fire count (``nns_alert_state`` / ``nns_alerts_fired_total``).

Data source:

- ``--connect HOST:PORT`` scrapes the ``/json`` endpoint of any process
  serving its registry (``serve_metrics(port)`` or the
  ``NNS_TPU_TORCH_METRICS_PORT`` env hook) — observe a running server
  without instrumenting it.  Repeat the flag (or comma-separate) to
  watch a FLEET: every endpoint's pipelines/pools/links render in one
  table, sectioned per host.  In live mode an endpoint that stops
  answering shows as ``unreachable (retrying)`` and polling continues —
  a restarting server doesn't kill the dashboard;
- with no ``--connect``, the *in-process* global registry is read
  (embedding ``top.main(["--once"])`` in a host application or test).
  ``NNS_TPU_TORCH_METRICS_PORT`` set in the environment doubles as the
  default connect target, so ``NNS_TPU_TORCH_METRICS_PORT=9464 nns-top``
  observes the process that exported on that port.

``--once`` takes two samples ``--interval`` apart, prints one table and
exits; the default live mode repaints every interval until Ctrl-C.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

CLEAR = "\x1b[2J\x1b[H"


# the one scrape/parse implementation (incl. the truncated-JSON /
# HTTPException tolerance) lives in obs/scrape.py, shared with the
# watchdog's fleet mode; re-exported here because embedding callers and
# tests monkeypatch `top.fetch_snapshot`
from .scrape import fetch_snapshot  # noqa: F401 - re-export

from . import scrape as _scrape


def fetch_fleet(endpoints: List[Optional[str]]) -> List[dict]:
    """One sample per endpoint (see :func:`obs.scrape.fetch_fleet`);
    routes through THIS module's ``fetch_snapshot`` name so a
    monkeypatched fetch is honored."""
    return _scrape.fetch_fleet(endpoints, fetch=fetch_snapshot)


# -- rate math ---------------------------------------------------------------


def _index(snap: dict) -> Dict[Tuple[str, str], dict]:
    out = {}
    for p in snap.get("pipelines", []):
        for row in p.get("elements", []):
            out[(p["pipeline"], row["element"])] = row
    return out


def _pool_index(snap: dict) -> Dict[str, dict]:
    return {row["pool"]: row for row in snap.get("pools", [])}


def _xfer_index(snap: dict) -> Dict[Tuple[str, str], Tuple[int, int]]:
    """(pipeline, source) -> (total crossings, total bytes) summed over
    directions/reasons — the XFER B/s and X/FRAME columns' source."""
    out: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for row in snap.get("transfers", []):
        key = (row["pipeline"], row["source"])
        c, b = out.get(key, (0, 0))
        out[key] = (c + row["count"], b + row["bytes"])
    return out


def _exec_index(snap: dict) -> Dict[str, List[dict]]:
    """model name -> executable rows (the MFU column's source: the
    scrape-time join already annotated live mfu per bucket)."""
    out: Dict[str, List[dict]] = {}
    for row in snap.get("executables", []):
        out.setdefault(row["source"], []).append(row)
    return out


def _mfu_of(execs: Dict[str, List[dict]],
            model: Optional[str]) -> Optional[float]:
    """Best live MFU across the model's executables (None when the
    backend has no known hardware spec or nothing was measured)."""
    if not model:
        return None
    vals = [r["mfu"] for r in execs.get(model, []) if "mfu" in r]
    return max(vals) if vals else None


def _rate(cur: float, prev: Optional[float], dt: float) -> Optional[float]:
    if prev is None or dt <= 0:
        return None
    return max(cur - prev, 0) / dt


def _fmt(v, width: int, prec: int = 1) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{prec}f}".rjust(width)
    return str(v).rjust(width)


# -- rendering ---------------------------------------------------------------


def _dev_host_us(stats: dict) -> Tuple[Optional[int], Optional[int]]:
    """(device µs, host µs) of a filter/pool stats dict: the rolling
    phase means from the cost-attribution split — host is prep+drain.
    None before the first sampled dispatch (and for snapshots from
    older processes that don't carry the fields)."""
    dev = stats.get("device_us", -1)
    prep = stats.get("host_prep_us", -1)
    drain = stats.get("host_drain_us", -1)
    if dev is None or dev < 0:
        return None, None
    host = max(prep, 0) + max(drain, 0)
    return dev, host


def render(cur: dict, prev: Optional[dict] = None) -> str:
    """One terminal table from a snapshot (rates need ``prev``)."""
    dt = (cur.get("time", 0) - prev.get("time", 0)) if prev else 0.0
    prev_rows = _index(prev) if prev else {}
    prev_pools = _pool_index(prev) if prev else {}
    xfers = _xfer_index(cur)
    prev_xfers = _xfer_index(prev) if prev else {}
    lines: List[str] = []
    execs = _exec_index(cur)
    hdr = (f"{'ELEMENT':<18}{'FACTORY':<18}{'IN/s':>9}{'OUT/s':>9}"
           f"{'QUEUE':>9}{'LAT µs':>9}{'DEV µs':>9}{'HOST µs':>9}"
           f"{'MFU%':>7}{'DISP/s':>9}{'B-OCC':>7}{'S-OCC':>7}"
           f"{'XFER B/s':>11}{'X/FRAME':>9}")
    for p in cur.get("pipelines", []):
        state = "PLAYING" if p.get("playing") else "STOPPED"
        lines.append(f"pipeline {p['pipeline']} [{state}]")
        lines.append("  " + hdr)
        for row in p.get("elements", []):
            pv = prev_rows.get((p["pipeline"], row["element"]), {})
            stats = row.get("stats", {})
            pstats = pv.get("stats", {})
            fin = _rate(stats.get("buffers_in", 0),
                        pstats.get("buffers_in"), dt)
            fout = _rate(stats.get("buffers_out", 0),
                         pstats.get("buffers_out"), dt)
            q = row.get("queue")
            qcol = f"{q['depth']}/{q['capacity']}" if q else None
            f = row.get("filter")
            lat = disp = bocc = socc = dev = host = mfu = None
            if f:
                lat = f["latency_us"] if f["latency_us"] >= 0 else None
                pf = pv.get("filter") or {}
                disp = _rate(f["invokes"], pf.get("invokes"), dt)
                bocc = f["avg_batch_occupancy"]
                socc = f["avg_stream_occupancy"]
                dev, host = _dev_host_us(f)
                m = _mfu_of(execs, f.get("model"))
                mfu = m * 100.0 if m is not None else None
            # row absent from prev = first crossings happened inside
            # this window: delta from zero, like the stats columns
            xrate, xpf = _xfer_cols(
                xfers.get((p["pipeline"], row["element"])),
                prev_xfers.get((p["pipeline"], row["element"]),
                               (0, 0) if prev else None),
                stats.get("buffers_in", 0), pstats.get("buffers_in"),
                dt)
            lines.append(
                "  " + f"{row['element']:<18.18}{row['factory']:<18.18}"
                + _fmt(fin, 9) + _fmt(fout, 9)
                + (qcol.rjust(9) if qcol else "-".rjust(9))
                + _fmt(lat, 9, 0) + _fmt(dev, 9, 0) + _fmt(host, 9, 0)
                + _fmt(mfu, 7, 2) + _fmt(disp, 9) + _fmt(bocc, 7, 2)
                + _fmt(socc, 7, 2) + _fmt(xrate, 11, 0)
                + _fmt(xpf, 9, 2))
        lines.append("")
    pools = cur.get("pools", [])
    if pools:
        lines.append(
            f"{'POOL':<28}{'REF':>5}{'STREAMS':>9}{'DISP/s':>9}"
            f"{'FRM/DISP':>10}{'S-OCC':>7}{'PENDING':>9}{'LAT µs':>9}"
            f"{'DEV µs':>9}{'HOST µs':>9}{'MFU%':>7}{'HIT/MISS':>10}"
            f"{'XFER B/s':>11}{'WGT MB':>8}"
            f"{'SHARE%':>8}{'IMBAL':>8}{'PAD%':>7}")
        for row in pools:
            s = row["stats"]
            ps = (prev_pools.get(row["pool"]) or {}).get("stats", {})
            disp = _rate(s["invokes"], ps.get("invokes"), dt)
            pend = (row.get("batcher") or {}).get("pending")
            lat = s["latency_us"] if s["latency_us"] >= 0 else None
            dev, host = _dev_host_us(s)
            m = _mfu_of(execs, row.get("model"))
            mfu = m * 100.0 if m is not None else None
            cache = row.get("cache")
            hm = f"{cache['hits']}/{cache['misses']}" if cache else None
            xrate, _xpf = _xfer_cols(
                xfers.get(("", row["pool"])),
                prev_xfers.get(("", row["pool"]),
                               (0, 0) if prev else None), 0, None, dt)
            w = row.get("weights")
            wmb = w["bytes"] / 1e6 if w else None
            # mesh join (sharded pools only): hottest shard's share of
            # the pool's frames, window imbalance, pad waste — the
            # pool's skew next to its MFU instead of pages away
            pm = row.get("mesh")
            share = pm["max_shard_share"] * 100.0 if pm else None
            imbal = pm["imbalance"] if pm else None
            padp = pm["pad_frac"] * 100.0 if pm else None
            lines.append(
                f"{row['pool']:<28.28}" + _fmt(row["refcount"], 5)
                + _fmt(row["streams"], 9) + _fmt(disp, 9)
                + _fmt(s["avg_batch_occupancy"], 10, 2)
                + _fmt(s["avg_stream_occupancy"], 7, 2)
                + _fmt(pend, 9) + _fmt(lat, 9, 0)
                + _fmt(dev, 9, 0) + _fmt(host, 9, 0)
                + _fmt(mfu, 7, 2)
                + (hm.rjust(10) if hm else "-".rjust(10))
                + _fmt(xrate, 11, 0) + _fmt(wmb, 8, 1)
                + _fmt(share, 8, 1) + _fmt(imbal, 8, 3)
                + _fmt(padp, 7, 2))
        lines.append("")
    tenants = cur.get("tenants", [])
    if tenants:
        # tenancy view (obs/tenantstat.py): who consumed the pools'
        # device-seconds — frames, exactly-attributed device time,
        # scrape-time dollars, SLO attainment, sheds
        prev_ten = {(r["pool"], r["tenant"]): r
                    for r in (prev or {}).get("tenants", [])}
        lines.append(
            f"{'TENANT':<16}{'POOL':<26}{'FRM/s':>9}{'FRAMES':>10}"
            f"{'DEV s':>9}{'$':>9}{'$/KFRM':>9}{'SLO%':>7}{'SHED':>7}")
        for row in tenants:
            pv = prev_ten.get((row["pool"], row["tenant"]), {})
            frate = _rate(row["frames"], pv.get("frames"), dt)
            dpk = (row["dollars"] / row["frames"] * 1e3) \
                if row["frames"] else None
            slo = row["slo_attainment"] * 100.0 \
                if row["slo_attainment"] is not None else None
            shed = sum(row.get("shed", {}).values())
            lines.append(
                f"{row['tenant']:<16.16}{row['pool']:<26.26}"
                + _fmt(frate, 9) + _fmt(row["frames"], 10)
                + _fmt(row["device_seconds"], 9, 3)
                + _fmt(row["dollars"], 9, 4) + _fmt(dpk, 9, 4)
                + _fmt(slo, 7, 1) + _fmt(shed, 7))
        lines.append("")
    stages = cur.get("stages", [])
    if stages:
        # pipeline-split view (stagestat.py): handoff rows show the
        # device-to-device flow INTO a stage's subset — rate of exact
        # payload bytes, frames, and the inter-stage queue depth
        # (handed off but not yet emitted); offload rows show a routing
        # tensor_if's cascade split.  Dashes mark the columns the other
        # kind owns.
        prev_stages = {(r["kind"], r["pipeline"], r["stage"]): r
                       for r in (prev or {}).get("stages", [])}
        lines.append(
            f"{'STAGE':<20}{'PIPELINE':<14}{'KIND':<9}{'ROUTE':<14}"
            f"{'HANDOFF B/s':>13}{'FRM/s':>8}{'DEPTH':>7}"
            f"{'OFFLOAD%':>10}{'OFF/KEPT':>11}")
        for row in stages:
            pv = prev_stages.get(
                (row["kind"], row["pipeline"], row["stage"]), {})
            if row["kind"] == "handoff":
                brate = _rate(row["bytes"], pv.get("bytes"), dt)
                frate = _rate(row["frames"], pv.get("frames"), dt)
                route = f"{row['from']}>{row['to']}"
                lines.append(
                    f"{row['stage']:<20.20}{row['pipeline']:<14.14}"
                    f"{'handoff':<9}{route:<14.14}"
                    + _fmt(brate, 13, 0) + _fmt(frate, 8)
                    + _fmt(row["depth"], 7)
                    + "-".rjust(10) + "-".rjust(11))
            else:
                ok = f"{row['offloaded']}/{row['kept']}"
                lines.append(
                    f"{row['stage']:<20.20}{row['pipeline']:<14.14}"
                    f"{'offload':<9}{(row['to'] or '-'):<14.14}"
                    + "-".rjust(13) + "-".rjust(8) + "-".rjust(7)
                    + _fmt(row["ratio"] * 100.0, 10, 1)
                    + ok.rjust(11))
        lines.append("")
    models = cur.get("models", [])
    if models:
        # model lifecycle (runtime/lifecycle.py): version registry of
        # every pool that swapped/canaried — per-version serving stats
        # next to state + provenance
        prev_models = {(r["pool"], r["version"]): r
                       for r in (prev or {}).get("models", [])}
        lines.append(
            f"{'MODELS':<28}{'VERSION':<12}{'STATE':<12}{'FRM/s':>9}"
            f"{'FRAMES':>10}{'LAT µs':>9}{'ERRORS':>8}{'CANARY':>8}"
            f"{'LOAD s':>8}  SOURCE")
        for row in models:
            pv = prev_models.get((row["pool"], row["version"]), {})
            frate = _rate(row["frames"], pv.get("frames"), dt)
            lat = row["latency_us"] if row["latency_us"] >= 0 else None
            canary = f"1/{row['canary_n']}" if row.get("canary_n") \
                else "-"
            lines.append(
                f"{row['pool']:<28.28}{row['version']:<12.12}"
                f"{row['state']:<12.12}"
                + _fmt(frate, 9) + _fmt(row["frames"], 10)
                + _fmt(lat, 9, 0) + _fmt(row["errors"], 8)
                + canary.rjust(8) + _fmt(row["load_s"], 8, 3)
                + f"  {row.get('source', '')}"[:40])
        lines.append("")
    mesh = cur.get("mesh", [])
    if mesh:
        from .meshstat import shard_device_label

        prev_mesh = {r["source"]: r for r in (prev or {}).get("mesh", [])}
        lines.append(
            f"{'MESH':<24}{'TOPOLOGY':<16}{'SHARD':>7}{'DEVICE':>22}"
            f"{'FRAMES':>10}{'FRM/s':>9}{'SHARE%':>8}{'IMBAL':>8}"
            f"{'PAD%':>7}{'REPL':>6}")
        for row in mesh:
            topo = ",".join(f"{n}:{s}" for n, s in row["axes"])
            pv = prev_mesh.get(row["source"], {})
            total = sum(row["shard_frames"]) or 1
            psf = pv.get("shard_frames", [])
            for i, n in enumerate(row["shard_frames"]):
                dev = shard_device_label(row, i, empty="-")
                frate = _rate(n, psf[i] if i < len(psf) else None, dt)
                lines.append(
                    (f"{row['source']:<24.24}" if i == 0
                     else " " * 24)
                    + (f"{topo:<16.16}" if i == 0 else " " * 16)
                    + _fmt(i, 7) + dev[:22].rjust(22)
                    + _fmt(n, 10) + _fmt(frate, 9, 0)
                    + _fmt(n / total * 100.0, 8, 1)
                    + (_fmt(row["imbalance"], 8, 3) if i == 0
                       else "-".rjust(8))
                    + (_fmt(row["pad_frac"] * 100.0, 7, 2) if i == 0
                       else "-".rjust(7))
                    + (_fmt(row["replicated_dispatches"], 6)
                       if i == 0 else "-".rjust(6)))
        lines.append("")
    devmem = cur.get("device_memory", [])
    if devmem:
        lines.append(
            f"{'DEVICE':<28}{'IN-USE MB':>11}{'PEAK MB':>10}"
            f"{'LIMIT MB':>10}")
        for row in devmem:
            lines.append(
                f"{row['device']:<28.28}"
                + _fmt(_mb(row.get("in_use")), 11, 1)
                + _fmt(_mb(row.get("peak")), 10, 1)
                + _fmt(_mb(row.get("limit")), 10, 1))
        lines.append("")
    links = cur.get("links", [])
    if links:
        prev_links = _link_index(prev) if prev else {}
        lines.append(
            f"{'LINK':<16}{'PEER':<22}{'KIND':<13}{'TX/s':>10}"
            f"{'RX/s':>10}{'MSG/s':>8}{'RTT µs':>9}{'INFL':>6}"
            f"{'TO':>5}{'RECON':>7}{'BRKR':>6}{'BKOFF':>7}")
        for row in links:
            pv = prev_links.get((row["kind"], row["link"], row["peer"]),
                                {})
            txr = _rate(row["tx_bytes"], pv.get("tx_bytes"), dt)
            rxr = _rate(row["rx_bytes"], pv.get("rx_bytes"), dt)
            msgr = _rate(row["tx_msgs"] + row["rx_msgs"],
                         (pv["tx_msgs"] + pv["rx_msgs"]) if pv else None,
                         dt)
            rtt = _window_rtt_us(row["rtt"], pv.get("rtt"))
            brkr = {0: "ok", 1: "half", 2: "OPEN"}.get(
                row.get("breaker_state", 0), "?")
            lines.append(
                f"{row['link']:<16.16}{row['peer']:<22.22}"
                f"{row['kind']:<13.13}"
                + _fmt(txr, 10, 0) + _fmt(rxr, 10, 0) + _fmt(msgr, 8)
                + _fmt(rtt, 9, 0) + _fmt(row["inflight"], 6)
                + _fmt(row["timeouts"], 5) + _fmt(row["reconnects"], 7)
                + brkr.rjust(6) + _fmt(row.get("backoff_level", 0), 7))
        lines.append("")
    fc = cur.get("forecasts") or {}
    if fc.get("rules") or fc.get("capacity"):
        # predictive view (obs/forecast.py): each forecast rule's
        # fitted trajectory + crossing ETA, then the capacity join —
        # forecast arrivals vs sustainable rate per pool
        lines.append(
            f"{'FORECAST':<22}{'METRIC':<30}{'VALUE@H':>10}"
            f"{'THRESH':>9}{'ETA s':>8}{'HRZN s':>8}{'STATE':>8}")
        for row in fc.get("rules", []):
            eta = row.get("eta_s")
            lines.append(
                f"{row['rule']:<22.22}{row['metric']:<30.30}"
                + _fmt(row.get("value"), 10, 1)
                + _fmt(row.get("threshold"), 9, 1)
                + _fmt(eta, 8, 1)
                + _fmt(row.get("horizon_s"), 8, 0)
                + ("FIRING" if row.get("firing") else "ok").rjust(8))
        for row in fc.get("capacity", []):
            lines.append(
                f"{'capacity':<22.22}{row['pool']:<30.30}"
                + _fmt(row.get("predicted_fps"), 10, 1)
                + _fmt(row.get("sustainable_fps"), 9, 1)
                + "-".rjust(8) + "-".rjust(8)
                + (f"{row['headroom'] * 100.0:+.0f}%").rjust(8))
        lines.append("")
    alerts = _alert_rows(cur)
    if alerts:
        lines.append(
            f"{'ALERT':<28}{'SEVERITY':<10}{'STATE':>8}{'FIRED':>7}")
        for row in alerts:
            lines.append(
                f"{row['rule']:<28.28}{row['severity']:<10.10}"
                + ("FIRING" if row["state"] else "ok").rjust(8)
                + _fmt(row["fired"], 7))
        lines.append("")
    profd = cur.get("profile") or {}
    prows = profd.get("elements", [])
    if prows:
        # host-execution view (obs/prof.py): per element-loop thread,
        # CPU%/RUN%/WAIT% over the sampling window (exact accounting),
        # SAMP% lifetime profiler sample share, then the top sampled
        # stacks and the profiler's own state
        prev_prof = {}
        for r in ((prev or {}).get("profile") or {}).get("elements",
                                                         []):
            prev_prof[(r["pipeline"], r["element"])] = r
        lines.append(
            f"{'PROF ELEMENT':<18}{'PIPELINE':<16}{'CPU%':>7}"
            f"{'RUN%':>7}{'WAIT%':>7}{'SAMP%':>7}{'ITERS':>9}")
        for row in prows:
            pv = prev_prof.get((row["pipeline"], row["element"]), {})
            cpu = _rate(row["cpu_s"], pv.get("cpu_s"), dt)
            run = _rate(row["run_s"], pv.get("run_s"), dt)
            wait = _rate(row["wait_s"], pv.get("wait_s"), dt)
            lines.append(
                f"{row['element']:<18.18}{row['pipeline']:<16.16}"
                + _fmt(cpu * 100.0 if cpu is not None else None, 7, 1)
                + _fmt(run * 100.0 if run is not None else None, 7, 1)
                + _fmt(wait * 100.0 if wait is not None else None,
                       7, 1)
                + _fmt(row.get("sample_share", 0.0) * 100.0, 7, 1)
                + _fmt(row.get("iters"), 9, 0))
        for s in profd.get("stacks", [])[:3]:
            leaf = s["stack"].rsplit(";", 1)[-1]
            lines.append(f"  top stack: {s['label']} {leaf} "
                         f"x{s['count']}")
        psum = profd.get("profiler") or {}
        if psum.get("running"):
            lines.append(
                f"  profiler: {psum.get('hz', 0):g} Hz  ticks "
                f"{psum.get('ticks', 0)}  stacks "
                f"{psum.get('stacks', 0)}  gil_waiters "
                f"{profd.get('gil_waiters', 0)}")
        lines.append("")
    ctl = cur.get("control") or {}
    if ctl.get("controllers"):
        lines.append(
            f"CONTROL  playbooks: "
            f"{','.join(ctl.get('playbooks', [])) or '-'}  "
            f"actions: {ctl.get('actions_total', 0)}")
        audit = ctl.get("audit", [])
        if audit:
            # the one decision-row renderer, shared with `nns-ctl
            # --audit` so the two views can never drift
            from .control import render_audit

            lines.append(render_audit(audit[-6:], indent="  "))
        lines.append("")
    if not cur.get("pipelines") and not pools and not links:
        lines.append("(no registered pipelines, pools or links)")
    return "\n".join(lines)


def _alert_rows(snap: dict) -> List[dict]:
    """The ALERTS table: the watchdog's exported ``nns_alert_state``
    gauges joined with the ``nns_alerts_fired_total`` counters (empty
    when no ``obs/watch.py`` watchdog exported into this registry —
    local or scraped alike, since both ride the snapshot's flat metric
    families)."""
    fams = snap.get("metrics", {})
    state = fams.get("nns_alert_state", {})
    fired = {}
    for s in fams.get("nns_alerts_fired_total", {}).get("samples", []):
        key = (s["labels"].get("rule", "?"),
               s["labels"].get("severity", "?"))
        fired[key] = s["value"]
    rows = []
    for s in state.get("samples", []):
        rule = s["labels"].get("rule", "?")
        sev = s["labels"].get("severity", "?")
        rows.append({"rule": rule, "severity": sev,
                     "state": bool(s["value"]),
                     "fired": int(fired.get((rule, sev), 0))})
    # firing first, then by name — the live view surfaces trouble
    rows.sort(key=lambda r: (not r["state"], r["rule"]))
    return rows


def _mb(v) -> Optional[float]:
    return v / 1e6 if v is not None else None


def _xfer_cols(cur: Optional[Tuple[int, int]],
               prev: Optional[Tuple[int, int]],
               frames_in: int, prev_frames_in: Optional[int],
               dt: float) -> Tuple[Optional[float], Optional[float]]:
    """(XFER B/s, crossings-per-frame) of one element/pool over the
    sampling window: byte-rate from the ledger's cumulative bytes, and
    crossings over the window divided by the frames the element took
    in over the same window."""
    if cur is None:
        return None, None
    count, nbytes = cur
    pc, pb = prev if prev is not None else (None, None)
    brate = _rate(nbytes, pb, dt)
    xpf = None
    if pc is not None and prev_frames_in is not None:
        dframes = frames_in - prev_frames_in
        if dframes > 0:
            xpf = max(count - pc, 0) / dframes
    return brate, xpf


def _link_index(snap: dict) -> Dict[Tuple[str, str, str], dict]:
    return {(r["kind"], r["link"], r["peer"]): r
            for r in snap.get("links", [])}


def _window_rtt_us(cur_rtt: dict, prev_rtt: Optional[dict]
                   ) -> Optional[float]:
    """Mean RTT over the sampling window (cumulative sum/count deltas);
    falls back to the all-time mean for the first sample."""
    if prev_rtt:
        dn = cur_rtt["count"] - prev_rtt["count"]
        if dn > 0:
            return (cur_rtt["sum_s"] - prev_rtt["sum_s"]) / dn * 1e6
    return cur_rtt.get("mean_us")


def render_fleet(samples: List[dict],
                 prev: Dict[str, Optional[dict]],
                 show_host: bool) -> str:
    """One table for N endpoints: per-host section headers when the
    fleet has more than one member (or when asked), unreachable
    endpoints called out without dropping their section."""
    parts: List[str] = []
    for entry in samples:
        ep = entry["endpoint"]
        if entry["snap"] is None:
            parts.append(f"endpoint {ep}: unreachable (retrying) — "
                         f"{entry['error']}")
            parts.append("")
            continue
        if show_host:
            host = entry["snap"].get("host", "")
            parts.append(f"endpoint {ep}" + (f" [{host}]" if host else ""))
        parts.append(render(entry["snap"], prev.get(ep)))
    return "\n".join(parts)


# -- CLI ---------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nns-torch-top",
        description="Live per-pipeline observability table")
    p.add_argument("--connect", metavar="HOST:PORT[,HOST:PORT...]",
                   action="append", default=None,
                   help="scrape a remote process's /json metrics "
                        "endpoint; repeat (or comma-separate) for a "
                        "fleet — every endpoint renders in one table "
                        "(default: in-process registry, or "
                        "127.0.0.1:$NNS_TPU_TORCH_METRICS_PORT when set)")
    p.add_argument("--once", action="store_true",
                   help="print one table (two samples --interval apart) "
                        "and exit")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between samples/repaints (default 2)")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="dump the raw snapshot JSON instead of the table")
    return p


def _default_connect() -> Optional[str]:
    port = os.environ.get("NNS_TPU_TORCH_METRICS_PORT", "")
    return f"127.0.0.1:{port}" if port else None


def _endpoints(args) -> List[Optional[str]]:
    """Normalize --connect into the endpoint list: flatten repeats and
    comma lists.  No flag at all → the env default or the in-process
    registry; an explicit empty value (``--connect ""``) always means
    the in-process registry, env var or not."""
    eps: List[Optional[str]] = []
    for item in args.connect or []:
        for tok in str(item).split(","):
            tok = tok.strip()
            if tok:
                eps.append(tok)
    if not eps:
        eps.append(None if args.connect is not None
                   else _default_connect())
    return eps


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    endpoints = _endpoints(args)
    # hosts label every remote section; the bare in-process view keeps
    # the old single-table shape
    show_host = any(ep is not None for ep in endpoints)
    try:
        if args.as_json:
            samples = fetch_fleet(endpoints)
            doc = samples[0]["snap"] if len(samples) == 1 \
                else {s["endpoint"]: s["snap"] for s in samples}
            if len(samples) == 1 and samples[0]["error"]:
                print(f"nns-top: cannot reach {samples[0]['endpoint']}: "
                      f"{samples[0]['error']}", file=sys.stderr)
                return 1
            print(json.dumps(doc, indent=1), file=out)
            return 0
        if args.once:
            first = fetch_fleet(endpoints)
            time.sleep(max(args.interval, 0.05))
            cur = fetch_fleet(endpoints)
            prev = {s["endpoint"]: s["snap"] for s in first}
            print(render_fleet(cur, prev, show_host), file=out)
            # --once against a fully dead fleet is an error; a partial
            # outage still rendered what answered
            if all(s["snap"] is None for s in cur):
                for s in cur:
                    print(f"nns-top: cannot reach {s['endpoint']}: "
                          f"{s['error']}", file=sys.stderr)
                return 1
            return 0
        prev: Dict[str, Optional[dict]] = {}
        while True:
            cur = fetch_fleet(endpoints)
            if out is sys.stdout and out.isatty():
                out.write(CLEAR)
            print(render_fleet(cur, prev, show_host), file=out)
            out.flush()
            # a dead endpoint keeps its last snapshot as rate baseline
            # for when it comes back
            for s in cur:
                if s["snap"] is not None:
                    prev[s["endpoint"]] = s["snap"]
            time.sleep(max(args.interval, 0.05))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
