"""Per-request serving traces: the port of
`paddle_tpu/monitor/trace.py`, with its spool schema
("paddle_tpu.trace/1"), so one tool reads both packages' spools.

A `trace_id` threads through every stage a request crosses: add,
route, admit, prefill, every decode token, evict, export, import,
failover and the terminal state. A slow token is then attributable to
queue wait, eviction recompute or failover replay from the request's
own timeline (`engine.get_request(req_id).trace`).

  * `mint()`: a unique trace id (`<rank>:<pid hex>:<seq hex>`), minted
    when a `Request` is built and kept across export/import, so the
    request replayed on a survivor carries the lost replica's id.
  * `note(req, stage, **data)`: appends one `{ts, stage, ...}` event to
    the request's bounded timeline (`PADDLE_TRACE_EVENTS`, default 256;
    drops count per request and under `trace/dropped`) and mirrors it
    into the flight ring. Armed by default; `PADDLE_TRACE_SERVE=0`
    disarms (or `arm(False)` / `disarm()`).
  * `export_requests()` / `to_chrome()`: the JSON spool per engine or
    router, and its chrome-trace rendering (rank r on pid
    r * pid_stride + 1, one tid per request).
"""
from __future__ import annotations

import itertools
import os
import time

from ..core import monitor as _cmon
from . import flight as _flight

__all__ = ["TRACE_SCHEMA", "mint", "note", "arm", "disarm",
           "max_events", "export_requests", "to_chrome"]

TRACE_SCHEMA = "paddle_tpu.trace/1"

# the hot-path gate (a module attribute, read, not called): serving
# call sites guard with `if _trace._armed:`, so PADDLE_TRACE_SERVE=0
# costs one attribute read per site
_armed = _flight._env_on("PADDLE_TRACE_SERVE", True)

_seq = itertools.count(1)


def max_events():
    """PADDLE_TRACE_EVENTS — per-request timeline cap (default 256).
    Read per call so tests can retune; a request's decode loop is the
    only unbounded producer (one event per token)."""
    return max(8, _flight._env_int("PADDLE_TRACE_EVENTS", 256))


def arm(on=True):
    """Flip tracing on/off (tests; production uses
    PADDLE_TRACE_SERVE)."""
    global _armed
    _armed = bool(on)
    return _armed


def disarm():
    return arm(False)


def mint():
    """Globally-unique trace id: `<rank>:<pid hex>:<seq hex>` — the
    rank+pid legs keep ids distinct across replicas and relaunches,
    the seq leg within a process."""
    return (f"{_flight._rank()}:{os.getpid():x}:"
            f"{next(_seq):x}")


def note(req, stage, **data):
    """Append one stage event to `req.trace` (bounded) and mirror it
    into the flight ring. No-op (one flag read) when disarmed; a
    request minted while disarmed (trace_id None) stays untraced even
    if tracing arms later — half a timeline would misattribute every
    gap before the arm."""
    if not _armed or req.trace_id is None:
        return
    tl = req.trace
    if len(tl) >= max_events():
        req.trace_dropped += 1
        _cmon.stat_add("trace/dropped", 1)
        return
    ev = {"ts": round(time.time(), 6), "stage": stage}
    if data:
        ev.update(data)
    tl.append(ev)
    _cmon.stat_add("trace/events", 1)
    _flight.record("trace", trace_id=req.trace_id, req=req.req_id,
                   stage=stage, **data)


# ---------------------------------------------------------------------------
# Spool + chrome-trace rendering
# ---------------------------------------------------------------------------

def export_requests(requests, rank=None, extra=None):
    """JSON-ready trace spool over Request-like objects (anything
    with req_id/trace_id/state/output_ids/trace/trace_dropped).
    Untraced requests (disarmed at mint time) are skipped."""
    entries = []
    for r in requests:
        if getattr(r, "trace_id", None) is None:
            continue
        e = {"req_id": r.req_id, "trace_id": r.trace_id,
             "state": r.state, "tokens": len(r.output_ids),
             "events": list(r.trace), "dropped": r.trace_dropped}
        if extra:
            e.update(extra)
        entries.append(e)
    return {"schema": TRACE_SCHEMA,
            "rank": _flight._rank() if rank is None else int(rank),
            "ts": round(time.time(), 3),
            "requests": entries}


def to_chrome(spools, pid_stride=100000):
    """Chrome-trace events for one or more trace spools, laid out
    merge-traces-compatibly: rank r's events land on pid
    `r*pid_stride + 1` (pid 0 is the profiler's host-span track in a
    merged file), one tid per request with a thread_name metadata row
    naming `req_id [trace_id]`. Consecutive stage events become ph
    "X" spans (each stage's duration = gap to the next event — the
    queue-wait / recompute / replay attribution), the final event an
    instant; every event's data rides in args."""
    events = []
    tid_seq = itertools.count(1)
    for spool in spools:
        rank = int(spool.get("rank") or 0)
        pid = rank * int(pid_stride) + 1
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"rank{rank} serving"}})
        for entry in spool.get("requests") or []:
            evs = entry.get("events") or []
            if not evs:
                continue
            tid = next(tid_seq)
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid,
                "args": {"name": f"{entry.get('req_id')} "
                                 f"[{entry.get('trace_id')}]"}})
            for i, ev in enumerate(evs):
                args = {k: v for k, v in ev.items()
                        if k not in ("ts", "stage")}
                args["trace_id"] = entry.get("trace_id")
                ts_us = float(ev["ts"]) * 1e6
                if i + 1 < len(evs):
                    dur = max(0.0,
                              (float(evs[i + 1]["ts"]) - float(ev["ts"]))
                              * 1e6)
                    events.append({"ph": "X", "name": ev["stage"],
                                   "ts": ts_us, "dur": dur,
                                   "pid": pid, "tid": tid,
                                   "args": args})
                else:
                    events.append({"ph": "i", "s": "t",
                                   "name": ev["stage"], "ts": ts_us,
                                   "pid": pid, "tid": tid,
                                   "args": args})
    return {"traceEvents": events,
            "metadata": {"source": TRACE_SCHEMA,
                         "pid_stride": int(pid_stride)}}
