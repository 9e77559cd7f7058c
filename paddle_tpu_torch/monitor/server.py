"""paddle_tpu_torch.monitor.server — the live introspection plane, the
port of `paddle_tpu/monitor/server.py` (:79-602).

A stdlib-`http.server` debug server on ONE daemon thread, reading the
same registries every other artifact reads:

    srv = monitor.serve(port=0)        # ephemeral port; srv.port
    curl http://host:8899/metrics      # Prometheus exposition
    curl http://host:8899/statusz      # build/device/env summary

Arming — `PADDLE_MONITOR_SERVE=<port>` arms `maybe_auto_serve()`,
which `hapi.Model.fit` and the serving `Router` call (`0` arms an
ephemeral port); with the env var unset NOTHING happens (no thread,
no socket).

Endpoints (ROUTES below is the single source of truth):

    /metrics    Prometheus exposition — the SAME renderer the
                MetricsExporter prom textfile uses
                (monitor.prometheus_text); ?format=json returns the
                raw telemetry_snapshot()
    /healthz    liveness: 200 "ok"
    /statusz    version/rank/device/env/server summary (JSON)
    /flightz    flight-ring tail (?n=256; ?format=chrome for a
                Perfetto-loadable span view)
    /memz       memory report (device stats + per-program footprints
                + live-tensor census)
    /perfz      roofline ledger report (perf.perf_report())
    /tracez     per-request serving trace spools of every live engine
                (registered weakly)
    /profilez   on-demand capture window: ?duration_ms=N&profiler=0
                records a flight-ring segment and returns the bundle;
                the profiler window answers 501 until `profiler/` is
                ported (ROADMAP queue 1 item 4, Waits)
    /alertz     alert engine state

Shutdown is IDEMPOTENT and total — stop_server() / shutdown() can be
called twice, from atexit, or from the flight excepthook's crash path
without raising.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..core import monitor as _cmon
from . import flight as _flight
from . import sanitize as _sanitize

__all__ = [
    "ROUTES", "DebugServer", "serve", "get_server", "stop_server",
    "maybe_auto_serve", "add_trace_source", "trace_spools",
    "describe", "flight_chrome",
]

# (path, payload, armed-by) — the JAX package's table, route for route
ROUTES = (
    ("/metrics", "Prometheus exposition of the full StatRegistry "
                 "(scalars + _bucket histograms); ?format=json for "
                 "the raw telemetry_snapshot()", "always"),
    ("/healthz", "liveness: 200 `ok`", "always"),
    ("/statusz", "version/rank/device/env/server summary (JSON)",
     "always"),
    ("/flightz", "flight-ring tail as JSON (?n=256) or chrome trace "
                 "(?format=chrome)", "PADDLE_FLIGHT_ENABLE"),
    ("/memz", "memory report: device stats, per-program "
              "footprints, live-tensor census", "PADDLE_MEM_PROGRAM"),
    ("/perfz", "roofline ledger: per-program FLOPs/bytes, measured "
               "dispatch quantiles, MFU, verdicts",
     "PADDLE_PERF_PROGRAM"),
    ("/tracez", "per-request serving trace spools from every live "
                "engine", "PADDLE_TRACE_SERVE"),
    ("/profilez", "on-demand capture window (?duration_ms=N, "
                  "?profiler=0 for flight-only; the profiler window "
                  "answers 501 until profiler/ is ported); returns "
                  "the bundle", "always"),
    ("/alertz", "alert engine state: spec, cadence, every rule with "
                "its live pending/firing/resolved state + last value",
     "PADDLE_ALERTS"),
)

PROFILEZ_SCHEMA = "paddle_tpu.profilez/1"

# duration clamp for /profilez — an unbounded duration would park a
# handler thread (and the profiler lock) for hours on one typo'd curl
_PROFILEZ_MAX_MS = 60_000


def _env_port():
    """PADDLE_MONITOR_SERVE — unset/empty/off/false/no means DISARMED
    (no thread, no socket); otherwise the port to bind. Unlike the
    boolean PADDLE_* knobs, `0` here is NOT falsy: it arms an
    EPHEMERAL port (the OS picks; /statusz and the monitor_serve
    flight event record which) — the only way a test fleet on one
    host avoids port races. Returns None when disarmed, the int port
    when armed."""
    v = os.environ.get("PADDLE_MONITOR_SERVE", "").strip()
    if not v or v.lower() in ("false", "off", "no"):
        return None
    try:
        return int(v)
    except ValueError:
        return None


def _env_host():
    """PADDLE_MONITOR_SERVE_HOST — bind address (default 0.0.0.0 so
    fleet-wide `monitor scrape` reaches the rank; set 127.0.0.1 to
    keep the debug pages loopback-only)."""
    return os.environ.get("PADDLE_MONITOR_SERVE_HOST") or "0.0.0.0"


def _in_trace():
    """True while torch.compile traces — serve() must never arm there
    (a server per trace would be a trace-time side effect). The port's
    own paths compile nothing; a user's compiled region might."""
    try:
        import torch

        return bool(torch.compiler.is_compiling())
    except Exception:
        return False


# ---------------------------------------------------------------------------
# Trace sources (/tracez)
# ---------------------------------------------------------------------------

# weak refs to live engines' export_traces bound methods — an engine
# registers at construction and simply falls out when collected; no
# unregister ceremony on the serving hot path
_trace_sources: list = []
_trace_lock = _sanitize.lock("monitor.server.traces")


def add_trace_source(method):
    """Register a bound `export_traces`-style method (weakly) whose
    spool /tracez should include. Idempotent per live object."""
    ref = weakref.WeakMethod(method)
    with _trace_lock:
        live = []
        for r in _trace_sources:
            m = r()
            if m is None:
                continue
            if m.__self__ is method.__self__:
                return  # already registered
            live.append(r)
        live.append(ref)
        _trace_sources[:] = live


def trace_spools():
    """Spools from every still-live registered source; a source that
    raises contributes an error entry instead of killing the page."""
    with _trace_lock:
        refs = list(_trace_sources)
    out = []
    for r in refs:
        m = r()
        if m is None:
            continue
        try:
            out.append(m())
        except Exception as e:
            out.append({"error": f"{type(e).__name__}: {e}",
                        "source": repr(m.__self__)})
    return out


# ---------------------------------------------------------------------------
# Payload builders (shared by the handler and tests)
# ---------------------------------------------------------------------------

def _statusz(server=None):
    import torch

    return {
        "ok": True,
        "version": f"paddle_tpu_torch (torch {torch.__version__})",
        "schema_flight": _flight.DUMP_SCHEMA,
        "ts": round(time.time(), 3),
        "rank": _flight._rank(),
        "world_size": _flight._world_size(),
        "pid": os.getpid(),
        "host": __import__("socket").gethostname(),
        "uptime_s": (None if server is None
                     else round(time.monotonic() - server._t0, 3)),
        # evidence-gathering rule: never initialize CUDA from the
        # handler thread (the device section reads the card only once
        # the process did)
        "device": _flight._device_info(),
        "env": _flight._env_info(),
        "server": describe(server),
    }


def flight_chrome(events, pid=None):
    """Chrome-trace doc over flight-ring events: `*_end` events (they
    carry dur_us) become ph "X" spans ending at their record time,
    everything else an instant — the quick Perfetto look at a live
    rank without a full profiler capture."""
    pid = os.getpid() if pid is None else pid
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"rank{_flight._rank()} flight"}}]
    for ev in events:
        ts_us = float(ev.get("ts", 0.0)) * 1e6
        kind = str(ev.get("kind", "?"))
        args = {k: v for k, v in ev.items()
                if k not in ("ts", "tid", "kind") and v is not None}
        dur = ev.get("dur_us")
        if kind.endswith("_end") and dur:
            out.append({"ph": "X", "name": kind[:-4],
                        "ts": ts_us - float(dur), "dur": float(dur),
                        "pid": pid, "tid": ev.get("tid", 0),
                        "args": args})
        else:
            out.append({"ph": "i", "s": "t", "name": kind,
                        "ts": ts_us, "pid": pid,
                        "tid": ev.get("tid", 0), "args": args})
    return {"traceEvents": out,
            "metadata": {"source": "paddle_tpu.flightz"}}


def _memz():
    from . import memory as _memory

    return _memory.memory_report()


def _perfz():
    from . import perf as _perf

    return _perf.perf_report()


_profilez_lock = _sanitize.lock("monitor.server.profilez")


def _profilez(duration_ms):
    """One on-demand flight-only capture window: sleep `duration_ms`
    recording the flight ring, return the JSON bundle. Serialized —
    one window at a time."""
    duration_ms = max(1, min(int(duration_ms), _PROFILEZ_MAX_MS))
    if not _profilez_lock.acquire(blocking=False):
        return None  # caller turns this into a 409
    try:
        t0 = time.time()
        bundle = {"schema": PROFILEZ_SCHEMA,
                  "rank": _flight._rank(),
                  "pid": os.getpid(),
                  "ts": round(t0, 3),
                  "duration_ms": duration_ms,
                  "chrome_trace": None, "profiler_error": None}
        _flight.record("profilez_begin", duration_ms=duration_ms)
        time.sleep(duration_ms / 1e3)
        # the window's flight segment: everything stamped since t0
        # (epsilon for same-tick events), profilez_begin included
        bundle["flight"] = [
            ev for ev in _flight.recorder.tail()
            if ev.get("ts", 0.0) >= t0 - 1e-6]
        _flight.record("profilez_end",
                       events=len(bundle["flight"]))
        from . import telemetry_snapshot

        bundle["telemetry"] = telemetry_snapshot()
        _cmon.stat_add("monitor/serve/profilez", 1)
        return bundle
    finally:
        _profilez_lock.release()


# ---------------------------------------------------------------------------
# The HTTP server
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # the handler is stateless; the DebugServer rides on the server
    # object (self.server.debug)
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # a scrape per rank per 15s would
        pass                    # otherwise flood every rank's stderr

    def _send(self, code, body, ctype="application/json"):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-reply — not our problem

    def _send_json(self, doc, code=200):
        self._send(code, json.dumps(doc, default=str) + "\n")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            self._route()
        except Exception as e:
            # one bad page must not kill the scrape target
            _cmon.stat_add("monitor/serve/errors", 1)
            try:
                self._send_json(
                    {"error": f"{type(e).__name__}: {e}"}, code=500)
            except Exception:
                pass

    def _route(self):
        u = urlparse(self.path)
        q = {k: v[-1] for k, v in parse_qs(u.query).items()}
        path = u.path.rstrip("/") or "/"
        _cmon.stat_add("monitor/serve/requests", 1)
        if path == "/healthz":
            self._send(200, "ok\n", ctype="text/plain; charset=utf-8")
        elif path == "/metrics":
            from . import prometheus_text, telemetry_snapshot

            fn = getattr(self.server.debug, "snapshot_fn", None)
            snap = fn() if fn is not None else telemetry_snapshot()
            if q.get("format") == "json":
                self._send_json(snap)
            else:
                self._send(
                    200, prometheus_text(snap),
                    ctype="text/plain; version=0.0.4; charset=utf-8")
        elif path == "/statusz":
            self._send_json(_statusz(self.server.debug))
        elif path == "/flightz":
            try:
                n = int(q.get("n", 256))
            except ValueError:
                n = 256
            events = _flight.recorder.tail(n)
            if q.get("format") == "chrome":
                self._send_json(flight_chrome(events))
            else:
                self._send_json({"rank": _flight._rank(),
                                 "events": events,
                                 "ring": _flight.recorder.stats()})
        elif path == "/memz":
            self._send_json(_memz())
        elif path == "/perfz":
            self._send_json(_perfz())
        elif path == "/tracez":
            self._send_json({"rank": _flight._rank(),
                             "spools": trace_spools()})
        elif path == "/profilez":
            try:
                dur = int(q.get("duration_ms", 500))
            except ValueError:
                dur = 500
            if q.get("profiler", "1") not in ("0", "false", "off", "no"):
                self._send_json(
                    {"error": "the profiler window is not ported "
                              "(ROADMAP queue 1 item 4, Waits: "
                              "profiler/); ?profiler=0 captures the "
                              "flight-only window"}, code=501)
                return
            bundle = _profilez(dur)
            if bundle is None:
                self._send_json(
                    {"error": "another capture window is running"},
                    code=409)
            else:
                self._send_json(bundle)
        elif path == "/alertz":
            # lazy import (alerts imports this module's sibling
            # surfaces); force the flight-ring stat sync first so a
            # scrape sees the same registry truth the evaluator does
            from . import alerts as _alerts
            _flight.sync_stats()
            doc = dict(_alerts.describe())
            doc["rank"] = _flight._rank()
            self._send_json(doc)
        elif path == "/":
            index = {p: desc for p, desc, _ in ROUTES}
            self._send_json({"paddle_tpu": True, "routes": index})
        else:
            self._send_json({"error": f"no such page {path!r}",
                             "routes": [p for p, _, _ in ROUTES]},
                            code=404)


class DebugServer:
    """One ThreadingHTTPServer on a named daemon thread. start() binds
    (raising OSError on a taken port — callers decide whether that is
    fatal), shutdown() is idempotent and never raises."""

    def __init__(self, port=0, host=None, snapshot_fn=None):
        self._requested_port = int(port)
        self.host = _env_host() if host is None else str(host)
        # /metrics source override — the process-wide server reads the
        # global telemetry_snapshot(); embedders (and the scrape
        # byte-compat tests, which run N "ranks" in one process) can
        # serve a per-instance snapshot instead
        self.snapshot_fn = snapshot_fn
        self._httpd = None
        self._thread = None
        self._t0 = time.monotonic()
        self._lock = _sanitize.lock("monitor.server.lifecycle")

    @property
    def port(self):
        h = self._httpd
        return h.server_address[1] if h is not None \
            else self._requested_port

    @property
    def url(self):
        host = self.host if self.host not in ("", "0.0.0.0") \
            else "127.0.0.1"
        return f"http://{host}:{self.port}"

    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def start(self):
        with self._lock:
            if self.running():
                return self
            httpd = ThreadingHTTPServer(
                (self.host, self._requested_port), _Handler)
            httpd.daemon_threads = True
            httpd.debug = self
            self._httpd = httpd
            self._t0 = time.monotonic()
            t = threading.Thread(
                target=httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="paddle-monitor-serve", daemon=True)
            self._thread = t
            t.start()
        _cmon.stat_set("monitor/serve/port", self.port)
        _flight.record("monitor_serve", port=self.port,
                       host=self.host)
        return self

    def shutdown(self, timeout=5.0):
        """Idempotent, exception-free teardown — safe from atexit,
        tests, and the crash path (a dying run's excepthook must
        still get its dump bundle out; a raising shutdown here would
        mask the original exception)."""
        try:
            with self._lock:
                httpd, self._httpd = self._httpd, None
                thread, self._thread = self._thread, None
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            if thread is not None and thread.is_alive():
                thread.join(timeout=timeout)
        except Exception:
            _cmon.stat_add("monitor/serve/errors", 1)


# ---------------------------------------------------------------------------
# Process-wide lifecycle
# ---------------------------------------------------------------------------

_server = None
_server_lock = _sanitize.lock("monitor.server")
_arm_error_logged = False
_atexit_registered = False


def get_server():
    return _server


def describe(server=None):
    """JSON-ready summary of the (given or process-wide) server —
    embedded in /statusz and in flight dump bundles, so post-mortems
    name the port that was armed."""
    s = _server if server is None else server
    if s is None:
        return {"running": False}
    return {"running": s.running(), "port": s.port, "host": s.host,
            "routes": [p for p, _, _ in ROUTES]}


def serve(port=0, host=None):
    """Start (or return) the process-wide debug server. Raises
    OSError when the requested port cannot bind — explicit callers
    should hear about a taken port; the env-armed path
    (maybe_auto_serve) downgrades that to a counter + one VLOG."""
    global _server, _atexit_registered
    with _server_lock:
        if _server is not None and _server.running():
            return _server
        srv = DebugServer(port=port, host=host).start()
        _server = srv
        if not _atexit_registered:
            # clean socket close on interpreter exit; stop_server is
            # idempotent and exception-free, so this is safe beside
            # the flight excepthook's crash-dump path
            _atexit_registered = True
            import atexit

            atexit.register(stop_server)
        return srv


def stop_server():
    """Idempotent process-wide teardown."""
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.shutdown()
    _cmon.stat_set("monitor/serve/port", 0)


def maybe_auto_serve(where=""):
    """Env-gated serve() called from hapi.Model.fit and the serving
    Router: arms only when PADDLE_MONITOR_SERVE names a port, never
    while torch.compile traces, never twice, and never raises — a taken
    port on a debug surface must not kill the training run it is
    observing (counted under monitor/serve/errors, VLOGged once)."""
    global _arm_error_logged
    port = _env_port()
    if port is None:
        return None
    if _server is not None and _server.running():
        return _server
    if _in_trace():
        # arming under a trace would tie the server's lifetime to the
        # trace count — refuse; the next eager call site arms it
        _cmon.stat_add("monitor/serve/trace_skips", 1)
        return None
    try:
        srv = serve(port=port)
    except OSError as e:
        _cmon.stat_add("monitor/serve/errors", 1)
        if not _arm_error_logged:
            _arm_error_logged = True
            try:
                _cmon.VLOG(0, f"monitor.server: could not bind port "
                              f"{port} at {where or '?'} ({e}); "
                              "live introspection disabled")
            except Exception:
                pass
        return None
    _flight.record("auto_serve", where=where, port=srv.port)
    return srv
