"""paddle_tpu_torch.monitor — the runtime telemetry hub, the port of
`paddle_tpu/monitor/__init__.py`.

  * process-wide counters (core.monitor: stat_add / stat_set /
    registry / histograms), populated by the instrumented layers:
    `jit/...`, `comm/...`, `io/...`, `ckpt/...`, `serve/...`,
    `step/...` (StepTimer), `mem/...` (memory), `perf/...` (perf),
    `chaos/...`, `sanitize/...`, `analysis/...`, `numerics/...`.

  * StepTimer — per-step training metrics: step time and its
    histogram, throughput, loss, lr, device-memory gauges and the
    `step/attrib/{device,comm,io,host}_us` decomposition, written under
    `step/...` (hapi's Telemetry callback drives it from Model.fit).

  * prometheus_text / MetricsExporter — ONE exposition renderer for
    the debug server's /metrics and the exporter's `.prom` textfile;
    the exporter flushes periodic JSON lines or a textfile, env-armed
    by PADDLE_MONITOR_EXPORT_PATH / _INTERVAL / _FORMAT.

  * the planes (submodules): flight (ring, watchdog, dump bundles,
    excepthooks, SIGUSR1), memory (device stats, census, OOM
    forensics), perf (cost ledger, roofline), chaos (seeded fault
    injection), sanitize (runtime sanitizer), numerics (the probe),
    server (the debug server), trace (per-request serving traces) and
    alerts (SLO rules).

Not ported (ROADMAP queue 1 item 4, Waits): `fleet_snapshot` and the
`fleet` module (they need the store collective the port lacks), the
`python -m paddle_tpu.monitor` CLI, and `profiler/`.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time

from ..core.monitor import (  # noqa: F401 — the counter surface
    StatValue, StatRegistry, Histogram, registry, stat_add, stat_get,
    stat_set, stat_reset, hist_observe, hist_get, snapshot_quantile,
    VLOG, vlog_level,
)
from . import flight  # noqa: E402 — the failure-forensics leg
from . import memory  # noqa: E402 — the device-memory leg
from . import perf  # noqa: E402 — the compute/roofline leg
from . import chaos  # noqa: E402 — deterministic fault injection
from . import sanitize  # noqa: E402 — runtime sanitizer core
from . import numerics  # noqa: E402 — the numerics probe
from . import trace  # noqa: E402 — per-request serving traces
from . import server  # noqa: E402 — live introspection plane
from . import alerts  # noqa: E402 — SLO alert rules + burn rate
from .server import (  # noqa: F401 — the pull-side lifecycle surface
    serve, get_server, stop_server, maybe_auto_serve,
)

__all__ = [
    "StatValue", "StatRegistry", "Histogram", "registry", "stat_add",
    "stat_get", "stat_set", "stat_reset", "hist_observe", "hist_get",
    "snapshot_quantile", "VLOG", "vlog_level", "device_memory_stats",
    "device_memory_in_use", "StepTimer",
    "MetricsExporter", "start_exporter", "stop_exporter",
    "get_exporter", "telemetry_snapshot", "prometheus_text", "serve",
    "get_server", "stop_server", "maybe_auto_serve", "flight",
    "memory", "perf", "chaos", "sanitize", "numerics", "trace",
    "server", "alerts",
]

# the JAX package's monitor names the port does not have yet
WAITING = {
    "fleet_snapshot": "ROADMAP queue 1 item 4 (Waits: monitor/fleet.py "
                      "and fleet_snapshot)",
    "fleet": "ROADMAP queue 1 item 4 (Waits: monitor/fleet.py and "
             "fleet_snapshot)",
}


def device_memory_stats(device=None):
    """The device's memory stat dict (the JAX package reads PJRT's;
    here the caching allocator's, monitor.memory.memory_stats)."""
    return memory.memory_stats(device)


def device_memory_in_use(device=None):
    """(bytes_in_use, peak_bytes_in_use) of the device."""
    stats = memory.memory_stats(device)
    return stats["allocated_bytes"], stats["peak_bytes"]


def telemetry_snapshot():
    """Timestamped copy of the full StatRegistry — the record the
    exporter flushes, /metrics renders and dump bundles embed. Syncs
    the flight ring's amortized counters and the device-memory gauges
    (mem/{allocated,peak}_bytes) first so both are exact in every
    flush/dump."""
    flight.sync_stats()
    try:
        memory.sync_gauges()
    except Exception:
        pass
    return {"ts": round(time.time(), 3), "rank": _rank(),
            "stats": registry.snapshot(),
            # histogram summaries travel BESIDE the flat int stats:
            # sparse bucket maps + exact sum/count/min/max
            "hists": registry.snapshot_histograms()}


# ONE copy of the launch-env rank parsing, shared with the dump bundles
_rank = flight._rank


class StepTimer:
    """Per-step training metrics hub.

    Usage (hapi.callbacks.Telemetry drives this from Model.fit):

        st = StepTimer()
        st.begin_step()
        ...one train step...
        st.end_step(batch_size=bs, loss=l, lr=lr)

    Every end_step updates the `step/...` registry stats. The JAX
    package also mirrors them as profiler counter samples; `profiler/`
    is not ported (ROADMAP queue 1 item 4, Waits). `clock` (default
    time.perf_counter) is the step clock, injectable for tests."""

    # flight-ring event kind -> step-attribution wall: the spans/events
    # the instrumented layers already leave per step, bucketed into
    # where the wall time went. Whatever the ring doesn't explain is
    # host time (Python, optimizer host math) — the remainder bucket
    _ATTRIB_KINDS = {
        "dispatch_end": "device", "serve_decode_end": "device",
        "serve_prefill_end": "device", "linalg_end": "device",
        "collective_end": "comm",
        "io_fetch": "io", "io_h2d": "io", "ckpt_write_end": "io",
    }

    def __init__(self, window=100, *, clock=None):
        self._clock = clock or time.perf_counter
        self._t0 = None
        self._wall0 = None   # wall-clock twin of _t0 (ring ts domain)
        self._window = int(window)
        self._times = []     # recent step durations (seconds)
        self._last = {}
        self._mem_prev = None  # allocated bytes at last step boundary

    def begin_step(self):
        self._t0 = self._clock()
        self._wall0 = time.time()
        flight.record("step_begin")

    def end_step(self, batch_size=None, loss=None, lr=None):
        now = self._clock()
        if self._t0 is None:
            return None
        dt = now - self._t0
        self._t0 = None
        self._times.append(dt)
        if len(self._times) > self._window:
            del self._times[:len(self._times) - self._window]

        stat_add("step/count", 1)
        stat_add("step/total_time_us", int(dt * 1e6))
        stat_set("step/last_time_us", int(dt * 1e6))
        # the step-time DISTRIBUTION: the int gauges above only carry
        # last/total
        hist_observe("step/hist/time_us", dt * 1e6)
        throughput = None
        if batch_size:
            stat_add("step/samples", int(batch_size))
            throughput = batch_size / dt if dt > 0 else 0.0
            # gauge kept float: int() would truncate big-model runs
            # under 1 sample/s to a stalled-looking 0
            stat_set("step/throughput", round(throughput, 3))
        if loss is not None and math.isfinite(float(loss)):
            # micro-units: the registry holds ints. A non-finite loss
            # (diverged run, tripped guard) keeps the last finite
            # gauge — int(nan) raises, and the telemetry callback
            # must not kill the fit before terminate_on_nan sees it
            stat_set("step/last_loss_e6", int(float(loss) * 1e6))
        if lr is not None and math.isfinite(float(lr)):
            stat_set("step/lr_e9", int(float(lr) * 1e9))
        # step-boundary memory tracking (PADDLE_MEM_STEP=0 disables —
        # on the CPU each reading is a live-tensor census walk):
        # allocated/peak gauges under step/mem/* and the signed
        # per-step delta
        used, peak = memory.step_reading()
        if used or peak:
            stat_set("step/mem/allocated_bytes", used)
            registry.get("step/mem/peak_bytes").maximum(peak)
            if self._mem_prev is not None:
                stat_set("step/mem/delta_bytes", used - self._mem_prev)
            self._mem_prev = used
            # legacy names (pre-memory-module consumers)
            stat_set("step/device_mem_bytes_in_use", used)
            registry.get("step/device_mem_peak_bytes").maximum(peak)

        # step-time decomposition (PADDLE_PERF_STEP=0 disables):
        # bucket the flight ring's spans that closed
        # inside this step into device/comm/io walls; the
        # unexplained remainder is host time. Clamped — overlapped
        # walls (a feeder thread's h2d under a device dispatch) can
        # sum past the step, and a decomposition that exceeds 100%
        # reads as nonsense
        if perf.step_attrib_enabled() and self._wall0 is not None:
            attrib = self._step_attrib(int(dt * 1e6))
            if attrib is not None:
                for wall, us in attrib.items():
                    stat_set(f"step/attrib/{wall}_us", us)

        self._last = {"time_s": dt, "batch_size": batch_size,
                      "loss": loss, "lr": lr}
        flight.record("step_end", us=int(dt * 1e6),
                      batch_size=batch_size,
                      loss=None if loss is None else float(loss))
        return dt

    def _step_attrib(self, dt_us):
        """{device, comm, io, host} µs for the step that just ended,
        from the ring events stamped since begin_step. Best effort:
        a cleared/disabled ring yields None (no gauges written — a
        zeroed decomposition would read as an all-host step)."""
        buckets = {"device": 0, "comm": 0, "io": 0}
        saw = False
        try:
            for ev in flight.recorder.tail(512):
                if ev.get("ts", 0.0) < self._wall0:
                    continue
                saw = True
                wall = self._ATTRIB_KINDS.get(ev.get("kind"))
                if wall is None:
                    continue
                buckets[wall] += int(ev.get("dur_us")
                                     or ev.get("us") or 0)
        except Exception:
            return None
        if not saw:
            # not even our own step_begin event → ring off/cleared
            return None
        known = sum(buckets.values())
        if dt_us > 0 and known > dt_us:
            scale = dt_us / known
            for wall in buckets:
                buckets[wall] = int(buckets[wall] * scale)
            buckets["host"] = 0
        else:
            buckets["host"] = max(0, dt_us - known)
        return buckets

    def summary(self):
        n = len(self._times)
        avg = sum(self._times) / n if n else 0.0
        out = {"steps_windowed": n, "avg_step_ms": avg * 1e3}
        bs = self._last.get("batch_size")
        if bs and avg > 0:
            out["avg_throughput"] = bs / avg
        out.update({k: v for k, v in self._last.items()
                    if v is not None})
        return out


# ---------------------------------------------------------------------------
# Prometheus exposition (ONE renderer: exporter textfile + /metrics)
# ---------------------------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")

# the series suffixes a Prometheus histogram family OWNS — a scalar
# whose sanitized name lands on `<hist>_bucket`/`_sum`/`_count` would
# alias the histogram's own series just as hard as a same-name scalar
_PROM_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _prom_name(name):
    return "paddle_tpu_" + _PROM_BAD.sub("_", name)


def _prom_escape(v):
    """Prometheus label-value escaping (backslash, double quote,
    newline — the exposition-format contract). ONE escaper for every
    label either leg of the renderer emits, so user-supplied names
    riding a label can never produce an unparsable or aliasing
    line."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_value(v):
    """One sample value, Prometheus-spelled: bools as 0/1, non-finite
    floats as NaN/+Inf/-Inf (valid exposition tokens — `nan`/`inf`
    Python spellings are not), everything else as-is."""
    import math

    if isinstance(v, bool):
        return "1" if v else "0"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(v)


def _prom_resolve(stat_names, hist_names):
    """Final metric base name for every input, computed over the
    UNION of both families. The `_` substitution is lossy
    (`step/time` and `step_time` both sanitize to
    `paddle_tpu_step_time`), so when several names land on one metric
    name EVERY collider gets a suffix derived (sha1) from its
    ORIGINAL name — no two stats, no stat-vs-histogram pair, and no
    stat-vs-`_bucket`/`_sum`/`_count` pair ever alias one Prometheus
    series. The suffix itself is a pure function of the name; WHETHER
    a name needs one depends on the name set in the snapshot, which
    only grows within a process (stat_reset zeroes, never removes)
    and is identical across ranks running the same code — so series
    names stay stable except at the moment a brand-new collider first
    registers. Returns {("stat"|"hist", original_name): metric}."""
    import hashlib

    keys = [("stat", k) for k in stat_names] \
        + [("hist", k) for k in hist_names]
    sanitized = {key: _prom_name(key[1]) for key in keys}
    counts = {}
    for m in sanitized.values():
        counts[m] = counts.get(m, 0) + 1
    hist_series = {sanitized[key] + suf for key in keys
                   if key[0] == "hist"
                   for suf in _PROM_HIST_SUFFIXES}
    out = {}
    for key in keys:
        m = sanitized[key]
        if counts[m] > 1 or (key[0] == "stat" and m in hist_series):
            m = f"{m}_{hashlib.sha1(key[1].encode()).hexdigest()[:6]}"
        out[key] = m
    return out


def _prom_render(items, hists):
    """The full exposition: scalar lines for (name, value) pairs plus
    classic histogram families — `<name>_bucket{le=...}` cumulative
    series with `_sum`/`_count`, one `le` per OCCUPIED bucket's upper
    edge (sparse inputs stay sparse on the wire; cumulative semantics
    make skipped empty buckets exactly equivalent) and the mandatory
    `+Inf` terminal. Overflow observations only appear in `+Inf`, as
    they exceed every finite boundary. ONE renderer — the
    MetricsExporter `.prom` textfile and the debug server's /metrics
    page both call this, so the two surfaces can never disagree on a
    series name."""
    names = _prom_resolve([k for k, _ in items], hists)
    lines = []
    for k, v in items:
        lines.append(f"{names[('stat', k)]} {_prom_value(v)}")
    for name in sorted(hists):
        s = hists[name]
        m = names[("hist", name)]
        lo = float(s["lo"])
        pd = int(s["per_decade"])
        nb = pd * int(s["decades"])
        buckets = sorted((int(k), int(v))
                         for k, v in (s.get("buckets") or {}).items())
        cum = 0
        for idx, c in buckets:
            cum += c
            if idx > nb:
                continue  # overflow folds into +Inf below
            le = lo * 10.0 ** (idx / pd) if idx else lo
            lines.append(
                f'{m}_bucket{{le="{_prom_escape(f"{le:.6g}")}"}} '
                f'{cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {int(s["count"])}')
        lines.append(f'{m}_sum {float(s["sum"]):.6g}')
        lines.append(f'{m}_count {int(s["count"])}')
    return lines


def prometheus_text(snap=None):
    """Prometheus exposition text for a telemetry snapshot (the live
    one when None) — the single formatter behind both pull
    (`/metrics` on the debug server) and push (the exporter's `.prom`
    textfile). Series names keep the JAX package's `paddle_tpu_`
    prefix, so a scrape reads the same from either package."""
    if snap is None:
        snap = telemetry_snapshot()
    items = sorted((snap.get("stats") or {}).items())
    items.append(("export_timestamp_seconds", snap.get("ts", 0)))
    lines = _prom_render(items, snap.get("hists") or {})
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Metrics exporter
# ---------------------------------------------------------------------------


class MetricsExporter:
    """Periodic flush of the StatRegistry snapshot to a file.

    fmt="jsonl" (default): append one JSON line per flush —
        {"ts": ..., "rank": ..., "stats": {...}}
    fmt="prom": atomically rewrite a Prometheus textfile (the
        node-exporter textfile-collector contract: write tmp, rename).

    A `{rank}` placeholder in the path expands to the trainer rank so
    multi-process runs don't clobber one file — resolved at FLUSH
    time, not construction (the env autostart runs at import, before
    a process group exists). The background thread is a daemon;
    stop() joins it and performs one final flush."""

    def __init__(self, path, interval=30.0, fmt=None):
        self._path_template = str(path)
        self.interval = float(interval)
        if fmt is None:
            fmt = "prom" if self._path_template.endswith(".prom") \
                else "jsonl"
        if fmt not in ("jsonl", "prom"):
            raise ValueError(
                f"MetricsExporter: unknown format {fmt!r} "
                "(expected 'jsonl' or 'prom')")
        self.fmt = fmt
        self._stop = threading.Event()
        self._thread = None
        self._errors_seen = set()

    @property
    def path(self):
        return self._path_template.replace("{rank}", str(_rank()))

    def flush(self):
        snap = telemetry_snapshot()
        path = self.path  # one {rank} resolution per flush
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self.fmt == "jsonl":
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        else:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(prometheus_text(snap))
            os.replace(tmp, path)
        return snap

    def _note_flush_error(self, exc):
        """Background-flush failure accounting: an unwritable path on
        a week-long run must be VISIBLE, not a bare `pass` — count
        every failure under monitor/export/errors (the exporter may
        recover and flush it later) and
        VLOG each DISTINCT error once so the log isn't flooded at
        every interval."""
        stat_add("monitor/export/errors", 1)
        key = f"{type(exc).__name__}: {exc}"
        if key not in self._errors_seen:
            self._errors_seen.add(key)
            try:
                VLOG(0, f"MetricsExporter: flush to {self.path} "
                        f"failed ({key}); will keep retrying")
            except Exception:
                # a broken stderr raising INSIDE the error handler
                # would kill the exporter thread — the exact silent
                # death this method exists to prevent
                pass

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.flush()
            except Exception as e:
                # an unwritable path OR an unserializable stat value
                # must not silently kill the exporter thread for the
                # rest of a long run — keep trying; direct flush()
                # callers still see the raise
                self._note_flush_error(e)

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-metrics-exporter",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, flush=True):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if flush:
            try:
                self.flush()
            except Exception as e:
                self._note_flush_error(e)


_exporter = None
_exporter_lock = sanitize.lock("monitor.exporter")


def get_exporter():
    return _exporter


def start_exporter(path=None, interval=None, fmt=None):
    """Start (or return) the process-wide exporter. With no arguments
    the env contract applies: PADDLE_MONITOR_EXPORT_PATH (required —
    returns None when unset), PADDLE_MONITOR_EXPORT_INTERVAL (seconds,
    default 30), PADDLE_MONITOR_EXPORT_FORMAT (jsonl|prom, default by
    extension)."""
    global _exporter
    path = path or os.environ.get("PADDLE_MONITOR_EXPORT_PATH")
    if not path:
        return None
    if interval is None:
        try:
            interval = float(os.environ.get(
                "PADDLE_MONITOR_EXPORT_INTERVAL", "30"))
        except ValueError:
            interval = 30.0
    fmt = fmt or os.environ.get("PADDLE_MONITOR_EXPORT_FORMAT") or None
    with _exporter_lock:
        # construct (and so validate fmt/path) BEFORE stopping the
        # running exporter — a typo'd format must not kill the live
        # metrics trail and leave a dead object registered
        new = MetricsExporter(path, interval, fmt)
        if _exporter is not None:
            _exporter.stop(flush=False)
        _exporter = new.start()
        return _exporter


def stop_exporter(flush=True):
    global _exporter
    with _exporter_lock:
        e, _exporter = _exporter, None
    if e is not None:
        e.stop(flush=flush)


# env-driven autostart: setting PADDLE_MONITOR_EXPORT_PATH is enough
# for any run importing paddle_tpu_torch to leave a metrics trail
if os.environ.get("PADDLE_MONITOR_EXPORT_PATH"):
    try:
        start_exporter()
    except Exception:
        pass
