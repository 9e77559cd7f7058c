"""paddle_tpu_torch.monitor.flight — black-box flight recorder and
hang / crash forensics, the port of `paddle_tpu/monitor/flight.py`.

Four pieces, as in the JAX package:

  * FlightRecorder — a process-wide bounded ring of structured events
    (step begin/end, dispatches, collectives, checkpoint writes, chaos
    injections, dumps). Appending is one lock + deque append; the ring
    drops the oldest event when full (flight/ring/dropped).

  * in-flight registry + Watchdog — begin()/end() (or in_flight())
    mark a thread inside a potentially-blocking operation (a
    collective, a serving dispatch, a checkpoint write). The watchdog
    thread scans the registry and, once an entry exceeds
    PADDLE_WATCHDOG_TIMEOUT_S, writes a dump bundle and runs the
    incident hooks (the serving engines' emergency export, the
    checkpoint manager's emergency save).

  * dump bundles — write_dump() produces one JSON file per incident
    (schema "paddle_tpu.flight/1", the JAX package's, so either
    package's reader takes either's bundle): reason, identity, env,
    device (torch.cuda: name, capability, memory), in-flight ops,
    per-thread stacks, the flight tail, telemetry, the program ledger
    (`jit.cache_report()`), memory, sanitize, numerics, server and
    alerts sections. install_excepthook() writes one on any unhandled
    exception (main or worker thread); dump_on_crash() is the
    context-manager flavor; install_signal_handler wires SIGUSR1 for
    live dumps. read_dump() loads a bundle back.

  * arming — arm() switches everything on; maybe_auto_arm() is called
    from hapi.Model.fit and distributed.init_parallel_env and arms by
    default for distributed runs (PADDLE_TRAINERS_NUM > 1), gated by
    PADDLE_FLIGHT_AUTOARM=0/1.

Counters: flight/events, flight/ring/dropped, flight/watchdog/fires,
flight/dumps_written, flight/watchdog/errors,
flight/incident_hook/errors.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from collections import deque

from ..core import monitor as _cmon
from . import sanitize as _sanitize

__all__ = [
    "DUMP_SCHEMA", "FlightRecorder", "recorder", "record", "tail",
    "sync_stats", "begin", "end", "in_flight", "inflight_snapshot",
    "Watchdog",
    "start_watchdog", "stop_watchdog", "get_watchdog", "write_dump",
    "read_dump", "dump_dir", "install_excepthook",
    "uninstall_excepthook", "dump_on_crash", "install_signal_handler",
    "uninstall_signal_handler", "arm", "maybe_auto_arm",
    "add_incident_hook", "remove_incident_hook", "Incident",
]

DUMP_SCHEMA = "paddle_tpu.flight/1"


# the env-knob parsers every monitor-side consumer (chaos, trace,
# alerts, serving) reaches as flight._env_*
_env_int = _cmon._env_int
_env_float = _cmon._env_float
_env_on = _cmon._env_on


_FALSY = ("0", "false", "off", "no")


def _rank():
    """This process's rank: the launch env's PADDLE_TRAINER_ID, else an
    initialized torch.distributed group's, else 0. Never initializes a
    process group and never raises."""
    try:
        return int(os.environ["PADDLE_TRAINER_ID"])
    except (KeyError, ValueError):
        pass
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def _world_size():
    """The launch env's PADDLE_TRAINERS_NUM, else an initialized
    torch.distributed group's size, else 1."""
    try:
        return int(os.environ["PADDLE_TRAINERS_NUM"])
    except (KeyError, ValueError):
        pass
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def _cuda_live():
    """True once this process initialized CUDA. Evidence gathering (a
    dump from the watchdog thread, a debug page) reads the card only
    then: it must never be what brings a CUDA context up."""
    try:
        import torch

        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:
        return False


def dump_dir():
    """Where watchdog/crash/signal bundles land: PADDLE_FLIGHT_DIR, or
    <tmp>/paddle_tpu_flight. Read per dump (not cached) so tests and
    late launcher setup can redirect it."""
    d = os.environ.get("PADDLE_FLIGHT_DIR")
    if not d:
        import tempfile

        d = os.path.join(tempfile.gettempdir(), "paddle_tpu_flight")
    return d


# ---------------------------------------------------------------------------
# Flight recorder ring
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of (ts, tid, kind, data) events.

    record() is the always-on hot path: one lock acquisition, one
    deque append, one stat bump — cheap enough to ride every jit cache
    hit and collective. PADDLE_FLIGHT_ENABLE=0 turns the whole layer
    (ring, in-flight registry, watchdog evidence) off;
    PADDLE_FLIGHT_CAPACITY sizes the ring (default 4096 events)."""

    def __init__(self, capacity=None, enabled=None):
        if capacity is None:
            capacity = _env_int("PADDLE_FLIGHT_CAPACITY", 4096)
        if enabled is None:
            enabled = _env_on("PADDLE_FLIGHT_ENABLE", True)
        self._ring = deque(maxlen=max(16, int(capacity)))
        # sanitize-aware (PADDLE_SANITIZE=locks): a plain Lock when
        # disarmed — record() is the always-on hot path
        self._lock = _sanitize.lock("flight.ring")
        self._seq = 0
        self._dropped = 0
        self.enabled = bool(enabled)

    @property
    def capacity(self):
        return self._ring.maxlen

    def record(self, kind, **data):
        if not self.enabled:
            return
        ev = (time.time(), threading.get_ident(), kind, data or None)
        with self._lock:
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(ev)
            sync = self._seq % 256 == 0
        # registry gauges amortize to every 256th event: a per-event
        # stat_add would DOUBLE the hot-path cost once the ring fills
        # (every append then drops); telemetry_snapshot() syncs too,
        # so exporter flushes and dump bundles are always fresh
        if sync:
            self.sync_stats()

    def sync_stats(self):
        """Push the ring's internal counters into the StatRegistry
        (flight/events, flight/ring/dropped)."""
        with self._lock:
            seq, dropped = self._seq, self._dropped
        _cmon.stat_set("flight/events", seq)
        _cmon.stat_set("flight/ring/dropped", dropped)

    def tail(self, n=None):
        """The newest `n` events (all when n is None, none when
        n <= 0), oldest first, as JSON-ready dicts."""
        with self._lock:
            evs = list(self._ring)
        if n is not None:
            # a plain [-n:] would invert n=0 into "everything"
            evs = evs[-int(n):] if int(n) > 0 else []
        return [dict({"ts": round(ts, 6), "tid": tid, "kind": kind},
                     **(data or {}))
                for ts, tid, kind, data in evs]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0

    def stats(self):
        with self._lock:
            return {"events": self._seq, "dropped": self._dropped,
                    "capacity": self._ring.maxlen,
                    "size": len(self._ring)}


recorder = FlightRecorder()


def record(kind, **data):
    """Append one structured event to the process-wide flight ring."""
    recorder.record(kind, **data)


def tail(n=None):
    return recorder.tail(n)


def sync_stats():
    recorder.sync_stats()


# ---------------------------------------------------------------------------
# In-flight registry (what the watchdog watches)
# ---------------------------------------------------------------------------

_inflight: dict = {}
_inflight_lock = _sanitize.lock("flight.inflight")
_token_seq = itertools.count(1)


def begin(kind, name, **data):
    """Mark this thread entering a potentially-blocking operation.
    Records a `<kind>_begin` flight event and registers the op so the
    watchdog can see it wedge. Returns a token for end(); None when
    the recorder is disabled (end(None) is a no-op)."""
    if not recorder.enabled:
        return None
    recorder.record(f"{kind}_begin", name=name, **data)
    token = next(_token_seq)
    # t0 is wall clock for display; ages/durations measure against
    # the MONOTONIC clock — an NTP step or VM suspend must not fire
    # false watchdog dumps or yield negative dur_us
    entry = dict({"kind": kind, "name": name,
                  "tid": threading.get_ident(),
                  "t0": round(time.time(), 6),
                  "_t0m": time.monotonic()}, **data)
    with _inflight_lock:
        _inflight[token] = entry
    return token


def end(token):
    """Complete the operation begin() registered: drops it from the
    in-flight table and records the `<kind>_end` event with its
    duration."""
    if token is None:
        return
    with _inflight_lock:
        entry = _inflight.pop(token, None)
    if entry is not None:
        recorder.record(
            f"{entry['kind']}_end", name=entry["name"],
            dur_us=int((time.monotonic() - entry["_t0m"]) * 1e6))


@contextlib.contextmanager
def in_flight(kind, name, **data):
    token = begin(kind, name, **data)
    try:
        yield
    finally:
        end(token)


def inflight_snapshot(now=None):
    """Current in-flight ops with their ages — what a hung rank was
    doing, straight from the registry the hooks maintain. `now` is a
    time.monotonic() reading (the age clock)."""
    now = time.monotonic() if now is None else now
    with _inflight_lock:
        entries = [dict(e) for e in _inflight.values()]
    for e in entries:
        e["age_s"] = round(now - e.pop("_t0m"), 3)
    return entries


# ---------------------------------------------------------------------------
# Dump bundles
# ---------------------------------------------------------------------------

_dump_seq = itertools.count(1)


def _thread_stacks():
    """Formatted stacks of EVERY live thread (the py-spy-style view a
    hang dump needs: the stalled collective's thread plus whoever it
    is waiting on)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append({"tid": tid, "name": names.get(tid, "?"),
                    "stack": traceback.format_stack(frame)})
    return out


def _env_info():
    pfx = ("PADDLE_", "FLAGS_", "CUDA_", "NCCL_", "TORCH_", "GLOG_")
    return {k: os.environ[k] for k in sorted(os.environ)
            if k.startswith(pfx)}


def _device_info():
    """The card this process drives (torch.cuda), or the CPU when CUDA
    is absent or not yet initialized."""
    if not _cuda_live():
        return {"backend": "cpu", "cuda_initialized": False}
    try:
        import torch

        i = torch.cuda.current_device()
        props = torch.cuda.get_device_properties(i)
        return {"backend": "cuda", "device": i,
                "name": torch.cuda.get_device_name(i),
                "capability": list(torch.cuda.get_device_capability(i)),
                "total_memory": int(props.total_memory),
                "device_count": torch.cuda.device_count(),
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "process_index": _rank(),
                "process_count": _world_size()}
    except Exception as e:  # the card may be unusable mid-crash
        return {"error": f"{type(e).__name__}: {e}"}


def _jit_cache_info():
    """The program ledger: jit.cache_report() over the live train
    steps."""
    try:
        from .. import jit as _jit

        return _jit.cache_report()
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _memory_section(reason, full=None, jit_report=None):
    """Memory evidence for a dump bundle: device stats + per-program
    footprints in EVERY bundle (cheap reads); the live-tensor census
    joins for OOM and operator-requested (sigusr1) dumps, where "what
    is holding the card's memory" is the question being asked —
    `full` overrides the reason-based default either way."""
    try:
        from . import memory as _memory

        if full is None:
            full = reason in ("oom", "sigusr1")
        return _memory.memory_section(census=full,
                                      jit_report=jit_report)
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _sanitize_section():
    try:
        return _sanitize.describe()
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _numerics_section():
    try:
        from . import numerics

        return numerics.describe()
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _server_section():
    """monitor.server.describe() with a total fallback — the dump
    path (which also runs from the excepthook) must survive a
    half-imported or torn-down server module."""
    try:
        from . import server as _server_mod

        return _server_mod.describe()
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _alerts_section():
    """monitor.alerts.describe() with a total fallback — a dump taken
    before the alerts module finished importing (env autostart runs
    at import time) must still write."""
    try:
        from . import alerts as _alerts_mod

        return _alerts_mod.describe()
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def write_dump(reason, extra=None, path=None, full_memory=None):
    """Write one self-contained JSON forensics bundle and return its
    path. Schema (DUMP_SCHEMA = "paddle_tpu.flight/1"):

        schema/reason/ts/rank/world_size/pid/host/argv — identity
        env          — PADDLE_/FLAGS_/CUDA_/NCCL_/TORCH_/GLOG_ vars
        device       — the card (torch.cuda) or the CPU
        in_flight    — ops currently inside begin()/end() with ages
        threads      — formatted stacks of every live thread
        flight_tail  — newest PADDLE_FLIGHT_DUMP_EVENTS ring events
        telemetry    — monitor.telemetry_snapshot() (full registry)
        jit_caches   — the program ledger (jit.cache_report())
        memory       — device stats + per-program footprints (+ the
          live-tensor census for oom/sigusr1 reasons; `full_memory`
          forces it on/off for custom reasons — oom_observer passes
          True so a renamed OOM bundle keeps its census)
        + reason-specific keys from `extra` (e.g. "exception",
          "stuck")

    The file lands in dump_dir() as
    <reason>_rank<r>_pid<p>_<n>.json (atomic tmp+rename), counted
    under flight/dumps_written, echoed at VLOG(0)."""
    ts = time.time()
    caches = _jit_cache_info()
    payload = {
        "schema": DUMP_SCHEMA,
        "reason": reason,
        "ts": round(ts, 3),
        "rank": _rank(),
        "world_size": _world_size(),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "argv": list(sys.argv),
        "env": _env_info(),
        "device": _device_info(),
        "in_flight": inflight_snapshot(),
        "threads": _thread_stacks(),
        "flight_tail": recorder.tail(
            _env_int("PADDLE_FLIGHT_DUMP_EVENTS", 256)),
        "jit_caches": caches,
        "memory": _memory_section(
            reason, full=full_memory,
            jit_report=caches if isinstance(caches, list) else None),
        # which sanitizer families were armed and what they found
        "sanitize": _sanitize_section(),
        # the numerics probe's freshest per-tensor stats
        "numerics": _numerics_section(),
        # whether a debug server was armed and on which port
        "server": _server_section(),
        # the alert rules and their states at dump time
        "alerts": _alerts_section(),
    }
    try:
        from . import telemetry_snapshot

        payload["telemetry"] = telemetry_snapshot()
    except Exception as e:
        payload["telemetry"] = {"error": f"{type(e).__name__}: {e}"}
    if extra:
        payload.update(extra)
    if path is None:
        d = dump_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"{reason}_rank{_rank()}_pid{os.getpid()}_"
               f"{next(_dump_seq)}.json")
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    os.replace(tmp, path)
    _cmon.stat_add("flight/dumps_written", 1)
    recorder.record("dump", reason=reason, path=path)
    try:
        _cmon.VLOG(0, f"flight: wrote {reason} dump -> {path}")
    except Exception:
        # broken/closed stderr must not make a dump that IS on disk
        # look failed (the watchdog would re-dump it every poll)
        pass
    return path


def read_dump(path):
    """Load one dump bundle (either package's: the schema is shared)
    and check its schema; returns the payload dict."""
    with open(path) as f:
        bundle = json.load(f)
    if bundle.get("schema") != DUMP_SCHEMA:
        raise ValueError(
            f"{path}: not a flight bundle (schema "
            f"{bundle.get('schema')!r}, expected {DUMP_SCHEMA!r})")
    return bundle


# ---------------------------------------------------------------------------
# Incident hooks (watchdog checkpoint-then-abort)
# ---------------------------------------------------------------------------

# callables fired with (reason) after an incident dump lands — the
# elastic CheckpointManager registers its emergency_save here so a
# hung collective leaves a RESUMABLE snapshot next to the bundle, and
# an armed serving engine its emergency drain-and-export
_incident_hooks: list = []


class Incident(str):
    """The `reason` a watchdog hands its incident hooks: the string
    ("watchdog") the JAX package's hooks get, carrying `stuck`, the
    fire's stuck in-flight entries (kind, name, tid, age_s, ...) as the
    bundle holds them, so a hook can tell whether the wedge is its
    own."""

    def __new__(cls, reason, stuck=()):
        self = super().__new__(cls, reason)
        self.stuck = list(stuck)
        return self


def add_incident_hook(fn):
    """Register fn(reason) to run after a watchdog incident dump
    (`reason` is an `Incident`). Hooks must be best-effort: exceptions
    are counted under flight/incident_hook/errors and never reach the
    watchdog loop."""
    if fn not in _incident_hooks:
        _incident_hooks.append(fn)
    return fn


def remove_incident_hook(fn):
    try:
        _incident_hooks.remove(fn)
    except ValueError:
        pass


def _run_incident_hooks(reason):
    for fn in list(_incident_hooks):
        try:
            fn(reason)
        except Exception:
            _cmon.stat_add("flight/incident_hook/errors", 1)


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Background thread that turns a silent hang into evidence.

    Scans the in-flight registry every `poll_s`; any op older than
    `timeout_s` (PADDLE_WATCHDOG_TIMEOUT_S, default 300 — generous
    enough to sit out a first kernel build) triggers ONE dump naming
    every newly-stuck op. Each stuck op is reported once — a wedged
    collective doesn't re-dump at every poll, but a SECOND op wedging
    later still gets its own bundle."""

    def __init__(self, timeout_s=None, poll_s=None):
        if timeout_s is None:
            timeout_s = _env_float("PADDLE_WATCHDOG_TIMEOUT_S", 300.0)
        self.timeout_s = float(timeout_s)
        if poll_s is None:
            poll_s = _env_float("PADDLE_WATCHDOG_POLL_S", 0.0) \
                or max(0.05, min(self.timeout_s / 4.0, 10.0))
        self.poll_s = float(poll_s)
        self.fired = 0
        self._reported: set = set()   # dumped successfully
        self._noted: set = set()      # ring event recorded
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-flight-watchdog",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Returns False when the thread did not exit within 5s (e.g.
        wedged inside write_dump on a hung filesystem) — it is NOT
        forgotten then (running() stays truthful); once it unblocks,
        the set stop event makes it exit without another scan."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                _cmon.stat_add("flight/watchdog/errors", 1)
                try:
                    _cmon.VLOG(0, "flight: watchdog thread did not "
                                  "stop within 5s (blocked dump?)")
                except Exception:
                    pass
                return False
        self._thread = None
        return True

    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def _loop(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                # the watchdog must NEVER take the training process
                # down — count and keep polling
                _cmon.stat_add("flight/watchdog/errors", 1)

    def check(self, now=None):
        """One scan; returns the dump path when it fired (tests call
        this directly). `now` is a time.monotonic() reading — ages
        ride the monotonic clock so wall-clock steps can't fake (or
        mask) a hang."""
        now = time.monotonic() if now is None else now
        with _inflight_lock:
            items = list(_inflight.items())
        live = {tok for tok, _ in items}
        self._reported &= live  # forget ops that completed
        self._noted &= live
        stuck = [(tok, e) for tok, e in items
                 if now - e["_t0m"] > self.timeout_s
                 and tok not in self._reported]
        if not stuck:
            return None
        detail = [dict(e, age_s=round(now - e["_t0m"], 3))
                  for _, e in stuck]
        for e in detail:
            e.pop("_t0m", None)
        # ring event once per stuck op (recorded BEFORE the dump so
        # its tail shows it) — NOT once per retry: a persistently
        # failing dump would otherwise flood the ring with watchdog
        # entries and evict the pre-hang evidence
        fresh = {tok for tok, _ in stuck} - self._noted
        if fresh:
            recorder.record("watchdog",
                            stuck=[e["name"] for _, e in stuck],
                            timeout_s=self.timeout_s)
            self._noted |= fresh
        path = write_dump(
            "watchdog",
            extra={"stuck": detail, "timeout_s": self.timeout_s})
        # mark reported only once the dump is ON DISK — a failed write
        # (unwritable dir, full disk) raises past here into _loop's
        # error counter and the next poll retries, instead of the
        # evidence being suppressed forever
        self._reported |= {tok for tok, _ in stuck}
        self.fired += 1
        _cmon.stat_add("flight/watchdog/fires", 1)
        # checkpoint-then-abort: incident hooks run AFTER the dump is
        # durable (the bundle is cheap and certain; a checkpoint may
        # take seconds and can itself wedge — its ckpt_write span
        # would then show in the NEXT dump)
        _run_incident_hooks(Incident("watchdog", detail))
        if _env_on("PADDLE_WATCHDOG_ABORT", default=False):
            # elastic relaunch contract: with evidence + checkpoint on
            # disk, kill the wedged rank so the supervisor restarts
            # the job instead of burning the reservation on a hang
            recorder.record("watchdog_abort")
            try:
                _cmon.VLOG(0, "flight: watchdog aborting process "
                              "(PADDLE_WATCHDOG_ABORT=1)")
            except Exception:
                pass
            os.kill(os.getpid(), signal.SIGABRT)
        return path


_watchdog = None
_watchdog_lock = _sanitize.lock("flight.watchdog")


def get_watchdog():
    return _watchdog


def start_watchdog(timeout_s=None, poll_s=None):
    """Start (or return) the process-wide watchdog. Explicit args
    restart it with the new settings."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is not None:
            if timeout_s is None and poll_s is None \
                    and _watchdog.running():
                return _watchdog
            _watchdog.stop()
        _watchdog = Watchdog(timeout_s, poll_s).start()
        return _watchdog


def stop_watchdog():
    global _watchdog
    with _watchdog_lock:
        wd, _watchdog = _watchdog, None
    if wd is not None:
        wd.stop()


# ---------------------------------------------------------------------------
# Crash bundles (excepthook / context manager / SIGUSR1)
# ---------------------------------------------------------------------------

def _format_exception(etype, value, tb):
    return {"type": getattr(etype, "__name__", str(etype)),
            "message": str(value),
            "traceback": traceback.format_exception(etype, value, tb)}


def _crash_dump(etype, value, tb):
    # memory.oom_observer may already have bundled THIS exception
    # (with the census taken while the offending tensors were still
    # live) — the excepthook must not shadow it with a second dump
    if getattr(value, "_paddle_flight_dumped", False):
        return None
    recorder.record("exception",
                    type=getattr(etype, "__name__", str(etype)),
                    message=str(value)[:300])
    reason = "crash"
    try:
        from . import memory as _memory

        if _memory.is_oom_error(value):
            # an out-of-memory gets its own reason (an operator greps
            # for oom_rank*.json) and the full census in its memory
            # section (_memory_section keys off the reason)
            reason = "oom"
    except Exception:
        pass
    return write_dump(
        reason, extra={"exception": _format_exception(etype, value,
                                                      tb)})


_orig_excepthook = None
_orig_threading_hook = None
_excepthook_installed = False
_excepthook_running = False


def _flight_excepthook(etype, value, tb):
    global _excepthook_running
    if _excepthook_running:
        # re-entered through a hook cycle (a third-party hook chained
        # back to us) — break it, print the real traceback once
        sys.__excepthook__(etype, value, tb)
        return
    _excepthook_running = True
    try:
        if _excepthook_installed:
            try:
                _crash_dump(etype, value, tb)
            except Exception:
                pass  # forensics must not mask the original crash
        (_orig_excepthook or sys.__excepthook__)(etype, value, tb)
    finally:
        _excepthook_running = False


def _flight_threading_excepthook(args):
    """threading.excepthook leg: an unhandled exception on a WORKER
    thread (dataloader producer, user prefetch thread) never reaches
    sys.excepthook — without this, a run that degrades after a thread
    death leaves no bundle."""
    if _excepthook_installed \
            and args.exc_type is not SystemExit:
        try:
            _crash_dump(args.exc_type, args.exc_value,
                        args.exc_traceback)
        except Exception:
            pass
    (_orig_threading_hook or threading.__excepthook__)(args)


def install_excepthook():
    """Chain a crash-bundle writer in front of sys.excepthook AND
    threading.excepthook: any unhandled exception — main or worker
    thread — leaves one inspectable JSON bundle before the normal
    traceback prints. Idempotent — and guarded by a flag, NOT by
    `sys.excepthook is ours`: re-installing after a third-party hook
    wrapped us would capture that wrapper as our `orig` and
    crash-time dispatch would cycle forever."""
    global _orig_excepthook, _orig_threading_hook, \
        _excepthook_installed
    if _excepthook_installed:
        return
    if _orig_excepthook is None:
        _orig_excepthook = sys.excepthook
        sys.excepthook = _flight_excepthook
    if _orig_threading_hook is None:
        _orig_threading_hook = threading.excepthook
        threading.excepthook = _flight_threading_excepthook
    # else: a prior uninstall-while-wrapped left our link inside a
    # third-party chain with the app's original retained — re-enable
    # via the flag alone; re-capturing the hook here would capture
    # the wrapper (dispatch cycle) and drop the original
    _excepthook_installed = True


def uninstall_excepthook():
    global _orig_excepthook, _orig_threading_hook, \
        _excepthook_installed
    if not _excepthook_installed:
        return
    if sys.excepthook is _flight_excepthook:
        sys.excepthook = _orig_excepthook or sys.__excepthook__
        _orig_excepthook = None
    if threading.excepthook is _flight_threading_excepthook:
        threading.excepthook = _orig_threading_hook \
            or threading.__excepthook__
        _orig_threading_hook = None
    # else: someone wrapped us — leave the chain intact (our link
    # becomes a pass-through via the flag) and keep the originals so
    # the chains still terminate correctly
    _excepthook_installed = False


@contextlib.contextmanager
def dump_on_crash():
    """Context-manager flavor of the excepthook for code the top-level
    hook never sees (worker threads, callers that catch and exit):
    writes the crash bundle, then re-raises."""
    try:
        yield
    except Exception:
        try:
            _crash_dump(*sys.exc_info())
        except Exception:
            pass
        raise


_orig_sig_handler = None
_orig_sig_signum = None
_sig_installed = None
_sig_running = False


def _signal_handler(signum, frame):
    # NEVER dump inline: the handler runs between bytecodes on the
    # main thread, possibly while the interrupted frame holds
    # recorder._lock / _inflight_lock / a StatRegistry lock — none
    # reentrant, so write_dump() here could wedge the very rank the
    # live dump is inspecting. A spawned thread queues behind the
    # lock instead.
    global _sig_running
    if _sig_running:
        return  # handler-chain cycle — break it
    _sig_running = True
    try:
        if _sig_installed == signum:  # armed for THIS signal
            def _dump():
                try:
                    write_dump("sigusr1")
                except Exception:
                    pass

            threading.Thread(target=_dump,
                             name="paddle-flight-sigusr1",
                             daemon=True).start()
        # chain like the excepthook does: auto-arm must not eat an
        # application's own SIGUSR1 handler (e.g. the cluster
        # checkpoint-on-preemption trigger); the retained original
        # belongs to one specific signal
        if signum == _orig_sig_signum and callable(_orig_sig_handler):
            _orig_sig_handler(signum, frame)
    finally:
        _sig_running = False


def install_signal_handler(signum=None):
    """Wire SIGUSR1 (or `signum`) to a live dump — `kill -USR1 <pid>`
    inspects a running rank without stopping it. A previously
    installed application handler is chained (called after the dump
    thread is spawned), and uninstall_signal_handler restores it.
    Idempotent via an installed flag (NOT handler identity — see
    install_excepthook). ONE live-dump signal at a time: asking for a
    second signal while another is armed (or while a dormant chain on
    another signal still routes through us) returns False rather than
    claiming success. Also returns False where installing is
    impossible (no SIGUSR1 on the platform, or not the main
    thread)."""
    global _orig_sig_handler, _orig_sig_signum, _sig_installed
    if signum is None:
        signum = getattr(signal, "SIGUSR1", None)
        if signum is None:
            return False
    if _sig_installed is not None:
        return signum == _sig_installed
    if _orig_sig_handler is not None:
        if signum != _orig_sig_signum:
            # a dormant (uninstalled-while-wrapped) chain on another
            # signal still routes through us; rewiring for a second
            # signal would orphan that chain's original handler
            return False
        # prior uninstall-while-wrapped ON THIS SIGNAL: our link still
        # sits inside a third-party chain — re-enable via the flag
        # alone (see install_excepthook)
        _sig_installed = signum
        return True
    try:
        prev = signal.signal(signum, _signal_handler)
    except (ValueError, OSError):
        return False
    if prev is not _signal_handler:
        _orig_sig_handler = prev
        _orig_sig_signum = signum
    _sig_installed = signum
    return True


def uninstall_signal_handler():
    global _orig_sig_handler, _orig_sig_signum, _sig_installed
    if _sig_installed is None:
        return
    try:
        if signal.getsignal(_sig_installed) is _signal_handler:
            signal.signal(_sig_installed,
                          _orig_sig_handler or signal.SIG_DFL)
            _orig_sig_handler = None
            _orig_sig_signum = None
        # else: wrapped by a later handler — leave the chain intact
        # (the cleared _sig_installed makes our link dump-free) and
        # keep _orig_sig_handler so the chain still terminates
    except (ValueError, OSError):
        pass
    _sig_installed = None


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------

def arm(watchdog=True, excepthook=True, usr1=True, timeout_s=None,
        poll_s=None):
    """Switch the full forensics layer on (recorder is always on
    unless PADDLE_FLIGHT_ENABLE=0). Returns the watchdog (or None).
    With the recorder disabled the watchdog is skipped too — begin()
    registers nothing, so the thread would poll an always-empty table
    forever; crash/SIGUSR1 dumps still work (stacks + telemetry, just
    no ring tail)."""
    if excepthook:
        install_excepthook()
    if usr1:
        install_signal_handler()
    if watchdog and recorder.enabled:
        return start_watchdog(timeout_s, poll_s)
    return None


def maybe_auto_arm(where=""):
    """Env-gated arm() called from hapi.Model.fit and
    distributed.init_parallel_env: PADDLE_FLIGHT_AUTOARM set non-falsy
    forces on, falsy forces off; unset arms only distributed runs
    (PADDLE_TRAINERS_NUM > 1) — single-host notebooks keep their
    excepthook untouched unless they opt in."""
    if not _env_on("PADDLE_FLIGHT_AUTOARM",
                   default=_world_size() > 1):
        return None
    recorder.record("auto_arm", where=where)
    return arm()


# the PADDLE_SANITIZE env autostart arms from inside this module's own
# `from . import sanitize` (before the recorder existed) — replay any
# events it buffered so the sanitize_arm event reaches the ring
_sanitize.flush_flight_events()
