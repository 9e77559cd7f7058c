"""Flight recorder: the part of `paddle_tpu/monitor/flight.py` that
serving calls (:156-318, :530-552).

  * The event ring: `record(kind, **data)` appends one structured event
    to a process-wide bounded ring (`PADDLE_FLIGHT_CAPACITY`, default
    4096; `PADDLE_FLIGHT_ENABLE=0` turns it off), `tail(n)` reads the
    newest, `sync_stats()` pushes `flight/events` and
    `flight/ring/dropped` into the registry (every 256th event does it
    too).
  * The in-flight spans: `begin` / `end` / `in_flight(kind, name)` mark
    a thread inside a potentially-blocking operation (a serving
    dispatch, a drain, a failover) with `<kind>_begin` / `<kind>_end`
    events, and the open ones stay in a table until they end.
  * The incident-hook registry: `add_incident_hook(fn)`,
    `remove_incident_hook(fn)` and `_run_incident_hooks(reason)`. An
    armed serving engine registers its emergency drain-and-export here
    (`LLMEngine.arm_incident_export`).

The `Watchdog` that fires the incident hooks on a stuck span, the dump
bundles, the excepthooks and the signal handler are not ported
(ROADMAP queue 1 item 4): until then only a direct
`_run_incident_hooks(reason)` call fires an armed engine's export, as
the JAX package's own tests fire it.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

from ..core import monitor as _cmon

__all__ = ["FlightRecorder", "recorder", "record", "tail", "sync_stats",
           "begin", "end", "in_flight", "add_incident_hook",
           "remove_incident_hook"]

# the env-knob parsers every monitor-side consumer (trace, alerts,
# serving) reaches as flight._env_*
_env_int = _cmon._env_int
_env_float = _cmon._env_float
_env_on = _cmon._env_on

_FALSY = ("0", "false", "off", "no")


def _rank():
    """This process's trainer rank from the launch env (0 without
    one); never initializes a process group."""
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


class FlightRecorder:
    """Bounded ring of (ts, tid, kind, data) events. record() is the
    always-on hot path: one lock, one deque append."""

    def __init__(self, capacity=None, enabled=None):
        if capacity is None:
            capacity = _env_int("PADDLE_FLIGHT_CAPACITY", 4096)
        if enabled is None:
            enabled = _env_on("PADDLE_FLIGHT_ENABLE", True)
        self._ring = deque(maxlen=max(16, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        self.enabled = bool(enabled)

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
        if sync:
            self.sync_stats()

    def sync_stats(self):
        """Push the ring's counters into the registry (flight/events,
        flight/ring/dropped)."""
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
            evs = evs[-int(n):] if int(n) > 0 else []
        return [dict({"ts": round(ts, 6), "tid": tid, "kind": kind},
                     **(data or {}))
                for ts, tid, kind, data in evs]


recorder = FlightRecorder()


def record(kind, **data):
    """Append one structured event to the process-wide flight ring."""
    recorder.record(kind, **data)


def tail(n=None):
    return recorder.tail(n)


def sync_stats():
    recorder.sync_stats()


# -- in-flight spans -------------------------------------------------

_inflight: dict = {}
_inflight_lock = threading.Lock()
_token_seq = itertools.count(1)


def begin(kind, name, **data):
    """Mark this thread entering a potentially-blocking operation:
    records `<kind>_begin` and registers the op. Returns a token for
    end(); None when the recorder is off (end(None) is a no-op)."""
    if not recorder.enabled:
        return None
    recorder.record(f"{kind}_begin", name=name, **data)
    token = next(_token_seq)
    entry = dict({"kind": kind, "name": name,
                  "tid": threading.get_ident(),
                  "t0": round(time.time(), 6),
                  "_t0m": time.monotonic()}, **data)
    with _inflight_lock:
        _inflight[token] = entry
    return token


def end(token):
    """Close what begin() opened: drop it from the in-flight table and
    record `<kind>_end` with its duration."""
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


# -- incident hooks --------------------------------------------------

_incident_hooks: list = []


def add_incident_hook(fn):
    """Register fn(reason) to run on an incident. Hooks are
    best-effort: an exception counts under flight/incident_hook/errors
    and goes no further."""
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
