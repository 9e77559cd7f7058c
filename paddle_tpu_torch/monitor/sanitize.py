"""paddle_tpu_torch.monitor.sanitize — the runtime sanitizer core, the
port of `paddle_tpu/monitor/sanitize.py` (:70-739).

Families (PADDLE_SANITIZE, `,`/`;`-separated, chaos-style grammar):

    donation    PTA043 only: the port donates no buffer (its steps
                update parameters in place), so there is no
                use-after-donate to catch (PTA041). What it checks is
                the boundary where `CheckpointManager` captures into
                its pooled host buffers: a snapshot leaf that is a
                view of a buffer the pool reuses (or a numpy array
                that does not own its memory) would be overwritten
                by the next capture while the writer still holds it.
                `verify_owned` / `verify_host_tree` report it and
                hand back an owned copy.
    locks       instrumented lock wrappers (monitor.flight, elastic
                checkpointing, the metrics exporter, the debug
                server): the cross-thread lock-acquisition-order graph
                with cycle detection (PTA060), timed holds (PTA061,
                `locks:hold_ms=`), and an at-exit census of non-daemon
                threads still alive (PTA063).
    serving     KV-block accounting in the serving engine
                (inference.serving.kv_cache): double-free / foreign
                free (PTA071), `audit_leaks(live)` /
                `LLMEngine.check_drained()` leaks (PTA070), and
                refcount / copy-on-write violations over prefix-cache
                shared blocks (PTA074).
    numerics    the precision sanitizer (PTA09x): TrainStepCompiler's
                per-tensor absmax / absmin / non-finite probe over
                loss, grads and params (`sample=N`, `absmax=T`;
                monitor.numerics) and the PTA092 / PTA093 audits,
                which raise.
    all / 1     every family above.

The JAX package's `sharding` and `compress` families are not ported
(`WAITING` names their ROADMAP item); a spec naming them is refused
like any unknown family.

Zero-overhead contract: with nothing armed every hook gates on a
module-attribute boolean (`sanitize._locks`, `_serving`, `_numerics`,
`_donation`) and `lock()` / `condition()` hand back plain `threading`
primitives, with no counters. The env spec arms at import; module-level
locks of adopting modules are instrumented only when `locks` is armed
at their creation (process start).
"""
from __future__ import annotations

import atexit
import os
import re
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core import monitor as _cmon

__all__ = [
    "FAMILIES", "PARAMS", "WAITING", "configure", "disarm", "armed",
    "families", "describe", "parse_spec", "verify_owned",
    "verify_host_tree", "SanLock", "lock", "condition",
    "lock_order_edges", "check_lock_order", "thread_census",
    "findings", "clear_findings", "flush_flight_events",
]

FAMILIES = {
    "donation": "snapshot owndata checks at the checkpoint capture "
                "(PTA043)",
    "locks": "lock-order deadlock analysis, timed holds, thread-leak "
             "census (PTA060/PTA061/PTA063)",
    "serving": "KV-block leak/double-free + prefix-cache refcount/COW "
               "accounting in the serving engine "
               "(PTA070/PTA071/PTA074)",
    "numerics": "precision sanitizer (PTA09x): TrainStepCompiler "
                "probes per-tensor absmax/absmin/nonfinite stats "
                "over loss/grads/params and the precision audits "
                "(fp16 master-weightless training, fp16 autocast of "
                "range-sensitive ops) raise",
}

# the JAX package's families the port does not have yet
WAITING = {
    "sharding": "ROADMAP queue 1 item 4 (Waits: the static analysis "
                "passes and the sharding family)",
    "compress": "ROADMAP queue 1 item 4 (Waits: the compress family, "
                "PTA080/PTA081)",
}

PARAMS = {
    "hold_ms": "locks: flag a lock held longer than this many "
               "milliseconds (PTA061; default 1000)",
    "sample": "numerics: host-readback cadence — observe the fused "
              "stats every Nth dispatch (default "
              "$PADDLE_NUMERICS_SAMPLE or 1)",
    "absmax": "numerics: saturation threshold — |x| above this "
              "reports PTA092 (default $PADDLE_NUMERICS_ABSMAX or "
              "0.9*65504)",
}

# hot-path gates — one module-attribute read per call site
_armed = False
_donation = False
_locks = False
_serving = False
_numerics = False
_spec = ""
_opts: dict = {}


def _flight():
    """Lazy flight import: flight.py adopts our lock wrappers at its
    own import, so this module must not import it back at top."""
    from . import flight

    return flight


# events recorded while flight.py is still mid-import (the env
# autostart arms from INSIDE flight's own `from . import sanitize`) —
# buffered and replayed by flush_flight_events() at the end of
# flight's import so the sanitize_arm event dump bundles promise is
# kept on the primary arming path
_pending_events: list = []


def _record_event(kind, **data):
    try:
        fl = _flight()
        rec = getattr(fl, "record", None)
        if rec is None:  # flight mid-import: record not defined yet
            raise AttributeError("flight mid-import")
        rec(kind, **data)
    except Exception:
        if len(_pending_events) < 16:
            _pending_events.append((kind, data))


def flush_flight_events():
    """Replay events buffered before the flight recorder existed.
    Called by monitor.flight at the end of its own module import."""
    while _pending_events:
        kind, data = _pending_events.pop(0)
        try:
            _flight().record(kind, **data)
        except Exception:
            return


# ---------------------------------------------------------------------------
# findings plumbing (shared by every family)
# ---------------------------------------------------------------------------

_findings: deque = deque(maxlen=256)
_finding_keys: set = set()  # rate-limit: one report per distinct key
_state_lock = threading.Lock()  # guards _findings/_finding_keys only


def _emit(code, message, file=None, line=None, dedup=None):
    """One runtime finding: analysis/<code>/findings + sanitize
    counters, a flight event (dump bundles show sanitizer hits), a
    stderr line, and a bounded in-memory record for findings()/tests.
    `dedup` suppresses repeat reports of the same condition (counters
    still tick) so a hot loop can't flood stderr."""
    _cmon.stat_add(f"analysis/{code}/findings", 1)
    _cmon.stat_add("sanitize/findings", 1)
    if dedup is not None:
        with _state_lock:
            if dedup in _finding_keys:
                return None
            _finding_keys.add(dedup)
    _record_event("sanitize_finding", code=code,
                  message=str(message)[:200])
    entry = {"code": code, "message": message, "file": file,
             "line": line}
    with _state_lock:
        _findings.append(entry)
    try:
        where = f" ({file}:{line})" if file else ""
        print(f"[paddle_tpu.sanitize] {code}: {message}{where}",
              file=sys.stderr)
    except Exception:
        pass
    return entry


def findings():
    """Accumulated runtime findings as analysis Finding objects."""
    from ..analysis.diagnostics import Finding

    with _state_lock:
        snap = list(_findings)
    return [Finding(e["code"], e["message"], file=e["file"],
                    line=e["line"], analyzer="sanitize")
            for e in snap]


def clear_findings():
    with _state_lock:
        _findings.clear()
        _finding_keys.clear()


def _site(skip=1):
    """file:line of the caller outside this module — the cheapest
    useful anchor (sys._getframe walk, no traceback formatting)."""
    try:
        f = sys._getframe(skip)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return "<unknown>"
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except Exception:
        return "<unknown>"


# ---------------------------------------------------------------------------
# spec / arming
# ---------------------------------------------------------------------------

def parse_spec(spec):
    """`family[:param=value]*[;,]...` -> {family: {param: float}}.
    `all`/`1`/`on`/`true` arm every family. Raises ValueError on
    unknown families/params (the chaos-spec contract: loud, never
    silently misarmed)."""
    fams: dict = {}
    for part in re.split(r"[;,]", str(spec)):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0].strip().lower()
        params = {}
        for field in fields[1:]:
            if "=" not in field:
                raise ValueError(
                    f"sanitize param {field!r} in {part!r} is not "
                    "key=value")
            k, v = field.split("=", 1)
            k = k.strip()
            if k not in PARAMS:
                raise ValueError(
                    f"unknown sanitize param {k!r} (known: "
                    f"{', '.join(sorted(PARAMS))})")
            try:
                params[k] = float(v)
            except ValueError:
                raise ValueError(
                    f"bad sanitize param value {v!r} for {k} in "
                    f"{part!r}")
        if name in ("all", "1", "on", "true"):
            for f in FAMILIES:
                fams.setdefault(f, {}).update(params)
        elif name in FAMILIES:
            fams.setdefault(name, {}).update(params)
        elif name in WAITING:
            raise ValueError(
                f"sanitize family {name!r} is not ported "
                f"({WAITING[name]})")
        else:
            raise ValueError(
                f"unknown sanitize family {name!r} (known: "
                f"{', '.join(sorted(FAMILIES))}, all)")
    return fams


def configure(spec=None):
    """Arm the families a spec describes (default: $PADDLE_SANITIZE).
    Replaces any previous configuration; empty/unset disarms. Returns
    the armed {family: params} map."""
    global _armed, _donation, _locks, _serving, _numerics, _spec, _opts
    if spec is None:
        spec = os.environ.get("PADDLE_SANITIZE", "")
    fams = parse_spec(spec) if spec else {}
    _opts = fams
    _donation = "donation" in fams
    _locks = "locks" in fams
    _serving = "serving" in fams
    _numerics = "numerics" in fams
    _armed = bool(fams)
    _spec = str(spec) if fams else ""
    if fams:
        _cmon.stat_set("sanitize/armed", len(fams))
        for f in fams:
            _cmon.stat_add(f"sanitize/{f}/armed", 1)
        _record_event("sanitize_arm", spec=_spec,
                      families=sorted(fams))
        try:
            _cmon.VLOG(0, f"sanitize: armed {sorted(fams)} ({_spec})")
        except Exception:
            pass
        if _locks:
            _register_atexit_census()
    return fams


def disarm():
    global _armed, _donation, _locks, _serving, _numerics, _spec, _opts
    _armed = _donation = _locks = _serving = _numerics = False
    _spec = ""
    _opts = {}
    # zero the gauge only if arming ever created it: stat_set would
    # CREATE a sanitize/armed=0 stat, and disarmed runs leave no
    # sanitize counter
    if "sanitize/armed" in _cmon.registry._stats:
        _cmon.stat_set("sanitize/armed", 0)


def armed(family=None):
    return _armed if family is None else family in _opts


def families():
    return sorted(_opts)


def describe():
    """Small JSON-able state summary — embedded in flight dump
    bundles so a post-mortem shows what the sanitizers were watching
    when the incident hit."""
    with _edge_lock:
        n_edges = len(_edges)
    with _state_lock:
        n_findings = len(_findings)
    return {"spec": _spec, "families": families(),
            # the port donates nothing: no donation is ever tracked
            "findings": n_findings, "donations_tracked": 0,
            "lock_edges": n_edges}


# ---------------------------------------------------------------------------
# PTA043 — snapshot ownership (the donation family's port)
# ---------------------------------------------------------------------------

def _tensor_owned(t):
    """A tensor owns its memory when it is no view and spans its whole
    storage: then no other tensor (a pooled buffer the next capture
    refills) writes into it."""
    return (t._base is None and t.storage_offset() == 0
            and t.untyped_storage().nbytes()
            == t.numel() * t.element_size())


def verify_owned(arr, site=None, what="host snapshot"):
    """PTA043 owndata check at a capture boundary: a numpy array that
    does not own its memory, or a tensor that is a view of a larger
    buffer, would change under the snapshot when that buffer is
    reused. Reports and returns an OWNED copy so the caller self-heals;
    anything else passes through."""
    if isinstance(arr, torch.Tensor):
        if _tensor_owned(arr):
            return arr
        owndata, base = False, type(arr._base).__name__
        copy = arr.clone(memory_format=torch.contiguous_format)
    elif isinstance(arr, np.ndarray):
        if arr.base is None and arr.flags["OWNDATA"]:
            return arr
        owndata = bool(arr.flags["OWNDATA"])
        base = type(arr.base).__name__
        copy = np.array(arr)
    else:
        return arr
    site = site or _site()
    _emit("PTA043",
          f"{what} does not own its memory (owndata={owndata}, "
          f"base={base}) at {site} — a view of a buffer the next "
          "capture reuses would change under the snapshot; taking an "
          "owned copy",
          dedup=f"PTA043:{site}:{what}")
    _cmon.stat_add("sanitize/donation/unowned_snapshots", 1)
    return copy


def verify_host_tree(tree, site=None, what="host snapshot"):
    """verify_owned over every tensor / ndarray leaf of a nested
    snapshot tree (the CheckpointManager capture boundary). Rebuilds
    containers only when armed: the disarmed path never calls this."""
    site = site or _site()
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return verify_owned(tree, site=site, what=what)
    if isinstance(tree, dict):
        return {k: verify_host_tree(v, site=site, what=what)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(verify_host_tree(v, site=site, what=what)
                          for v in tree)
    return tree


# ---------------------------------------------------------------------------
# PTA06x — concurrency sanitizer
# ---------------------------------------------------------------------------

_tls = threading.local()

# (holder_name, acquired_name) -> {"sites": (site_a, site_b),
#                                  "count": n}
_edges: dict = {}
_edge_lock = threading.Lock()
_hold_reported: set = set()


def _held():
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _hold_ms_threshold():
    return float(_opts.get("locks", {}).get("hold_ms", 1000.0))


class SanLock:
    """Instrumented drop-in for threading.Lock: records the
    cross-thread lock-acquisition-order graph (PTA060 cycle
    detection), times holds (PTA061 blocking-work-under-lock), and
    otherwise delegates. `with`-statement, bare acquire/release and
    Condition(lock=SanLock(...)) all work (Condition's _is_owned
    fallback only needs acquire/release)."""

    __slots__ = ("name", "_lk")

    def __init__(self, name, lk=None):
        self.name = name
        self._lk = lk if lk is not None else threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        got = self._lk.acquire(blocking, timeout)
        if got and _locks:
            site = _site(2)
            held = _held()
            for other, _t0, osite in held:
                if other.name != self.name:
                    _note_edge(other.name, self.name, osite, site)
            held.append((self, time.monotonic(), site))
        return got

    def release(self):
        long_hold = None
        if _locks:
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self:
                    _obj, t0, site = held.pop(i)
                    dur_ms = (time.monotonic() - t0) * 1e3
                    thr = _hold_ms_threshold()
                    if dur_ms > thr:
                        long_hold = (dur_ms, thr, site)
                    break
        self._lk.release()
        if long_hold is not None:
            # emit strictly AFTER releasing: _emit records a flight
            # event, and when THIS lock is the flight ring lock the
            # recorder would re-acquire it — emitting while still
            # held self-deadlocks the exact process being watched
            dur_ms, thr, site = long_hold
            _cmon.stat_add("sanitize/locks/long_holds", 1)
            _emit("PTA061",
                  f"lock '{self.name}' held {dur_ms:.0f} ms "
                  f"(> {thr:.0f} ms threshold) — blocking work "
                  f"under a lock starves every other waiter "
                  f"(acquired at {site})",
                  dedup=f"PTA061:{self.name}")

    def locked(self):
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SanLock {self.name} locked={self._lk.locked()}>"


def lock(name):
    """Lock factory the runtime adopts (flight, elastic, the exporter,
    the debug server): a SanLock when the locks family is armed at creation,
    else a plain threading.Lock — the disarmed hot path pays
    nothing."""
    return SanLock(name) if _locks else threading.Lock()


def condition(name):
    """Condition factory: instrumented underlying lock when armed.
    Condition.wait() releases/reacquires through the SanLock, so
    waiting never counts as holding."""
    return (threading.Condition(SanLock(name)) if _locks
            else threading.Condition())


def _note_edge(a, b, site_a, site_b):
    key = (a, b)
    with _edge_lock:
        ent = _edges.get(key)
        if ent is None:
            _edges[key] = {"sites": (site_a, site_b), "count": 1}
            _cmon.stat_add("sanitize/locks/edges", 1)
        else:
            ent["count"] += 1


def lock_order_edges():
    with _edge_lock:
        return {k: dict(v) for k, v in _edges.items()}


def _find_cycles(adj):
    """Simple-cycle enumeration over a small digraph: DFS with a path
    stack, cycles canonicalized (rotated to their min node) so each
    is reported once."""
    cycles = set()

    def dfs(node, path, on_path):
        for nxt in adj.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                k = cyc.index(min(cyc))
                cycles.add(tuple(cyc[k:] + cyc[:k]))
            elif len(path) < 16:
                dfs(nxt, path + [nxt], on_path | {nxt})

    for start in list(adj):
        dfs(start, [start], {start})
    return sorted(cycles)


def check_lock_order(report=None, emit=True):
    """Cycle-check the recorded acquisition-order graph: a cycle
    A->B / B->A means two threads can each hold the lock the other
    wants — the watchdog-vs-wedged-writer class of deadlock, caught
    from the ORDERS alone without ever deadlocking. Returns an
    analysis Report of PTA060 findings."""
    from ..analysis.diagnostics import Report

    report = report if report is not None else Report()
    edges = lock_order_edges()
    adj: dict = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    for cyc in _find_cycles(adj):
        legs = []
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            sites = edges[(a, b)]["sites"]
            legs.append(f"'{a}'->'{b}' ({sites[0]} then {sites[1]})")
        msg = ("potential deadlock: lock-acquisition-order cycle "
               + "; ".join(legs)
               + " — impose one global order or drop the inner "
                 "lock before blocking")
        report.add("PTA060", msg, analyzer="sanitize")
        if emit:
            _cmon.stat_add("sanitize/locks/cycles", 1)
            _emit("PTA060", msg, dedup=f"PTA060:{cyc}")
    return report


def thread_census(report=None, emit=True):
    """PTA063 thread-leak census: non-daemon, non-main threads still
    alive — each one blocks interpreter exit and races the runtime's
    teardown. Run after close()/shutdown, and automatically at exit
    when armed."""
    from ..analysis.diagnostics import Report

    report = report if report is not None else Report()
    for t in threading.enumerate():
        if t is threading.main_thread() or t.daemon or not t.is_alive():
            continue
        msg = (f"non-daemon thread '{t.name}' (ident={t.ident}) still "
               "alive — it outlives close() and will race interpreter "
               "teardown; join it before exit")
        report.add("PTA063", msg, analyzer="sanitize")
        if emit:
            _cmon.stat_add("sanitize/locks/leaked_threads", 1)
            _emit("PTA063", msg, dedup=f"PTA063:{t.name}")
    return report


_atexit_registered = False


def _register_atexit_census():
    global _atexit_registered
    if _atexit_registered:
        return
    _atexit_registered = True

    def _at_exit():
        if not _locks:
            return
        try:
            rep = thread_census(emit=False)
            rep = check_lock_order(report=rep, emit=False)
            for f in rep.findings:
                print(f"[paddle_tpu.sanitize] at-exit "
                      f"{f.code}: {f.message}", file=sys.stderr)
        except Exception:
            pass  # never break interpreter exit

    atexit.register(_at_exit)


# env-driven autostart (the chaos pattern): setting PADDLE_SANITIZE is
# enough for any run importing paddle_tpu_torch to arm. A typo'd spec must
# be LOUD but must not break `import paddle_tpu_torch`.
if os.environ.get("PADDLE_SANITIZE"):
    try:
        configure()
    except ValueError as _e:
        _cmon.stat_add("sanitize/spec_errors", 1)
        try:
            _cmon.VLOG(0, f"sanitize: IGNORING invalid PADDLE_SANITIZE "
                          f"spec ({_e})")
        except Exception:
            pass
