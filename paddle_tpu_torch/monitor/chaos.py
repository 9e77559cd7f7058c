"""paddle_tpu_torch.monitor.chaos — deterministic, seeded fault
injection, the port of `paddle_tpu/monitor/chaos.py` (:56-491).

Named injection sites threaded through the runtime's failure-prone
seams, armed by a spec string and observed through the same counters
and flight events that watch real faults.

Sites (SITES; the JAX package's sites with no seam in the port yet are
in WAITING, with their ROADMAP item):

    collective   eager collective enter (distributed.collective.*)
    ckpt_write   checkpoint snapshot write (incubate.checkpoint.elastic)
    io_fetch     DataLoader sample fetch (worker loop + in-process)
    dispatch     train-step dispatch (jit.TrainStepCompiler)
    serve_admit  serving-scheduler request admission
    serve_decode serving-engine decode dispatch (LLMEngine)
    serve_route  serving-router replica selection (Router)
    serve_drain  serving-engine / router graceful drain
    serve_spec_verify  speculative-decode draft verification (LLMEngine)
    comm_compress      quantized allreduce (distributed.compress)

Spec grammar (PADDLE_CHAOS, `;`-separated rules):

    site:fault[:param=value]*
    e.g.  collective:stall:p=0.01:seed=7;ckpt_write:enospc:after=3

Determinism: every rule owns a `random.Random(seed)` (seed defaults to
crc32 of site:fault:rank) and plain per-process after/every/times
counts, so the same spec in the same process replays the same fault
sequence — the JAX package's, decision for decision.

Two faults take the port's form: `resource_exhausted` raises
`torch.OutOfMemoryError` with the RESOURCE_EXHAUSTED message (the JAX
package raises a synthetic XlaRuntimeError; `monitor.memory.
is_oom_error` classifies both), and `bitflip` corrupts the quantized
codes of each armed allreduce call (the JAX package bakes the flip
into one built program). ROADMAP queue 3 records both.

Zero-overhead contract: with nothing armed `_armed` is False and every
call site guards with `if chaos._armed: chaos.hit(...)`.

Observability: configuring counts each rule under
`chaos/<site>/<fault>/armed` (+ the `chaos/armed` gauge) and records a
`chaos_arm` flight event; every trigger counts
`chaos/<site>/<fault>/triggered` and records `chaos_inject`.

Programmatic use (tests):

    with chaos.inject("ckpt_write", "torn", after=1):
        ...
"""
from __future__ import annotations

import contextlib
import errno
import os
import random
import threading
import time
import zlib

import torch

from ..core import monitor as _cmon
from . import flight as _flight

__all__ = [
    "SITES", "FAULTS", "PARAMS", "WAITING", "Rule", "parse_spec",
    "configure", "disarm", "inject", "hit", "rules", "active",
    "ChaosInjected", "ChaosBadSample",
]

SITES = {
    "collective": "eager collective enter (distributed.collective.*)",
    "ckpt_write": "checkpoint snapshot write "
                  "(incubate.checkpoint.elastic._write_snapshot)",
    "io_fetch": "DataLoader sample fetch (io.worker's worker loop + "
                "the in-process DataLoader._fetch)",
    "dispatch": "train-step dispatch "
                "(jit.TrainStepCompiler.__call__)",
    "serve_admit": "serving-scheduler request admission "
                   "(inference.serving.scheduler — delay = slow "
                   "client)",
    "serve_decode": "serving-engine decode dispatch "
                    "(inference.serving.engine; resource_exhausted "
                    "drives the mid-decode eviction path)",
    "serve_route": "serving-router replica selection "
                   "(inference.serving.router — raise = routing "
                   "layer failure before any replica is touched)",
    "serve_drain": "serving-engine graceful drain entry "
                   "(inference.serving.engine.drain — raise = drain "
                   "aborted before any request is exported)",
    "serve_spec_verify": "speculative-decode draft verification "
                         "(inference.serving.engine — corrupt forces "
                         "every draft to diverge; acceptance degrades "
                         "to 1 token/round, emitted tokens stay "
                         "identical)",
    "comm_compress": "quantized allreduce "
                     "(distributed.compress.allreduce — bitflip "
                     "corrupts one wire block of each armed call)",
}

# the JAX package's sites with no seam in the port yet
WAITING = {
    site: "ROADMAP queue 1 item 4 (Waits: the chaos sites with no "
          "seam in the port)"
    for site in ("store_get", "store_put", "rendezvous", "cache_write",
                 "linalg_dispatch")
}

FAULTS = {
    "delay": "sleep ms= milliseconds, then proceed",
    "stall": "sleep secs= seconds (a watchdog-visible hang), then "
             "proceed",
    "hang": "alias of stall",
    "raise": "raise exc= (default ChaosInjected) with msg=",
    "enospc": "raise OSError(ENOSPC) — full checkpoint/log filesystem",
    "torn": "site-interpreted torn write: the site persists a partial "
            "artifact, then raises (ckpt_write)",
    "crash": "os._exit(3) THIS process — meant for mp DataLoader "
             "workers",
    "bad_sample": "raise ChaosBadSample — feeds the DataLoader "
                  "on_bad_sample policy",
    "resource_exhausted": "raise torch.OutOfMemoryError "
                          "RESOURCE_EXHAUSTED (OOM forensics path)",
    "bitflip": "site-interpreted wire corruption: the quantized "
               "allreduce XORs bit 6 into every code of scale "
               "block 0 of the armed call (comm_compress)",
    "corrupt": "site-interpreted draft corruption: the serving engine "
               "replaces every speculative draft proposal in the "
               "round, forcing verification to reject them all "
               "(serve_spec_verify)",
}

PARAMS = {
    "p": "trigger probability per eligible call (float, default 1.0; "
         "decisions ride the rule's seeded rng)",
    "seed": "rng seed for p<1 decisions (int, default "
            "crc32('site:fault:rank'))",
    "after": "let the first N calls pass untouched (int, default 0)",
    "every": "of the calls past `after`, arm every Nth (int, "
             "default 1)",
    "times": "maximum triggers (int, default unlimited)",
    "ms": "delay duration in milliseconds (float, default 100)",
    "secs": "stall duration in seconds (float, default 30)",
    "exc": "exception class for `raise`: RuntimeError, OSError, "
           "ValueError, TimeoutError, ConnectionError",
    "msg": "message for `raise`",
}


def _tag(exc):
    """Mark an exception as a RUNTIME fault this module raised (vs
    ChaosBadSample, the bad-RECORD simulation): degradation policies
    like DataLoader's on_bad_sample='skip' must let tagged faults
    propagate, or the chaos/* triggered counters would claim effects
    (an escaping exception) that never happened."""
    try:
        exc._paddle_chaos_fault = True
    except Exception:
        pass
    return exc


class ChaosInjected(RuntimeError):
    """Default exception of the `raise` fault."""


class ChaosBadSample(ValueError):
    """The `bad_sample` fault — what a corrupt record raises."""


_EXC_NAMES = {
    "RuntimeError": RuntimeError, "OSError": OSError,
    "ValueError": ValueError, "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "ChaosInjected": ChaosInjected,
}

_INT_PARAMS = ("seed", "after", "every", "times")
_FLOAT_PARAMS = ("p", "ms", "secs")

# site-interpreted faults only make sense where a call site enacts
# the returned Rule — arming them elsewhere would count `triggered`
# injections that never happened, corrupting the chaos/* provenance
_SITE_INTERPRETED = {"torn": ("ckpt_write",),
                     "bitflip": ("comm_compress",),
                     "corrupt": ("serve_spec_verify",)}


def _default_seed(site, fault):
    return zlib.crc32(
        f"{site}:{fault}:{_flight._rank()}".encode()) & 0x7FFFFFFF


class Rule:
    """One armed (site, fault) with its trigger discipline. Counters
    (`calls`/`triggers`) and the seeded rng are per-process state —
    forked DataLoader workers inherit a snapshot and count their own
    calls from there."""

    def __init__(self, site, fault, **params):
        if site in WAITING:
            raise ValueError(
                f"chaos site {site!r} is not ported ({WAITING[site]})")
        if site not in SITES:
            raise ValueError(
                f"unknown chaos site {site!r} (known: "
                f"{', '.join(sorted(SITES))})")
        if fault not in FAULTS:
            raise ValueError(
                f"unknown chaos fault {fault!r} (known: "
                f"{', '.join(sorted(FAULTS))})")
        ok_sites = _SITE_INTERPRETED.get(fault)
        if ok_sites is not None and site not in ok_sites:
            raise ValueError(
                f"chaos fault {fault!r} is site-interpreted and only "
                f"supported at {', '.join(ok_sites)} (got {site!r})")
        self.site = site
        self.fault = "stall" if fault == "hang" else fault
        for k in params:
            if k not in PARAMS:
                raise ValueError(
                    f"unknown chaos param {k!r} in {site}:{fault} "
                    f"(known: {', '.join(sorted(PARAMS))})")
        try:
            self.p = float(params.get("p", 1.0))
            self.seed = int(params.get("seed",
                                       _default_seed(site, fault)))
            self.after = int(params.get("after", 0))
            self.every = max(1, int(params.get("every", 1)))
            self.times = (int(params["times"])
                          if "times" in params else None)
            self.ms = float(params.get("ms", 100.0))
            self.secs = float(params.get("secs", 30.0))
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad chaos param value in {site}:{fault}: {e}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(
                f"chaos param p={self.p} out of [0, 1] in "
                f"{site}:{fault}")
        exc = params.get("exc", "ChaosInjected")
        if exc not in _EXC_NAMES:
            raise ValueError(
                f"unknown chaos exc {exc!r} (known: "
                f"{', '.join(sorted(_EXC_NAMES))})")
        self.exc = _EXC_NAMES[exc]
        self.msg = str(params.get(
            "msg", f"chaos: injected {self.fault} at {site}"))
        self._rng = random.Random(self.seed)
        self.calls = 0
        self.triggers = 0

    def describe(self):
        d = {"site": self.site, "fault": self.fault, "p": self.p,
             "seed": self.seed, "after": self.after,
             "every": self.every, "times": self.times,
             "calls": self.calls, "triggers": self.triggers}
        if self.fault == "delay":
            d["ms"] = self.ms
        if self.fault == "stall":
            d["secs"] = self.secs
        if self.fault == "raise":
            d["exc"] = self.exc.__name__
        return d

    # -- firing ------------------------------------------------------
    def _claim(self):
        """One trigger decision — caller holds the module lock, so
        the calls/triggers counters and the seeded rng advance
        atomically (two threads racing a times=1 rule must not both
        fire, or the 'same spec replays the same fault sequence'
        contract breaks). Returns the claimed trigger ordinal, or
        None."""
        self.calls += 1
        if self.calls <= self.after:
            return None
        if (self.calls - self.after - 1) % self.every:
            return None
        if self.times is not None and self.triggers >= self.times:
            return None
        if self.p < 1.0 and self._rng.random() >= self.p:
            return None
        self.triggers += 1
        return self.triggers

    def _execute(self, site, ctx, n):
        """Record trigger `n` (already claimed under the lock), then
        enact the fault. Returns self for site-interpreted faults
        (`torn`), None otherwise."""
        _cmon.stat_add(f"chaos/{site}/{self.fault}/triggered", 1)
        _flight.record("chaos_inject", site=site, fault=self.fault,
                       n=n, **ctx)
        f = self.fault
        if f == "delay":
            time.sleep(self.ms / 1e3)
            return None
        if f == "stall":
            time.sleep(self.secs)
            return None
        if f == "raise":
            raise _tag(self.exc(self.msg))
        if f == "enospc":
            raise _tag(OSError(
                errno.ENOSPC,
                f"chaos: no space left on device ({site})"))
        if f == "crash":
            # hard worker death (SIGKILL analog a supervisor can't
            # catch) — forked DataLoader workers only (io.worker's
            # loop passes its worker id): in the trainer process
            # os._exit would bypass the flight excepthook and every
            # emergency-checkpoint path the crash is supposed to
            # exercise, so it raises there
            if ctx.get("worker") is None:
                raise _tag(ChaosInjected(
                    f"chaos: crash fault at {site} outside an mp "
                    "worker — raising instead of os._exit"))
            os._exit(3)
        if f == "bad_sample":
            raise ChaosBadSample(
                f"chaos: bad sample injected at {site}")
        if f == "resource_exhausted":
            raise _tag(torch.OutOfMemoryError(
                "RESOURCE_EXHAUSTED: Out of memory while trying to "
                f"allocate (chaos injected at {site})"))
        return self  # torn (and future site-interpreted faults)


# site -> [Rule]; _armed is THE hot-path gate (module attribute, read
# by every call site before touching anything else here)
_rules: dict = {}
_armed = False
_spec = ""
_lock = threading.Lock()


def active():
    return _armed


def rules():
    """Flat list of live rules (CLI / tests)."""
    return [r for rs in _rules.values() for r in rs]


def parse_spec(spec):
    """`site:fault[:param=value]*[;...]` -> [Rule]. Raises ValueError
    with an operator-readable message on any unknown
    site/fault/param."""
    out = []
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"chaos rule {part!r} needs at least site:fault")
        params = {}
        for field in fields[2:]:
            if "=" not in field:
                raise ValueError(
                    f"chaos param {field!r} in {part!r} is not "
                    "key=value")
            k, v = field.split("=", 1)
            params[k.strip()] = v.strip()
        out.append(Rule(fields[0].strip(), fields[1].strip(),
                        **params))
    return out


def _sync_armed_stats():
    _cmon.stat_set("chaos/armed", len(rules()))


def configure(spec=None):
    """Arm the rules a spec describes (default: $PADDLE_CHAOS).
    Replaces any previous configuration; an empty/unset spec disarms.
    Returns the armed rules."""
    global _rules, _armed, _spec
    if spec is None:
        spec = os.environ.get("PADDLE_CHAOS", "")
    parsed = parse_spec(spec) if spec else []
    with _lock:
        _rules = {}
        for r in parsed:
            _rules.setdefault(r.site, []).append(r)
        _armed = bool(parsed)
        _spec = spec if parsed else ""
    _sync_armed_stats()
    if parsed:
        for r in parsed:
            _cmon.stat_add(f"chaos/{r.site}/{r.fault}/armed", 1)
        _flight.record("chaos_arm", spec=spec, rules=len(parsed))
        try:
            _cmon.VLOG(0, f"chaos: armed {len(parsed)} rule(s): "
                          f"{spec}")
        except Exception:
            pass
    return parsed


def disarm():
    global _rules, _armed, _spec
    with _lock:
        _rules = {}
        _armed = False
        _spec = ""
    _sync_armed_stats()


@contextlib.contextmanager
def inject(site, fault, **params):
    """Programmatic injection: arm ONE extra rule for the with-block
    (composes with any spec-armed rules). Yields the Rule so tests can
    read its calls/triggers counters."""
    global _armed
    rule = Rule(site, fault, **params)
    with _lock:
        _rules.setdefault(rule.site, []).append(rule)
        _armed = True
    _cmon.stat_add(f"chaos/{rule.site}/{rule.fault}/armed", 1)
    _sync_armed_stats()
    _flight.record("chaos_arm", site=rule.site, fault=rule.fault,
                   rules=len(rules()))
    try:
        yield rule
    finally:
        with _lock:
            rs = _rules.get(rule.site, [])
            if rule in rs:
                rs.remove(rule)
            if not rs:
                _rules.pop(rule.site, None)
            _armed = bool(_rules)
        _sync_armed_stats()


def hit(site, **ctx):
    """One pass through an injection site. No-op (None) when nothing
    is armed for `site`; otherwise each matching rule gets a trigger
    decision — delays/stalls sleep here, raising faults raise out of
    here, and site-interpreted faults (torn) return their Rule for
    the call site to enact. Call sites guard with
    `if chaos._armed: chaos.hit(...)` so the disarmed path never even
    enters this function."""
    if not _armed:
        return None
    # lock-free pre-check (dict membership is GIL-atomic; arming
    # publishes the site key before _armed flips on configure, and a
    # rare race with inject() just means one extra locked lookup) —
    # sites no armed rule targets stay near zero-overhead even while
    # OTHER sites are armed
    if site not in _rules:
        return None
    with _lock:
        rs = list(_rules.get(site, ()))
    out = None
    for rule in rs:
        with _lock:
            n = rule._claim()
        if n is not None:
            act = rule._execute(site, ctx, n)
            if act is not None:
                out = act
    return out


# env-driven autostart: setting PADDLE_CHAOS is enough for any run
# importing paddle_tpu_torch to arm the spec. A typo'd spec must be
# LOUD but must not break the import.
if os.environ.get("PADDLE_CHAOS"):
    try:
        configure()
    except ValueError as _e:
        _cmon.stat_add("chaos/spec_errors", 1)
        try:
            _cmon.VLOG(0, f"chaos: IGNORING invalid PADDLE_CHAOS "
                          f"spec ({_e})")
        except Exception:
            pass
