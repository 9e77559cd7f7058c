"""Declarative SLO alerting over the live StatRegistry: the port of
`paddle_tpu/monitor/alerts.py`, off by default (no thread, no counters
until `configure()` or `PADDLE_ALERTS` arms it).

Rule kinds (`KINDS`):

    threshold   counter/gauge vs bound; the metric may glob
                (`serve/replica/*/healthy:threshold:lt=1` fires when
                ANY replica goes unhealthy)
    quantile    histogram p-quantile vs bound, on the WINDOWED delta
                between evaluation ticks (`Histogram.delta_since`)
    rate        counter delta per second over a short window
    burn_rate   error-budget burn: fires only when BOTH the short and
                the long window burn faster than `factor` x the budget
    fraction    metric / (metric + of) vs bound
    absence     an expected series never appeared

Each rule drives a `pending -> firing -> resolved` state machine with
`for` (breaching ticks before firing) and `clear` (clean ticks before
resolving) streaks. Rules come as `AlertRule` objects or a spec string,
`metric:kind[:param=value]*[;...]`; the bare words
`serving`/`default`/`all`/`1`/`on`/`true` expand to `default_rules()`.

`evaluate_once(now=)` ticks every armed rule once; an `AlertEvaluator`
thread (`PADDLE_ALERT_INTERVAL_S`, at least 50 ms) calls it on a
cadence. Transitions write `alerts/<name>/firing` and
`alerts/<name>/transitions`, record `alert_fire` / `alert_resolve`
flight events and reach every listener (`add_listener`): the serving
`Autoscaler` scales replicas from exactly this callback. The JAX
package's VLOG lines and its sanitizer lock are not carried over (the
lock is a plain `threading.Lock`).
"""
from __future__ import annotations

import fnmatch
import os
import threading
import time

from ..core import monitor as _cmon
from . import flight as _flight

__all__ = [
    "KINDS", "PARAMS", "AlertRule", "AlertEvaluator", "parse_spec",
    "default_rules", "configure", "disarm", "armed", "rules",
    "describe", "evaluate_once", "add_listener", "remove_listener",
    "env_interval_s", "OK", "PENDING", "FIRING", "RESOLVED",
]

# rule states
OK = "ok"                # armed, never fired
PENDING = "pending"      # breaching, streak < for
FIRING = "firing"
RESOLVED = "resolved"    # fired at least once, currently clean

KINDS = {
    "threshold": "counter/gauge vs bound (metric may glob: "
                 "serve/replica/*/healthy:threshold:lt=1)",
    "quantile": "histogram p-quantile on the WINDOWED delta between "
                "ticks vs bound (q=0.99 default)",
    "rate": "counter delta per second over `window` vs bound",
    "burn_rate": "error-budget burn (metric=errors, total=requests): "
                 "fires when short AND long windows both burn "
                 ">= factor x budget",
    "fraction": "metric / (metric + of) pool fraction vs bound",
    "absence": "expected series (stat or histogram) never appeared",
}

# param -> help; values parse as float except the *metric-name*
# params (name/total/of), which stay strings
PARAMS = {
    "name": "rule name — counters land under alerts/<name>/*",
    "gt": "fire when value > bound",
    "ge": "fire when value >= bound",
    "lt": "fire when value < bound",
    "le": "fire when value <= bound",
    "q": "quantile in [0, 1] (quantile kind; default 0.99)",
    "for": "consecutive breaching ticks before firing (default 1)",
    "clear": "consecutive clean ticks before resolving (default 2)",
    "min_n": "minimum windowed observations for quantile (default 1)",
    "window": "short window seconds (rate/burn_rate; default 60)",
    "long": "long window seconds (burn_rate; default 3600)",
    "budget": "allowed error fraction (burn_rate; default 0.01)",
    "factor": "burn multiple that fires (burn_rate; default 14.4)",
    "total": "total-counter metric name (burn_rate; required)",
    "of": "complement metric name (fraction; required)",
}

_STR_PARAMS = ("name", "total", "of")
_OPS = {
    "gt": lambda v, b: v > b,
    "ge": lambda v, b: v >= b,
    "lt": lambda v, b: v < b,
    "le": lambda v, b: v <= b,
}
_DEFAULT_WORDS = ("serving", "default", "all", "1", "on", "true")


def env_interval_s():
    """PADDLE_ALERT_INTERVAL_S — evaluator cadence (default 1s,
    bounded below at 50ms: the tick snapshots the whole registry)."""
    return max(0.05, _flight._env_float("PADDLE_ALERT_INTERVAL_S",
                                        1.0))


def _live_hist(name):
    """The live Histogram, or None — WITHOUT get-or-create: an alert
    probing a series that never existed must not conjure an empty
    histogram into /metrics."""
    reg = _cmon.registry
    with reg._lock:
        return reg._hists.get(name)


def _hist_names():
    reg = _cmon.registry
    with reg._lock:
        return list(reg._hists)


class AlertRule:
    """One declarative rule + its live state. Construction validates
    everything: a loud ValueError with an operator-readable message,
    never a silently misarmed rule."""

    def __init__(self, metric, kind, **params):
        self.metric = str(metric).strip()
        self.kind = str(kind).strip().lower()
        if not self.metric:
            raise ValueError("alert rule needs a metric name")
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown alert kind {self.kind!r} (known: "
                f"{', '.join(sorted(KINDS))})")
        vals = {}
        for k, v in params.items():
            if k not in PARAMS:
                raise ValueError(
                    f"unknown alert param {k!r} (known: "
                    f"{', '.join(sorted(PARAMS))})")
            if k in _STR_PARAMS:
                vals[k] = str(v).strip()
                continue
            try:
                vals[k] = float(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"bad alert param value {v!r} for {k} in "
                    f"{self.metric}:{self.kind}")
        ops = [k for k in _OPS if k in vals]
        if self.kind in ("burn_rate", "absence"):
            if ops:
                raise ValueError(
                    f"{self.kind} rules take no {'/'.join(ops)} "
                    f"bound ({self.metric})")
            self.op, self.bound = None, None
        else:
            if len(ops) != 1:
                raise ValueError(
                    f"{self.metric}:{self.kind} needs exactly one "
                    "of gt/ge/lt/le")
            self.op = ops[0]
            self.bound = vals[self.op]
        self.q = float(vals.get("q", 0.99))
        if not 0.0 <= self.q <= 1.0:
            raise ValueError(
                f"alert param q={self.q} out of [0, 1] in "
                f"{self.metric}")
        self.for_ticks = max(1, int(vals.get("for", 1)))
        self.clear_ticks = max(1, int(vals.get("clear", 2)))
        self.min_n = max(1, int(vals.get("min_n", 1)))
        self.window_s = max(0.0, float(vals.get("window", 60.0)))
        self.long_s = max(self.window_s,
                          float(vals.get("long", 3600.0)))
        self.budget = float(vals.get("budget", 0.01))
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(
                f"alert param budget={self.budget} out of (0, 1] in "
                f"{self.metric}")
        self.factor = float(vals.get("factor", 14.4))
        self.total = vals.get("total", "")
        self.of = vals.get("of", "")
        if self.kind == "burn_rate" and not self.total:
            raise ValueError(
                f"{self.metric}:burn_rate needs total=<metric>")
        if self.kind == "fraction" and not self.of:
            raise ValueError(
                f"{self.metric}:fraction needs of=<metric>")
        if "*" in self.metric and self.kind not in ("threshold",
                                                    "absence"):
            raise ValueError(
                f"glob metrics only work for threshold/absence "
                f"rules, not {self.metric}:{self.kind}")
        name = vals.get("name") or self.metric.replace(
            "/", "_").replace("*", "any")
        if not all(c.isalnum() or c in "_.-" for c in name):
            raise ValueError(
                f"bad alert rule name {name!r} (alphanumeric and "
                "_.- only — it keys alerts/<name>/* counters)")
        self.name = name
        # live state
        self.state = OK
        self.value = None
        self.streak = 0
        self.clear_streak = 0
        self.fired = 0
        self._prev = None      # quantile: last Histogram.snapshot()
        self._samples = []     # rate/burn_rate: (now, v[, total])

    # -- evaluation --------------------------------------------------
    def _match_values(self, stats):
        """Numeric values of every stat the (possibly glob) metric
        names — [] when the series does not exist yet."""
        if "*" in self.metric:
            keys = fnmatch.filter(stats, self.metric)
        else:
            keys = [self.metric] if self.metric in stats else []
        return [stats[k] for k in keys
                if isinstance(stats[k], (int, float))
                and not isinstance(stats[k], bool)]

    def _windowed(self, now, w):
        """(dt, deltas...) against the newest sample at least `w`
        old — or the oldest on record while the window fills."""
        base = None
        for s in self._samples:
            if now - s[0] >= w:
                base = s
            else:
                break
        if base is None and self._samples:
            base = self._samples[0]
        cur = self._samples[-1] if self._samples else None
        if base is None or cur is None or cur[0] <= base[0]:
            return None
        return (cur[0] - base[0],) + tuple(
            c - b for c, b in zip(cur[1:], base[1:]))

    def _eval(self, stats, now):
        """(value, breach) for this tick; value None = no data (never
        breaches except for `absence`, whose whole point is no
        data)."""
        k = self.kind
        if k == "absence":
            present = bool(self._match_values(stats))
            if not present:
                pat = self.metric
                present = any(fnmatch.fnmatch(h, pat)
                              for h in _hist_names()) \
                    if "*" in pat else _live_hist(pat) is not None
            return (0.0 if present else 1.0), not present
        if k == "threshold":
            vals = [v for v in self._match_values(stats)
                    if _OPS[self.op](v, self.bound)]
            if vals:
                worst = max(vals) if self.op in ("gt", "ge") \
                    else min(vals)
                return worst, True
            allv = self._match_values(stats)
            if not allv:
                return None, False
            return (max(allv) if self.op in ("gt", "ge")
                    else min(allv)), False
        if k == "fraction":
            m, o = stats.get(self.metric), stats.get(self.of)
            if not isinstance(m, (int, float)) \
                    or not isinstance(o, (int, float)) or m + o <= 0:
                return None, False
            v = m / (m + o)
            return v, _OPS[self.op](v, self.bound)
        if k == "quantile":
            h = _live_hist(self.metric)
            if h is None:
                return None, False
            delta = h.delta_since(self._prev)
            self._prev = h.snapshot()
            if int(delta.get("count", 0)) < self.min_n:
                return None, False
            v = _cmon.snapshot_quantile(delta, self.q, empty=None)
            if v is None:
                return None, False
            return v, _OPS[self.op](v, self.bound)
        if k == "rate":
            v = stats.get(self.metric)
            if not isinstance(v, (int, float)):
                return None, False
            if self._samples and v < self._samples[-1][1]:
                self._samples = []        # counter reset — rebase
            self._samples.append((now, v))
            self._prune(now, self.window_s)
            d = self._windowed(now, self.window_s)
            if d is None:
                return None, False
            rate = d[1] / d[0]
            return rate, _OPS[self.op](rate, self.bound)
        # burn_rate
        err, tot = stats.get(self.metric), stats.get(self.total)
        if not isinstance(err, (int, float)) \
                or not isinstance(tot, (int, float)):
            return None, False
        if self._samples and (err < self._samples[-1][1]
                              or tot < self._samples[-1][2]):
            self._samples = []            # counter reset — rebase
        self._samples.append((now, err, tot))
        self._prune(now, self.long_s)
        burns = []
        for w in (self.window_s, self.long_s):
            d = self._windowed(now, w)
            if d is None or d[2] <= 0:
                return None, False
            burns.append((d[1] / d[2]) / self.budget)
        return burns[0], all(b >= self.factor for b in burns)

    def _prune(self, now, keep_s):
        """Drop samples older than the window, keeping ONE as the
        window baseline."""
        cut = 0
        for i, s in enumerate(self._samples):
            if now - s[0] >= keep_s:
                cut = i
            else:
                break
        if cut:
            del self._samples[:cut]

    def _tick(self, stats, now):
        """Advance the state machine one evaluation tick. Returns
        "fire"/"resolve" on a transition, else None. Counter/flight
        writes happen HERE — only armed rules tick, so the disarmed
        path never creates an alerts/* stat."""
        value, breach = self._eval(stats, now)
        self.value = value
        ev = None
        if breach:
            self.clear_streak = 0
            if self.state != FIRING:
                self.streak += 1
                if self.streak >= self.for_ticks:
                    self.state = FIRING
                    self.fired += 1
                    ev = "fire"
                else:
                    self.state = PENDING
        else:
            self.streak = 0
            if self.state == PENDING:
                self.state = RESOLVED if self.fired else OK
            elif self.state == FIRING:
                self.clear_streak += 1
                if self.clear_streak >= self.clear_ticks:
                    self.state = RESOLVED
                    ev = "resolve"
        if ev is not None:
            _cmon.stat_set(f"alerts/{self.name}/firing",
                           1 if ev == "fire" else 0)
            _cmon.stat_add(f"alerts/{self.name}/transitions", 1)
            _flight.record(f"alert_{ev}", name=self.name,
                           rule_kind=self.kind, metric=self.metric,
                           value=value, bound=self.bound)
        return ev

    def describe(self):
        d = {"name": self.name, "kind": self.kind,
             "metric": self.metric, "state": self.state,
             "value": self.value, "streak": self.streak,
             "fired": self.fired, "for": self.for_ticks,
             "clear": self.clear_ticks}
        if self.op is not None:
            d["op"], d["bound"] = self.op, self.bound
        if self.kind == "quantile":
            d["q"], d["min_n"] = self.q, self.min_n
        if self.kind in ("rate", "burn_rate"):
            d["window_s"] = self.window_s
        if self.kind == "burn_rate":
            d.update(long_s=self.long_s, budget=self.budget,
                     factor=self.factor, total=self.total)
        if self.kind == "fraction":
            d["of"] = self.of
        return d


def default_rules():
    """The serving rule pack (`PADDLE_ALERTS=serving`): the SLO
    signals serving measures, with production-shaped default bounds
    (override by spelling the rule out in the spec)."""
    return [
        AlertRule("serve/hist/ttft_us", "quantile", name="ttft_p99",
                  q=0.99, gt=500_000.0),
        AlertRule("serve/hist/itl_us", "quantile", name="itl_p99",
                  q=0.99, gt=100_000.0),
        AlertRule("serve/shed", "rate", name="shed_rate", gt=1.0,
                  window=60.0),
        AlertRule("serve/queue_depth", "threshold",
                  name="queue_depth", gt=64.0),
        AlertRule("serve/kv_blocks/free", "fraction",
                  name="kv_free_frac", of="serve/kv_blocks/used",
                  lt=0.1),
        # straggler persistence: a replica staying unhealthy across
        # 3 ticks (transient failover blips stay quiet)
        AlertRule("serve/replica/*/healthy", "threshold",
                  name="replica_unhealthy", lt=1.0, **{"for": 3}),
    ]


def parse_spec(spec):
    """`metric:kind[:param=value]*[;...]` -> [AlertRule]; the bare
    words serving/default/all/1/on/true expand to default_rules().
    Raises ValueError on anything unknown (loud, never silently
    misarmed)."""
    out = []
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        if part.lower() in _DEFAULT_WORDS:
            out.extend(default_rules())
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"alert rule {part!r} needs at least metric:kind")
        params = {}
        for field in fields[2:]:
            if "=" not in field:
                raise ValueError(
                    f"alert param {field!r} in {part!r} is not "
                    "key=value")
            k, v = field.split("=", 1)
            params[k.strip()] = v.strip()
        out.append(AlertRule(fields[0].strip(), fields[1].strip(),
                             **params))
    return out


# ---------------------------------------------------------------------------
# module state + evaluation
# ---------------------------------------------------------------------------

# _armed is the zero-overhead gate (a module attribute)
_rules: list = []
_armed = False
_spec = ""
_listeners: list = []
_evaluator = None
_lock = threading.Lock()


def armed():
    return _armed


def rules():
    with _lock:
        return list(_rules)


def add_listener(fn):
    """Register fn(rule, transition, value) for every
    fire/resolve — the Autoscaler's subscription point. Best-effort:
    listener exceptions count under alerts/listener_errors and never
    reach the evaluator loop."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)
    return fn


def remove_listener(fn):
    with _lock:
        try:
            _listeners.remove(fn)
        except ValueError:
            pass


def _notify(rule, transition, value):
    with _lock:
        fns = list(_listeners)
    for fn in fns:
        try:
            fn(rule, transition, value)
        except Exception:
            _cmon.stat_add("alerts/listener_errors", 1)


def evaluate_once(now=None):
    """One evaluation tick over every armed rule; returns the
    [(rule, "fire"/"resolve", value)] transitions. The evaluator
    thread calls this on its cadence; tests call it directly for
    deterministic ticks. Forces a flight-ring stat sync FIRST: the
    ring amortizes flight/* gauge pushes to every
    256th event, and an alert must see the gauge a record() just
    moved, not the value from 255 events ago."""
    if not _armed:
        return []
    now = time.monotonic() if now is None else now
    _flight.sync_stats()
    stats = _cmon.registry.snapshot()
    with _lock:
        live = list(_rules)
    out = []
    for rule in live:
        try:
            ev = rule._tick(stats, now)
        except Exception:
            _cmon.stat_add("alerts/eval_errors", 1)
            continue
        if ev is not None:
            out.append((rule, ev, rule.value))
    _cmon.stat_add("alerts/ticks", 1)
    for rule, ev, value in out:
        _notify(rule, ev, value)
    return out


class AlertEvaluator:
    """The background cadence: one daemon thread waking every
    `interval_s` to evaluate_once(). Exists ONLY while rules are
    armed (configure starts it, disarm joins it) — the disarmed
    process has no alert thread to find."""

    def __init__(self, interval_s=None):
        self.interval_s = (env_interval_s() if interval_s is None
                           else max(0.05, float(interval_s)))
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-alert-evaluator",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                evaluate_once()
            except Exception:
                # a torn registry mid-shutdown must not kill the
                # evaluator for the rest of the run — count and keep
                # ticking
                _cmon.stat_add("alerts/eval_errors", 1)


def configure(spec=None, rules=None, start=True, interval_s=None):
    """Arm the rules a spec (default: $PADDLE_ALERTS) and/or explicit
    AlertRule list describe. Replaces any previous configuration;
    empty/unset disarms. `start=False` arms without the evaluator
    thread (tests drive evaluate_once() deterministically). Returns
    the armed rule list."""
    global _rules, _armed, _spec, _evaluator
    if spec is None and rules is None:
        spec = os.environ.get("PADDLE_ALERTS", "")
    parsed = list(rules or [])
    if spec:
        parsed = parse_spec(spec) + parsed
    names = [r.name for r in parsed]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise ValueError(
            f"duplicate alert rule name(s) {sorted(dup)} — set "
            "name=<unique> on one of them")
    disarm()
    if not parsed:
        return []
    with _lock:
        _rules = parsed
        _armed = True
        _spec = str(spec) if spec else ""
    _cmon.stat_set("alerts/armed", len(parsed))
    for r in parsed:
        # publish the armed-but-ok shape (firing=0, transitions=0)
        # so the fleet rollup can tell "armed, quiet" from "alerts
        # never armed on this rank"
        _cmon.stat_set(f"alerts/{r.name}/firing", 0)
        _cmon.registry.get(f"alerts/{r.name}/transitions")
    _flight.record("alert_arm", spec=_spec or None,
                   rules=len(parsed), names=names)
    if start:
        with _lock:
            _evaluator = AlertEvaluator(interval_s).start()
    return parsed


def disarm():
    """Stop the evaluator thread and drop every rule. Zeroes the
    alerts/armed gauge only if arming ever created it (a disarmed run
    leaves no alerts/* stats)."""
    global _rules, _armed, _spec, _evaluator
    with _lock:
        ev, _evaluator = _evaluator, None
        _rules = []
        _armed = False
        _spec = ""
    if ev is not None:
        ev.stop()
    if "alerts/armed" in _cmon.registry._stats:
        _cmon.stat_set("alerts/armed", 0)


def describe():
    """JSON-able engine state: spec, cadence, every rule with its
    live pending/firing/resolved state."""
    with _lock:
        live = list(_rules)
        ev = _evaluator
    return {"armed": _armed, "spec": _spec or None,
            "interval_s": (ev.interval_s if ev is not None
                           else env_interval_s()),
            "evaluating": ev is not None and ev.running(),
            "rules": [r.describe() for r in live]}


# env-driven autostart: setting PADDLE_ALERTS is enough for any run
# importing this module to arm the rules. A bad spec counts under
# alerts/spec_errors and does not break the import.
if os.environ.get("PADDLE_ALERTS"):
    try:
        configure()
    except ValueError:
        _cmon.stat_add("alerts/spec_errors", 1)
