"""Process-wide stat counters and histograms for the serving and
training paths (reference: paddle/fluid/platform/monitor.h:44
StatValue/StatRegistry with STAT_ADD:130).

A copy of `paddle_tpu.core.monitor` without its PJRT memory readers
(the card's are `monitor.memory`): `stat_add`, `stat_set`, `stat_get`, `stat_reset`, the
mergeable `Histogram` with `quantile`, `merge`, `snapshot`,
`delta_since` and `reset`, `snapshot_quantile` over a snapshot,
`registry.snapshot()` / `snapshot_histograms()` / `reset_all()`, the
`_env_*` readers and `VLOG` (stderr, enabled by GLOG_v). The bucket layout is the JAX package's, with its
`PADDLE_MONITOR_HIST_LO` / `_PER_DECADE` / `_DECADES` knobs, so a
quantile here is bit-equal to the JAX one on the same observations.
Quantiles are read by the alert engine (`monitor.alerts`, whose
`ttft_p99` rule drives the serving `Autoscaler`) and by `chip_smoke.py`.
The `serve/*`, `jit/*`, `train/nonfinite_skips`, `amp/scale/*` and
`ckpt/*` counters keep the JAX package's names.
"""
from __future__ import annotations

import math
import os
import sys
import threading
import time

__all__ = ["StatValue", "StatRegistry", "Histogram", "stat_add",
           "stat_get", "stat_set", "stat_reset", "hist_observe",
           "hist_get", "snapshot_quantile", "registry", "VLOG",
           "vlog_level"]


class StatValue:
    """Monotonic int counter (monitor.h:44)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def increase(self, n=1):
        with self._lock:
            self._v += n
            return self._v

    def decrease(self, n=1):
        return self.increase(-n)

    def set(self, n):
        """Gauge-style overwrite (step time, memory high-water)."""
        with self._lock:
            self._v = n
            return self._v

    def maximum(self, n):
        """Keep the high-water mark (peak device memory)."""
        with self._lock:
            if n > self._v:
                self._v = n
            return self._v

    def reset(self):
        with self._lock:
            self._v = 0

    def get(self):
        with self._lock:
            return self._v


# the env-knob parsers: monitor.flight aliases these, so the shared
# copy lives here at the bottom of the import graph
def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_on(name, default=True):
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")


class Histogram:
    """Thread-safe, mergeable value distribution over FIXED log-spaced
    bucket boundaries (the latency axis the int counters
    cannot carry: p50/p99/p999 of step time, inter-token latency,
    compile time).

    Bucket i (1-based) covers (lo*10^((i-1)/per_decade),
    lo*10^(i/per_decade)]; bucket 0 is the underflow bin (values <=
    lo, including <= 0) and the last bucket catches overflow. The
    boundaries are a pure function of (lo, per_decade, decades), so
    two histograms built with the same config — in different threads,
    processes or ranks — merge by adding bucket counts
    (associatively; the fleet aggregator relies on this). Defaults
    are tuned for microsecond latencies (1 us .. 1e9 us = ~17 min)
    at ~12% bucket resolution; PADDLE_MONITOR_HIST_LO /
    _PER_DECADE / _DECADES override process-wide.

    `quantile(q)` ranks like the sorted-list convention
    `sorted(v)[min(n-1, int(n*q))]` and log-interpolates inside the
    winning bucket, clamped to the exact observed [min, max] — so
    histogram-derived p50/p99 agree with sorted-list math to within
    one bucket's resolution.
    Exact sum/count/min/max ride alongside the buckets; snapshot()
    is taken under the lock, so a concurrent reader can never see a
    torn view (sum of buckets != count)."""

    __slots__ = ("name", "lo", "per_decade", "decades", "_nb",
                 "_counts", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name="", lo=None, per_decade=None,
                 decades=None):
        self.name = name
        self.lo = float(lo if lo is not None else
                        _env_float("PADDLE_MONITOR_HIST_LO", 1.0))
        self.per_decade = max(1, int(
            per_decade if per_decade is not None else
            _env_int("PADDLE_MONITOR_HIST_PER_DECADE", 20)))
        self.decades = max(1, int(
            decades if decades is not None else
            _env_int("PADDLE_MONITOR_HIST_DECADES", 9)))
        if self.lo <= 0:
            raise ValueError(f"histogram lo must be > 0, got {self.lo}")
        self._nb = self.per_decade * self.decades
        self._counts = [0] * (self._nb + 2)  # [under, b1..bn, over]
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def _bounds(self):
        return (self.lo, self.per_decade, self.decades)

    def _edge(self, i):
        """Upper boundary of bucket i (i=0 -> lo itself)."""
        return self.lo * 10.0 ** (i / self.per_decade)

    def _index(self, v):
        if v <= self.lo:
            return 0
        i = int(math.log10(v / self.lo) * self.per_decade)
        # float round-down at an exact edge: log10 can land a hair
        # under the integer — the half-open (lower, upper] contract
        # only needs v <= upper, which `int()+1` preserves either way
        return min(self._nb + 1, i + 1)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._counts[self._index(v)] += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def reset(self):
        with self._lock:
            self._counts = [0] * (self._nb + 2)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def merge(self, other):
        """Fold `other`'s observations into self (bucket-add). Both
        histograms must share bucket boundaries — merging across
        configs would silently mislabel every count."""
        if isinstance(other, Histogram):
            with other._lock:
                osnap = (other._bounds(), list(other._counts),
                         other._count, other._sum, other._min,
                         other._max)
        else:  # snapshot dict (cross-process / fleet merge)
            osnap = (_snap_bounds(other), _snap_counts(other),
                     int(other.get("count", 0)),
                     float(other.get("sum", 0.0)),
                     _snap_min(other), _snap_max(other))
        bounds, counts, cnt, tot, mn, mx = osnap
        if bounds != self._bounds():
            raise ValueError(
                f"cannot merge histograms with different bucket "
                f"boundaries: {bounds} vs {self._bounds()}")
        with self._lock:
            for i, c in enumerate(counts):
                if c:
                    self._counts[i] += c
            self._count += cnt
            self._sum += tot
            if mn < self._min:
                self._min = mn
            if mx > self._max:
                self._max = mx
        return self

    def quantile(self, q, empty=0.0):
        """Approximate q-quantile (0 <= q <= 1): the sorted-list rank
        `min(n-1, int(n*q))`, log-interpolated within its bucket and
        clamped to the observed [min, max]. `empty` (default 0.0 for
        the legacy display callers) is returned when the histogram
        holds no observations — alert evaluation passes None so an
        empty traffic window reads "no data", never a fake 0us p99."""
        with self._lock:
            return _quantile_locked(
                self._counts, self._count, self._min, self._max,
                self.lo, self.per_decade, q, empty=empty)

    def snapshot(self):
        """Consistent JSON-ready copy: exact count/sum/min/max plus
        the non-zero buckets (sparse {index: count}), taken under the
        lock so sum(buckets) == count always holds."""
        with self._lock:
            buckets = {i: c for i, c in enumerate(self._counts) if c}
            return {
                "count": self._count,
                "sum": self._sum,
                "min": None if self._count == 0 else self._min,
                "max": None if self._count == 0 else self._max,
                "lo": self.lo,
                "per_decade": self.per_decade,
                "decades": self.decades,
                "buckets": buckets,
            }

    def delta_since(self, snap):
        """Windowed view: the observations recorded since
        `snap` — an earlier snapshot() of THIS histogram — as a
        snapshot-shaped dict, so cumulative buckets cannot mask a
        recent regression (a week of healthy p99 would otherwise
        outvote the last minute's storm). Bucket counts, count and
        sum subtract exactly; the window's true min/max are NOT
        recoverable from two cumulative readings, so they come back
        None and snapshot_quantile resolves edge buckets against the
        bucket boundaries instead (all-underflow windows return its
        `empty` sentinel). `snap=None` means "since
        forever" (the full cumulative view, exact min/max included).
        A reset() between the two readings shows up as negative
        deltas — the window restarts at the reset, so the CURRENT
        cumulative state IS the window. Raises ValueError when `snap`
        was taken under different bucket boundaries."""
        if snap is None:
            return self.snapshot()
        if _snap_bounds(snap) != self._bounds():
            raise ValueError(
                f"delta_since: snapshot boundaries "
                f"{_snap_bounds(snap)} != {self._bounds()}")
        old = _snap_counts(snap)
        with self._lock:
            counts = [c - o for c, o in zip(self._counts, old)]
            count = self._count - int(snap.get("count", 0))
            total = self._sum - float(snap.get("sum", 0.0))
            if count < 0 or any(c < 0 for c in counts):
                counts = list(self._counts)
                count = self._count
                total = self._sum
        return {
            "count": count,
            "sum": total,
            "min": None,
            "max": None,
            "lo": self.lo,
            "per_decade": self.per_decade,
            "decades": self.decades,
            "buckets": {i: c for i, c in enumerate(counts) if c},
        }


def _snap_bounds(snap):
    return (float(snap["lo"]), int(snap["per_decade"]),
            int(snap["decades"]))


def _snap_counts(snap):
    nb = int(snap["per_decade"]) * int(snap["decades"])
    counts = [0] * (nb + 2)
    for k, c in (snap.get("buckets") or {}).items():
        counts[int(k)] = int(c)  # JSON round-trips keys as strings
    return counts


def _snap_min(snap):
    v = snap.get("min")
    return math.inf if v is None else float(v)


def _snap_max(snap):
    v = snap.get("max")
    return -math.inf if v is None else float(v)


def _quantile_locked(counts, count, vmin, vmax, lo, per_decade, q,
                     empty=0.0):
    """The edge contract: `empty` comes back for a window
    with no observations AND for a rank landing in the underflow
    bucket of a windowed delta (min/max unknown — reporting `lo`
    there would be a fake p99); an overflow rank without a known max
    degrades to the top bucket edge, an honest LOWER bound (masking
    an over-range p99 behind the sentinel would hide exactly the
    regressions alerting exists to catch)."""
    if count <= 0:
        return empty
    q = min(1.0, max(0.0, float(q)))
    nb = len(counts) - 2
    # rank matches sorted(v)[min(n-1, int(n*q))] (1-based rank)
    target = min(count, int(count * q) + 1)
    cum = 0
    for idx, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= target:
            if idx == 0:            # underflow: everything <= lo
                return vmin if math.isfinite(vmin) else empty
            if idx == nb + 1:       # overflow
                return vmax if math.isfinite(vmax) else \
                    lo * 10.0 ** (nb / per_decade)
            lower = lo * 10.0 ** ((idx - 1) / per_decade)
            upper = lo * 10.0 ** (idx / per_decade)
            frac = (target - cum) / c
            val = lower * (upper / lower) ** frac
            if math.isfinite(vmin):
                val = max(val, vmin)
            if math.isfinite(vmax):
                val = min(val, vmax)
            return val
        cum += c
    return vmax if math.isfinite(vmax) else \
        lo * 10.0 ** (nb / per_decade)


def snapshot_quantile(snap, q, empty=0.0):
    """quantile(q) over a Histogram.snapshot() (or delta_since())
    dict — the offline flavor the alert engine uses on spooled/windowed
    histograms. `empty` is the no-data sentinel (see Histogram
    .quantile)."""
    return _quantile_locked(
        _snap_counts(snap), int(snap.get("count", 0)),
        _snap_min(snap), _snap_max(snap), float(snap["lo"]),
        int(snap["per_decade"]), q, empty=empty)


class StatRegistry:
    def __init__(self):
        self._stats = {}
        self._hists = {}
        self._lock = threading.Lock()

    def get(self, name) -> StatValue:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = StatValue(name)
            return self._stats[name]

    def histogram(self, name, **kwargs) -> Histogram:
        """Get-or-create the named Histogram (kept BESIDE the int
        stats: snapshot() stays a flat {name: int} map for every
        existing consumer; histogram summaries travel separately via
        snapshot_histograms() / telemetry_snapshot()["hists"])."""
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(name, **kwargs)
            return self._hists[name]

    def snapshot(self):
        """Consistent point-in-time copy of every stat, taken under the
        registry lock (the exporter's read path)."""
        with self._lock:
            stats = list(self._stats.items())
        return {k: v.get() for k, v in stats}

    def snapshot_histograms(self):
        """{name: Histogram.snapshot()} for every registered
        histogram — each snapshot internally consistent (taken under
        its histogram's lock)."""
        with self._lock:
            hists = list(self._hists.items())
        return {k: h.snapshot() for k, h in hists}

    def reset_all(self):
        """Zero every registered stat, holding the registry lock while
        collecting the stat list (stat_reset(None) previously iterated
        `_stats` unlocked and could miss/clash with concurrent get())."""
        with self._lock:
            stats = list(self._stats.values())
            hists = list(self._hists.values())
        for v in stats:
            v.reset()
        for h in hists:
            h.reset()

    def all(self):
        return self.snapshot()


registry = StatRegistry()


def stat_add(name, n=1):
    """STAT_ADD analog (monitor.h:130)."""
    return registry.get(name).increase(n)


def stat_set(name, n):
    """Gauge write: overwrite the stat with `n`."""
    return registry.get(name).set(n)


def stat_get(name):
    return registry.get(name).get()


def stat_reset(name=None):
    if name is None:
        registry.reset_all()
    else:
        registry.get(name).reset()


def hist_observe(name, value):
    """One observation into the named process-wide Histogram (the
    STAT_ADD analog for distributions)."""
    registry.histogram(name).observe(value)


def hist_get(name) -> Histogram:
    return registry.histogram(name)


def vlog_level():
    """Effective verbosity: the GLOG_v env (0 when unset)."""
    try:
        return int(os.environ.get("GLOG_v", "0"))
    except ValueError:
        return 0


def VLOG(level, *msg):
    """glog VLOG(level) << ... analog on stderr, the JAX package's
    prefix: `V<level> HH:MM:SS]`, with ` r<rank>` when the launch env
    names a world of more than one rank."""
    if level <= vlog_level():
        ts = time.strftime("%H:%M:%S")
        try:
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        except ValueError:
            world, rank = 1, 0
        if world > 1:
            print(f"V{level} r{rank} {ts}]", *msg, file=sys.stderr)
        else:
            print(f"V{level} {ts}]", *msg, file=sys.stderr)
