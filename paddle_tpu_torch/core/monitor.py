"""Process-wide stat counters and histograms for the serving and
training paths (reference: paddle/fluid/platform/monitor.h:44
StatValue/StatRegistry with STAT_ADD:130).

A copy of the part of `paddle_tpu.core.monitor` that the serving and
training code uses — `stat_add`, `stat_set`, `stat_get`,
`hist_observe`, `registry.snapshot()`, the `_env_*` readers — so the
`serve/*`, `jit/*`, `train/nonfinite_skips`, `amp/scale/*` and `ckpt/*`
counters keep their names.
The JAX package's fleet merge, windowed deltas and PJRT memory readers
are not carried over, nor histogram quantiles and the env knobs of the
bucket layout: nothing in the port reads a quantile yet.
"""
from __future__ import annotations

import math
import os
import threading

__all__ = ["StatValue", "StatRegistry", "Histogram", "stat_add",
           "stat_get", "stat_set", "hist_observe", "hist_get",
           "registry"]


class StatValue:
    """Monotonic int counter (monitor.h:44), with a gauge-style set."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def increase(self, n=1):
        with self._lock:
            self._v += n
            return self._v

    def set(self, n):
        with self._lock:
            self._v = n
            return self._v

    def get(self):
        with self._lock:
            return self._v


# bucket layout of every histogram: microsecond latencies from 1 us to
# 1e9 us at 20 buckets per decade (~12% resolution)
_HIST_LO = 1.0
_HIST_PER_DECADE = 20
_HIST_DECADES = 9
_HIST_BUCKETS = _HIST_PER_DECADE * _HIST_DECADES


class Histogram:
    """Thread-safe value distribution over FIXED log-spaced buckets.

    Bucket i (1-based) covers (lo*10^((i-1)/per_decade),
    lo*10^(i/per_decade)]; bucket 0 is the underflow bin (values <= lo)
    and the last bucket catches overflow."""

    __slots__ = ("name", "_counts", "_count", "_sum", "_lock")

    def __init__(self, name=""):
        self.name = name
        self._counts = [0] * (_HIST_BUCKETS + 2)  # [under, b1..bn, over]
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    @staticmethod
    def _index(v):
        if v <= _HIST_LO:
            return 0
        i = int(math.log10(v / _HIST_LO) * _HIST_PER_DECADE)
        return min(_HIST_BUCKETS + 1, i + 1)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._counts[self._index(v)] += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum


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

    def histogram(self, name) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(name)
            return self._hists[name]

    def snapshot(self):
        """Point-in-time {name: int} copy of every stat."""
        with self._lock:
            stats = list(self._stats.items())
        return {k: v.get() for k, v in stats}


registry = StatRegistry()


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


def stat_add(name, n=1):
    """STAT_ADD analog (monitor.h:130)."""
    return registry.get(name).increase(n)


def stat_set(name, n):
    """Gauge write: overwrite the stat with `n`."""
    return registry.get(name).set(n)


def stat_get(name):
    return registry.get(name).get()


def hist_observe(name, value):
    """One observation into the named process-wide Histogram."""
    registry.histogram(name).observe(value)


def hist_get(name) -> Histogram:
    return registry.histogram(name)
