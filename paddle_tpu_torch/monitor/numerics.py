"""paddle_tpu_torch.monitor.numerics — runtime numerics probe (PTA09x),
the port of `paddle_tpu/monitor/numerics.py` (:83-196).

Under `PADDLE_SANITIZE=numerics[:sample=N][:absmax=T]` the train step
(`jit.TrainStepCompiler`, armed at its first call) reduces per-tensor
stats over loss, grads and params — absmax over finite values,
smallest nonzero magnitude, non-finite count — with plain PyTorch
reductions on the step's device (the JAX probe is no Pallas kernel
either), and every Nth call the host reads them back (one transfer)
into:

  * gauges    numerics/<tree>/absmax (ceil), .../absmin_nonzero
  * counters  numerics/<tree>/saturated, .../nonfinite
  * histogram numerics/hist/absmax
  * findings  PTA092 via sanitize._emit, naming the offending tensor

Disarmed, the step computes nothing extra: it is bit-identical.
Params (spec or env): `sample=N` host-readback cadence (default
$PADDLE_NUMERICS_SAMPLE or 1), `absmax=T` saturation threshold
(default $PADDLE_NUMERICS_ABSMAX or 0.9*65504).

Dispatch-time findings REPORT (counters + flight + stderr), they never
raise; the build-time audits (PTA093) are the raising half, in
analysis/precision.py.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..core import monitor as _cmon
from . import sanitize as _sanitize

__all__ = ["armed", "sample_every", "absmax_threshold", "stats_tree",
           "observe", "describe", "clear"]

_FP16_MAX = 65504.0

# last host-read stats per tensor, bounded — dump-bundle section
_last: OrderedDict = OrderedDict()
_LAST_MAX = 256
_n_observed = 0
_lock = threading.Lock()


def armed():
    """Hot-path gate (one module-attribute read, the house rule)."""
    return _sanitize._numerics


def _param(name, env, default):
    opts = _sanitize._opts.get("numerics", {})
    if name in opts:
        return float(opts[name])
    raw = os.environ.get(env, "")
    try:
        return float(raw) if raw else float(default)
    except ValueError:
        return float(default)


def sample_every():
    """Host-readback cadence: observe() syncs every Nth call."""
    return max(1, int(_param("sample", "PADDLE_NUMERICS_SAMPLE", 1)))


def absmax_threshold():
    """|x| above this reports saturation risk (PTA092)."""
    return _param("absmax", "PADDLE_NUMERICS_ABSMAX",
                  0.9 * _FP16_MAX)


def _leaf_stats(x):
    """(3,) f32 [absmax over finite values, smallest nonzero finite
    magnitude (0 if none), non-finite count] of one tensor."""
    finite = torch.isfinite(x)
    a = x.float().abs()
    absmax = torch.where(finite, a, a.new_zeros(())).max()
    pos = torch.where(finite & (a > 0), a, a.new_full((), float("inf")))
    absmin = pos.min()
    absmin = torch.where(torch.isfinite(absmin), absmin,
                         absmin.new_zeros(()))
    nonfinite = (~finite).sum().to(torch.float32)
    return torch.stack([absmax, absmin, nonfinite])


def stats_tree(tree):
    """A (3,) f32 stats tensor per floating leaf of a nested
    dict/list/tuple tree, on the leaf's device — [absmax over finite
    values, smallest nonzero finite magnitude (0 if none), non-finite
    count]. Returns {joined/path: (3,) tensor}; empty and non-float
    leaves are skipped. Numpy leaves are taken as CPU tensors."""
    out = {}

    def leaf(path, x):
        if isinstance(x, (np.ndarray, np.generic)):
            x = torch.from_numpy(np.asarray(x))
        if not isinstance(x, torch.Tensor) or x.numel() == 0 \
                or not x.is_floating_point():
            return
        with torch.no_grad():
            out[path] = _leaf_stats(x.detach())

    def walk(path, obj):
        if isinstance(obj, dict):
            for k in sorted(obj):
                walk(f"{path}/{k}" if path else str(k), obj[k])
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{path}/{i}" if path else str(i), v)
        elif obj is not None:
            leaf(path, obj)

    walk("", tree)
    return out


def _to_host(stats):
    """{name: (n, 3) float32 ndarray}: the stats moved to the host in
    one transfer (a (K, 3) leaf stacks K microsteps)."""
    names = list(stats)
    vals = [stats[n] for n in names]
    if all(isinstance(v, torch.Tensor) for v in vals):
        rows = [v.reshape(-1, 3) for v in vals]
        flat = torch.cat(rows).to(torch.float32).cpu().numpy()
        out, i = {}, 0
        for n, r in zip(names, rows):
            out[n] = flat[i:i + r.shape[0]]
            i += r.shape[0]
        return out
    return {n: np.asarray(v, np.float32).reshape(-1, 3)
            for n, v in zip(names, vals)}


def observe(stats, where="train_step", step=0):
    """Host leg: reduce one dispatch's stats (leaves may be (3,) or
    stacked (K, 3) over K microsteps) into gauges/counters/findings.
    Applies the `sample=N` cadence internally — callers invoke it
    every dispatch, the sync happens every Nth. Returns the reduced
    {name: (absmax, absmin_nonzero, nonfinite)} dict on sampled
    calls, None on skipped ones."""
    global _n_observed
    if not stats:
        return None
    with _lock:
        _n_observed += 1
        n = _n_observed
    if (n - 1) % sample_every():
        return None
    thr = absmax_threshold()
    reduced = {}
    for name, arr in _to_host(stats).items():
        absmax = float(arr[:, 0].max())
        mins = arr[:, 1][arr[:, 1] > 0]
        absmin = float(mins.min()) if mins.size else 0.0
        nonfinite = int(arr[:, 2].sum())
        reduced[name] = (absmax, absmin, nonfinite)
        _cmon.stat_set(f"numerics/{name}/absmax",
                       int(np.ceil(absmax)))
        _cmon.hist_observe("numerics/hist/absmax", absmax)
        if nonfinite:
            _cmon.stat_add(f"numerics/{name}/nonfinite", nonfinite)
            _sanitize._emit(
                "PTA092",
                f"{where} step {step}: {nonfinite} non-finite "
                f"value(s) in tensor '{name}' (absmax of the finite "
                f"part {absmax:.6g}) — the overflow originates HERE, "
                "not merely in the skipped step",
                dedup=f"numerics:nonfinite:{name}")
        elif absmax > thr:
            _cmon.stat_add(f"numerics/{name}/saturated", 1)
            _sanitize._emit(
                "PTA092",
                f"{where} step {step}: tensor '{name}' absmax "
                f"{absmax:.6g} exceeds the saturation threshold "
                f"{thr:.6g} — headed for fp16 overflow (max "
                f"{_FP16_MAX:g}); rescale or keep it in f32",
                dedup=f"numerics:saturated:{name}")
    with _lock:
        for name, vals in reduced.items():
            _last[name] = {"absmax": vals[0],
                           "absmin_nonzero": vals[1],
                           "nonfinite": vals[2], "step": int(step)}
            _last.move_to_end(name)
        while len(_last) > _LAST_MAX:
            _last.popitem(last=False)
    return reduced


def describe():
    """JSON-able snapshot for flight dump bundles: what the probe was
    watching and the freshest per-tensor stats when the incident
    hit."""
    with _lock:
        last = {k: dict(v) for k, v in _last.items()}
        n = _n_observed
    return {"armed": bool(_sanitize._numerics),
            "sample": sample_every() if _sanitize._numerics else None,
            "absmax_threshold": (absmax_threshold()
                                 if _sanitize._numerics else None),
            "observations": n, "last": last}


def clear():
    """Reset observation state (tests)."""
    global _n_observed
    with _lock:
        _last.clear()
        _n_observed = 0
