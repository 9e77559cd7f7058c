"""Global flags: the port of `paddle_tpu/core/flags.py` (:16-77), with
the two flags the port reads, `stable_bn_stats` and `default_dtype`.

Flags are plain Python values read when an op is called; the
environment variable `FLAGS_<name>` seeds each at import ("1", "true",
"yes" or "on" for a boolean), as the JAX package's `_env` does.
`set_flags` takes names with or without the `FLAGS_` prefix.

- `stable_bn_stats`: BatchNorm's training statistics in the two-pass
  form (the variance of x - mean) instead of the default one-pass
  E[x^2] - E[x]^2, which cancels when |mean| >> std
  (`ops/norm_ops.batch_norm`).
- `default_dtype`: the float dtype of creation and random ops given no
  dtype, and of `to_tensor` on float data ("float32";
  `framework.set_default_dtype`).
"""
from __future__ import annotations

import os
import threading

__all__ = ["get_flag", "get_flags", "set_flags"]

_lock = threading.RLock()


def _env(name, default, cast):
    raw = os.environ.get("FLAGS_" + name)
    if raw is None:
        return default
    try:
        if cast is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        return cast(raw)
    except (TypeError, ValueError):
        return default


_FLAGS = {
    "stable_bn_stats": _env("stable_bn_stats", False, bool),
    "default_dtype": _env("default_dtype", "float32", str),
}


def get_flag(name):
    with _lock:
        if name not in _FLAGS:
            raise KeyError(f"Unknown flag: {name}")
        return _FLAGS[name]


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    with _lock:
        return {n: _FLAGS[n] for n in names}


def set_flags(flags: dict):
    with _lock:
        for k, v in flags.items():
            key = k[6:] if k.startswith("FLAGS_") else k
            _FLAGS[key] = v
