"""Shape manipulation: the port of `paddle_tpu/ops/manipulation.py`
`flatten` (:103-116)."""
from __future__ import annotations

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis..stop_axis merged into one; a 0-d tensor becomes
    shape [1]."""
    n = x.dim()
    if n == 0:
        return x.reshape(1)
    start, stop = start_axis % n, stop_axis % n
    return x.reshape(tuple(x.shape[:start]) + (-1,)
                     + tuple(x.shape[stop + 1:]))
