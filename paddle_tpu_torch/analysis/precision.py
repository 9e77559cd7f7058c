"""The runtime precision audits of `paddle_tpu/analysis/precision.py`
(:270-335): PTA093 at the train step's first call and PTA092 at
`amp.auto_cast` entry. Under PADDLE_SANITIZE=numerics a finding
raises ValueError, under PADDLE_ANALYSIS=1 it reports (counters, a
flight event, stderr), and disarmed nothing happens."""
from __future__ import annotations

__all__ = ["audit_train_precision", "audit_autocast"]


def _emit_or_raise(code, msg):
    from ..monitor import sanitize as _sanitize

    armed = _sanitize._numerics
    if not armed:
        from . import enabled as _analysis_enabled

        if not _analysis_enabled():
            return False
    _sanitize._emit(code, msg)
    if armed:
        raise ValueError(f"{code} {msg}")
    return True


def audit_train_precision(param_dtypes, grad_scaler, multi_precision,
                          where="train_step"):
    """PTA093: float16 trainable parameters stepped with neither a
    GradScaler (gradients underflow unscaled) nor fp32 master weights
    (updates below the fp16 ulp are lost). bfloat16 is exempt.
    `param_dtypes` maps parameter names to dtype names ("float16")."""
    fp16 = sorted(n for n, dt in param_dtypes.items()
                  if dt == "float16")
    if not fp16 or grad_scaler is not None or multi_precision:
        return False
    return _emit_or_raise(
        "PTA093",
        f"{where}: {len(fp16)} float16 trainable parameter(s) (e.g. "
        f"{fp16[0]!r}) trained without a GradScaler or fp32 master "
        "weights — gradients underflow unscaled and sub-ulp updates "
        "vanish; pass grad_scaler=GradScaler() or "
        "optimizer(multi_precision=True)")


def audit_autocast(dtype, custom_white_list, where="auto_cast"):
    """PTA092: a float16 autocast whose custom_white_list force-lowers
    range-sensitive (BLACK_LIST) ops."""
    if str(dtype) not in ("float16", "fp16"):
        return False
    from .. import amp as _amp

    risky = sorted(set(custom_white_list or ()) & _amp.BLACK_LIST)
    if not risky:
        return False
    return _emit_or_raise(
        "PTA092",
        f"{where}: float16 autocast white-lists range-sensitive "
        f"op(s) {risky} — e^x saturates float16 past x≈11; keep "
        "exp/softmax/norm statistics out of the fp16 white list")
