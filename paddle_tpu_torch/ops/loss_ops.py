"""Losses: the port of `paddle_tpu/ops/loss_ops.py` `cross_entropy`
and `softmax_with_cross_entropy` for hard labels (`_k_softmax_ce`,
:36-55): log-softmax in f32, the label's entry gathered with the label
clipped into range, entries whose label equals `ignore_index` masked to
0. `cross_entropy` takes a per-class `weight` (each kept entry scaled
by its label's weight) and the reductions "mean" (the sum over the
kept weight, or over the number of kept labels, at least 1, without
`weight`), "sum" and "none". Soft labels, label smoothing,
`use_softmax=False` and another axis raise `NotImplementedError`
(ROADMAP queue 1 item 7).
`softmax_with_cross_entropy` keeps every entry (reduction "none") with
a size-1 class axis, as the JAX op returns it (:58-72)."""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _token_losses(input, label, ignore_index):
    """(per-entry loss, kept mask) over the last axis, in f32."""
    lsm = torch.log_softmax(input.float(), dim=-1)
    lbl = label
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(-1)
    idx = lbl.clamp(0, input.shape[-1] - 1).long().unsqueeze(-1)
    loss = -torch.gather(lsm, -1, idx).squeeze(-1)
    keep = lbl != ignore_index
    return torch.where(keep, loss, torch.zeros_like(loss)), keep


def _unported(fn, **flags):
    bad = [k for k, v in flags.items() if v]
    if bad:
        raise NotImplementedError(
            f"{fn}: {', '.join(bad)} not ported; the port takes hard "
            "labels over the last axis")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy of logits `input` against integer labels
    over the last axis (the label tensor may keep a size-1 class
    axis)."""
    _unported("cross_entropy", soft_label=bool(soft_label),
              label_smoothing=label_smoothing != 0.0,
              **{"use_softmax=False": not use_softmax,
                 f"axis={axis}": axis not in (-1, input.dim() - 1),
                 f"reduction={reduction!r}":
                     reduction not in ("mean", "sum", "none")})
    input, label = maybe_cast_inputs("cross_entropy", (input, label))
    loss, keep = _token_losses(input, label, ignore_index)
    if weight is not None:
        lbl = label.squeeze(-1) if label.dim() == input.dim() else label
        wsel = weight.float()[lbl.clamp(0, weight.shape[0] - 1).long()]
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / torch.where(
                keep, wsel, torch.zeros_like(wsel)).sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / keep.sum().clamp_min(1)
    return loss.sum() if reduction == "sum" else loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Softmax cross-entropy of each entry of `logits` against its
    integer label over the last axis, with a size-1 last axis; an entry
    whose label is `ignore_index` is 0."""
    _unported("softmax_with_cross_entropy", soft_label=bool(soft_label),
              return_softmax=bool(return_softmax),
              **{f"axis={axis}": axis not in (-1, logits.dim() - 1)})
    logits, label = maybe_cast_inputs("softmax_with_cross_entropy",
                                      (logits, label))
    loss, _ = _token_losses(logits, label, ignore_index)
    return loss.unsqueeze(-1)
