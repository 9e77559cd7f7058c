"""Losses: the port of `paddle_tpu/ops/loss_ops.py` `cross_entropy`
and `softmax_with_cross_entropy` for hard labels (`_k_softmax_ce`,
:36-55): log-softmax in f32, the label's entry gathered with the label
clipped into range, entries whose label equals `ignore_index` masked to
0. `cross_entropy` divides the sum by the number of kept labels (at
least 1): the "mean" reduction over the last axis.
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


def cross_entropy(input, label, ignore_index=-100):
    """Mean softmax cross-entropy of logits `input` against integer
    labels over the last axis (the label tensor may keep a size-1 class
    axis)."""
    input, label = maybe_cast_inputs("cross_entropy", (input, label))
    loss, keep = _token_losses(input, label, ignore_index)
    return loss.sum() / keep.sum().clamp_min(1)


def softmax_with_cross_entropy(logits, label, ignore_index=-100):
    """Softmax cross-entropy of each entry of `logits` against its
    integer label over the last axis, with a size-1 last axis; an entry
    whose label is `ignore_index` is 0."""
    logits, label = maybe_cast_inputs("softmax_with_cross_entropy",
                                      (logits, label))
    loss, _ = _token_losses(logits, label, ignore_index)
    return loss.unsqueeze(-1)
