"""Losses: the port of `paddle_tpu/ops/loss_ops.py` `cross_entropy`
for hard labels (`_k_softmax_ce`, :36-55): log-softmax in f32, the
label's entry gathered with the label clipped into range, entries whose
label equals `ignore_index` masked to 0, and the sum divided by the
number of kept labels (at least 1): the "mean" reduction over the last
axis, the only one the port's models use."""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100):
    """Mean softmax cross-entropy of logits `input` against integer
    labels over the last axis (the label tensor may keep a size-1 class
    axis)."""
    input, label = maybe_cast_inputs("cross_entropy", (input, label))
    lsm = torch.log_softmax(input.float(), dim=-1)
    lbl = label
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(-1)
    idx = lbl.clamp(0, input.shape[-1] - 1).long().unsqueeze(-1)
    loss = -torch.gather(lsm, -1, idx).squeeze(-1)
    keep = lbl != ignore_index
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    return loss.sum() / keep.sum().clamp_min(1)
