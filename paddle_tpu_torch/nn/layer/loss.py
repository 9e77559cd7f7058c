"""`CrossEntropyLoss`: the port of `paddle_tpu/nn/layer/loss.py`
(:17-37) for what the port's `cross_entropy` computes: hard labels,
`ignore_index`, a per-class `weight`, softmax over the last axis, and
the reductions "mean", "sum" and "none". `soft_label`,
`label_smoothing`, `use_softmax=False` and another axis raise
`NotImplementedError` (ROADMAP queue 1 item 7)."""
from __future__ import annotations

import torch.nn as nn

from .. import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        unported = {"soft_label": bool(soft_label),
                    "label_smoothing": label_smoothing != 0.0,
                    "use_softmax=False": not use_softmax,
                    f"reduction={reduction!r}":
                        reduction not in ("mean", "sum", "none"),
                    f"axis={axis}": axis != -1}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"CrossEntropyLoss: {', '.join(bad)} not ported; the port "
                "takes hard labels with ignore_index")
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction)
