"""`CrossEntropyLoss`: the port of `paddle_tpu/nn/layer/loss.py`
(:17-37) for what the port's `cross_entropy` computes: hard labels,
`ignore_index`, softmax over the last axis, the mean over the kept
labels. `weight`, `soft_label`, `label_smoothing`, `use_softmax=False`,
another axis and reductions other than "mean" raise
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
        unported = {"weight": weight is not None,
                    "soft_label": bool(soft_label),
                    "label_smoothing": label_smoothing != 0.0,
                    "use_softmax=False": not use_softmax,
                    f"reduction={reduction!r}": reduction != "mean",
                    f"axis={axis}": axis != -1}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"CrossEntropyLoss: {', '.join(bad)} not ported; the port "
                "takes hard labels with ignore_index and the mean")
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self.ignore_index)
