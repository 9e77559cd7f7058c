"""paddle_tpu_torch.metric, the port of `paddle_tpu/metric/__init__.py`
(:16-168; reference: python/paddle/metric/metrics.py): `Metric`,
`Accuracy`, `Precision`, `Recall`, `Auc`, `accuracy`.

Metrics accumulate on the host in numpy, as in the JAX package: their
inputs are torch tensors (on any device; bf16 is read as f32) or numpy
arrays. `Accuracy.compute` and `accuracy` return CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np[..., 0] if label_np.shape[-1] == 1 else \
                np.argmax(label_np, axis=-1)
        correct = (idx == label_np[..., None]).astype(np.float32)
        return torch.from_numpy(correct)

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0]
        accs = []
        for k in self.topk:
            corr_k = c[..., :k].sum()
            self.total[self.topk.index(k)] += corr_k
            self.count[self.topk.index(k)] += num
            accs.append(corr_k / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lb = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lb == 1)).sum())
        self.fp += int(((p == 1) & (lb == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lb = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lb == 1)).sum())
        self.fn += int(((p == 0) & (lb == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lb = _np(labels).reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        for b, y in zip(bins, lb):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds descending
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    pred = _np(input)
    lb = _np(label).reshape(-1)
    idx = np.argsort(-pred, axis=-1)[:, :k]
    correct_n = (idx == lb[:, None]).any(axis=1).mean()
    return torch.tensor(np.float32(correct_n))
