"""bench_resnet50_pipeline's CPU config (`bench.py:319-470` with on_tpu
false: ResNet-50 f32, Momentum(0.01, 0.9), B 2 x 3x32x32, bench's
`_SynthImageNet`, 1 warm-up step and 2 more) fed by the port's worker
pool, held against the same batches fed in process and against the JAX
package; and `summary` / `flops` on ResNet-50 against the JAX package's.

The JAX ResNet-50 (1000 classes) is built once for the module and its
weights carried into the port by `convert.load_reference_state_dict`.

- The pipeline-fed losses (as bits) and every parameter and buffer
  after the last step equal the in-process feed's bit for bit, on
  bench's data (one image repeated) and on images that differ by index
  (at 64², where the last stage's BatchNorms see 4 values a channel: at
  32² they see 2, and the port's loss runs off to 7e5 and NaN by the
  third step on that data).
- The first loss (no update yet) equals JAX's within 1e-4 relative,
  `tests/test_torch_vision.py`'s bound for ResNet-50's losses (training
  mode BatchNorm on a fresh network; measured 2.1e-6 here). The JAX
  package's compiled step turns the second loss NaN at this config, the
  port's stays finite (ROADMAP queue 3 #39); the test holds both.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim
from paddle_tpu.hapi import flops as jflops
from paddle_tpu.hapi import summary as jsummary
from paddle_tpu.jit import TrainStepCompiler as JStep
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as poptim
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.hapi import Model as PModel
from paddle_tpu_torch.hapi import flops as pflops
from paddle_tpu_torch.hapi import summary as psummary
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.jit import TrainStepCompiler
from paddle_tpu_torch.vision import models as pmodels

BATCH, SIZE = 2, 32                      # bench.py:351-352, on_tpu false
N_LOADER, WARM = 4, 1                    # bench.py:380-381
STEPS = 1 + 2                            # warm-up 1, one window of 2


class SynthImageNet:
    """bench.py's `_SynthImageNet` (:300-316)."""

    def __init__(self, n, size):
        rng = np.random.RandomState(0)
        self.n = n
        self.base = rng.randn(3, size, size).astype(np.float32)
        self.labels = rng.randint(0, 1000, (n,)).astype(np.int64)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.base, self.labels[i]


class IndexedImages(SynthImageNet):
    def __getitem__(self, i):
        return self.base + np.float32(i * 1e-3), self.labels[i]


@pytest.fixture(scope="module")
def resnet50_jax():
    paddle.seed(0)
    jm = jmodels.resnet50()
    return jm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _port_run(flat, ds, **loader_kw):
    pm = pmodels.resnet50(device="cpu")
    load_reference_state_dict(pm, flat)
    ce = pnn.CrossEntropyLoss()
    opt = poptim.Momentum(learning_rate=0.01, momentum=0.9,
                          parameters=pm.named_parameters())
    step = TrainStepCompiler(pm, opt, lambda o, y: ce(o, y))
    loader = DataLoader(ds, batch_size=BATCH, drop_last=True, device="cpu",
                        **loader_kw)
    losses = []
    try:
        it = iter(loader)
        for _ in range(STEPS):
            x, y = next(it)
            losses.append(float(step(x, y)))
        it.close()
    finally:
        if loader._mp_loader is not None:
            loader._mp_loader.shutdown()
    return losses, [t.clone() for t in pm.state_dict().values()]


PIPELINE = dict(num_workers=-1, use_shared_memory=True,
                persistent_workers=True, prefetch_to_device=2)


@pytest.mark.parametrize("data,size", [("bench", SIZE), ("indexed", 64)])
def test_pipeline_fed_equals_in_process_feed(resnet50_jax, data, size,
                                             monkeypatch):
    monkeypatch.setenv("PADDLE_IO_WORKERS", "2")
    _, flat = resnet50_jax
    make = SynthImageNet if data == "bench" else IndexedImages
    fed = _port_run(flat, make((N_LOADER + WARM) * BATCH, size), **PIPELINE)
    ref = _port_run(flat, make((N_LOADER + WARM) * BATCH, size),
                    num_workers=0, prefetch_to_device=0)
    assert np.array(fed[0]).tobytes() == np.array(ref[0]).tobytes()
    assert all(np.isfinite(fed[0])), fed[0]
    assert len(fed[1]) == len(ref[1]) == 267
    assert all(torch.equal(a, b) for a, b in zip(fed[1], ref[1]))


def test_pipeline_first_loss_matches_jax(resnet50_jax, monkeypatch):
    monkeypatch.setenv("PADDLE_IO_WORKERS", "2")
    jm, flat = resnet50_jax
    ds = SynthImageNet((N_LOADER + WARM) * BATCH, SIZE)
    got, _ = _port_run(flat, ds, **PIPELINE)
    jm.set_state_dict(flat)
    jm.train()
    ce = jnn.CrossEntropyLoss()
    opt = joptim.Momentum(learning_rate=0.01, momentum=0.9,
                          parameters=jm.parameters())
    step = JStep(jm, opt, lambda o, y: ce(o, y))
    want = []
    try:
        for k in range(2):
            x = np.stack([ds[i][0] for i in range(k * BATCH,
                                                   (k + 1) * BATCH)])
            y = np.array([ds[i][1] for i in range(k * BATCH,
                                                  (k + 1) * BATCH)])
            want.append(float(step(paddle.to_tensor(x),
                                   paddle.to_tensor(y)).item()))
    finally:
        jm.set_state_dict(flat)
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0]), (got, want)
    assert np.isnan(want[1]) and np.isfinite(got[1])   # queue 3 #39


def test_resnet50_summary_and_flops_match_jax(resnet50_jax):
    """25,557,032 parameters, all trainable; Conv2D / Linear FLOPs at
    1 x 3x64x64 equal the JAX package's count."""
    jm, flat = resnet50_jax
    pm = pmodels.resnet50(device="cpu")
    want = jsummary(jm)
    assert psummary(pm) == PModel(pm).summary() == want == \
        {"total_params": 25557032, "trainable_params": 25557032}
    try:
        assert pflops(pm, [1, 3, 64, 64]) == jflops(jm, [1, 3, 64, 64])
    finally:
        jm.train()
