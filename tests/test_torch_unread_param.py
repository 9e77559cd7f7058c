"""A trainable parameter that the loss does not read, through the port's
train steps and the JAX package's compiled one, on the CPU.

JAX's step takes `value_and_grad` over every trainable parameter, so a
weight the loss never reaches gets a zero gradient and the update still
moves it: AdamW's decoupled decay shrinks it and its moments decay. The
port's steps fill the same zero gradient after `backward()`. A frozen
weight (`requires_grad` False, JAX's `trainable=False`) stays out of
both and never moves.

The model holds two (4, 3) f32 weights `a` and `b` and a frozen `c`,
all from `RandomState(0)`; its loss is `(x @ a).mean()` on a (5, 4)
`x`. AdamW(0.1, weight_decay=0.5), 3 calls. Tolerances are
test_torch_train.py's f32 ones (`test_three_adamw_steps_match_jax_f32`):
weights within 1e-4 absolute, losses within 1e-5 relative; the third
loss is near zero (-0.049), where the two packages' f32 summation
orders alone differ by 7.5e-7 (1.5e-5 of it), so the losses also get
1e-6 absolute.

The data-parallel case runs `DistributedTrainStepCompiler` on 2 gloo
ranks (test_torch_dist.py's `_spawn`): each rank's shard of the batch
is the whole `x` (the batch is `x` twice on a leading axis), so the
mean of the ranks' gradients is the one-process gradient and the JAX
one-process step is the reference. The rank function is module-level
and imports no JAX: a spawned rank imports this file.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_dist import _load, _spawn

LR, WD, CALLS = 0.1, 0.5, 3
# name -> port TrainStepCompiler kwargs (the JAX step takes the same);
# "scaler" is a GradScaler made fresh for each package
CASES = {
    "plain": {},
    "merge2": dict(accumulate_steps=2),
    "guard": dict(guard_nonfinite=True),
    "scaler": dict(grad_scaler="scaler"),
}
DIST_SPECS = {"dist_none": None, "dist_fp32": "fp32"}


def _inputs():
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(5, 4).astype(np.float32)
    c = rng.randn(4, 3).astype(np.float32)
    return {"a": a, "b": b, "c": c}, x


class _PortModel(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        for n, arr in w.items():
            setattr(self, n, torch.nn.Parameter(torch.from_numpy(arr.copy()),
                                                requires_grad=n != "c"))

    def forward(self, x):
        return (x @ self.a).mean()


def _scaler_kw(pkg_amp, kw):
    kw = dict(kw)
    if kw.get("grad_scaler") == "scaler":
        kw["grad_scaler"] = pkg_amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                               incr_every_n_steps=2)
    return kw


def _port_run(kw):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    w, x = _inputs()
    m = _PortModel(w)
    opt = AdamW(LR, parameters=m.named_parameters(), weight_decay=WD)
    step = TrainStepCompiler(m, opt, **_scaler_kw(amp, kw))
    losses = [float(step(x)) for _ in range(CALLS)]
    return np.array(losses), {n: p.detach().numpy() for n, p in
                              m.named_parameters()}


def _jax_run(kw):
    import paddle_tpu as paddle
    import paddle_tpu.amp as jax_amp
    import paddle_tpu.nn as jax_nn
    import paddle_tpu.optimizer as jax_optim
    from paddle_tpu.jit import TrainStepCompiler as JaxTrainStep
    from paddle_tpu.nn.initializer import Assign

    w, x = _inputs()

    class Model(jax_nn.Layer):
        def __init__(self):
            super().__init__()
            for n, arr in w.items():
                p = self.create_parameter(list(arr.shape),
                                          default_initializer=Assign(arr))
                p.trainable = n != "c"
                setattr(self, n, p)

        def forward(self, x):
            return paddle.matmul(x, self.a).mean()

    m = Model()
    opt = jax_optim.AdamW(LR, parameters=m.parameters(), weight_decay=WD)
    step = JaxTrainStep(m, opt, **_scaler_kw(jax_amp, kw))
    losses = [float(np.asarray(step(paddle.to_tensor(x))._value))
              for _ in range(CALLS)]
    return np.array(losses), {n: np.asarray(getattr(m, n)._value)
                              for n in w}


def _hold(losses, params, want_losses, want_params):
    w, _ = _inputs()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    for n, want in want_params.items():
        np.testing.assert_allclose(params[n], want, rtol=0, atol=1e-4,
                                   err_msg=n)
    # the unread weight moved (JAX: by 0.364 under plain AdamW) ...
    assert np.abs(want_params["b"] - w["b"]).max() > 0.1
    # ... and the frozen one did not, in either package
    np.testing.assert_array_equal(want_params["c"], w["c"])
    np.testing.assert_array_equal(params["c"], w["c"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_unread_parameter_moves_as_in_jax(case):
    _hold(*_port_run(CASES[case]), *_jax_run(CASES[case]))


# -- 2 gloo ranks ------------------------------------------------------------
def _dist_rank(out_dir):
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    w, x = _inputs()
    batch = np.stack([x, x])            # rank r's shard: x
    res = {}
    for name, spec in DIST_SPECS.items():
        m = _PortModel(w)
        opt = AdamW(LR, parameters=m.named_parameters(), weight_decay=WD)
        step = DistributedTrainStepCompiler(m, opt, comm_compress=spec)
        res[f"{name}/losses"] = np.array(
            [float(step(batch)) for _ in range(CALLS)])
        for n, p in m.named_parameters():
            res[f"{name}/param/{n}"] = p.detach().numpy()
    np.savez(os.path.join(out_dir, f"unread_r{get_rank()}.npz"), **res)


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("unread"))
    _spawn(_dist_rank, (tmp,), 2, tmp)
    return _load(tmp, "unread", 2)


@pytest.mark.parametrize("name", sorted(DIST_SPECS))
def test_unread_parameter_moves_as_in_jax_data_parallel(dist_runs, name):
    r0, r1 = dist_runs
    params = {n: r0[f"{name}/param/{n}"] for n in "abc"}
    for n in "abc":
        np.testing.assert_array_equal(r1[f"{name}/param/{n}"], params[n])
    _hold(r0[f"{name}/losses"], params, *_jax_run({}))
