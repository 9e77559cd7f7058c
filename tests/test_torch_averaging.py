"""The port's averaging wrappers (`paddle_tpu_torch.optimizer.averaging`)
held against the JAX package's (`paddle_tpu/optimizer/averaging.py`):
the ten cases of tests/test_averaging_optimizers.py, each run through
both packages on the same numpy weights and batches (a Linear(4, 3)
trained by SGD or Momentum on the CPU), and against the same numpy
references.

Tolerance: 1e-5 relative and 1e-6 absolute between the port and JAX and
between either and numpy (the JAX tests' own), since the packages round
the products and the EMA's multiply-add in their own order; the step
counts and the bias-correction products (`_corr_prod`, Python floats)
are compared exactly, and `restore()` must give the parameters back bit
for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim

import paddle_tpu_torch.incubate as pincubate
import paddle_tpu_torch.optimizer as poptim
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.nn import Linear

RTOL, ATOL = 1e-5, 1e-6


def _pair(seed=3):
    """(JAX Linear(4, 3), port Linear(4, 3)) with the same weights."""
    paddle.seed(seed)
    jm = jnn.Linear(4, 3)
    pm = Linear(4, 3, device="cpu")
    load_reference_state_dict(
        pm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, pm


def _jparams(jm):
    return [np.asarray(p._value, np.float32) for p in jm.parameters()]


def _pparams(pm):
    return [p.detach().numpy().copy() for p in pm.parameters()]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _jstep(model, opt, x, y):
    pred = model(paddle.to_tensor(x))
    loss = paddle.mean((pred - paddle.to_tensor(y)) ** 2)
    loss.backward()
    opt.step()
    opt.clear_grad()


def _pstep(model, opt, x, y):
    pred = model(torch.from_numpy(x))
    ((pred - torch.from_numpy(y)) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()


def _data(seed, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            rng.randn(n, 3).astype(np.float32))


def test_ema_matches_jax_and_numpy():
    jm, pm = _pair()
    decay, T = 0.9, 5
    jopt = joptim.SGD(learning_rate=0.05, parameters=jm.parameters())
    popt = poptim.SGD(learning_rate=0.05, parameters=pm.parameters())
    jema = joptim.ExponentialMovingAverage(jm.parameters(), decay=decay)
    pema = poptim.ExponentialMovingAverage(pm.parameters(), decay=decay)
    x, y = _data(0)
    shadows = [np.zeros_like(p) for p in _pparams(pm)]
    for _ in range(T):
        _jstep(jm, jopt, x, y)
        _pstep(pm, popt, x, y)
        jema.update()
        pema.update()
        shadows = [decay * s + (1 - decay) * p
                   for s, p in zip(shadows, _pparams(pm))]
    raw = _pparams(pm)
    assert pema._corr_prod == jema._corr_prod and pema._t == jema._t == T
    with jema.apply(), pema.apply():
        _close(_pparams(pm), _jparams(jm))
        _close(_pparams(pm), [s / (1 - decay ** T) for s in shadows])
    for p, r in zip(_pparams(pm), raw):      # restored bit for bit
        np.testing.assert_array_equal(p, r)


def test_ema_thres_steps_schedules_decay():
    jm, pm = _pair()
    for ts in (0.0, 5.0, 1e6):
        jema = joptim.ExponentialMovingAverage(
            jm.parameters(), decay=0.999, thres_steps=lambda: ts)
        pema = poptim.ExponentialMovingAverage(
            pm.parameters(), decay=0.999, thres_steps=lambda: ts)
        assert pema._decay_t() == jema._decay_t()
    assert abs(pema._decay_t() - 0.999) < 1e-12


def test_ema_scheduled_decay_bias_correction_exact():
    """thres_steps schedules the decay applied at each update, so the
    correction is 1 - prod(d_i), not 1 - decay ** t."""
    jm, pm = _pair()
    sched = [0.0, 5.0, 50.0, 1e6, 1e6]
    js, ps = iter(sched), iter(sched)
    jema = joptim.ExponentialMovingAverage(jm.parameters(), decay=0.999,
                                           thres_steps=lambda: next(js))
    pema = poptim.ExponentialMovingAverage(pm.parameters(), decay=0.999,
                                           thres_steps=lambda: next(ps))
    shadows = [np.zeros_like(p) for p in _pparams(pm)]
    prod = 1.0
    for ts in sched:
        d = min(0.999, (1.0 + ts) / (10.0 + ts))
        prod *= d
        shadows = [d * s + (1 - d) * p for s, p in zip(shadows, _pparams(pm))]
        jema.update()
        pema.update()
    assert pema._corr_prod == jema._corr_prod == prod
    with jema.apply(), pema.apply():
        _close(_pparams(pm), _jparams(jm))
        _close(_pparams(pm), [s / (1 - prod) for s in shadows])


def test_ema_state_dict_roundtrip_preserves_corr_prod():
    jm, pm = _pair()
    pema = poptim.ExponentialMovingAverage(pm.parameters(), decay=0.9,
                                           thres_steps=lambda: 0.0)
    jema = joptim.ExponentialMovingAverage(jm.parameters(), decay=0.9,
                                           thres_steps=lambda: 0.0)
    pema.update()  # applied decay 0.1, not 0.9
    jema.update()
    sd = pema.state_dict()
    assert sd["corr_prod"] == jema.state_dict()["corr_prod"]
    assert abs(sd["corr_prod"] - 0.1) < 1e-12
    ema2 = poptim.ExponentialMovingAverage(pm.parameters(), decay=0.9)
    ema2.set_state_dict(sd)
    assert abs(ema2._corr_prod - 0.1) < 1e-12
    # a checkpoint without corr_prod falls back to decay ** t
    legacy = {k: v for k, v in sd.items() if k != "corr_prod"}
    ema3 = poptim.ExponentialMovingAverage(pm.parameters(), decay=0.9)
    ema3.set_state_dict(legacy)
    assert abs(ema3._corr_prod - 0.9) < 1e-12


def test_ema_state_dict_roundtrip():
    jm, pm = _pair()
    pema = poptim.ExponentialMovingAverage(pm.parameters(), decay=0.9)
    jema = joptim.ExponentialMovingAverage(jm.parameters(), decay=0.9)
    pema.update()
    jema.update()
    sd = pema.state_dict()
    _close([s.numpy() for s in sd["shadow"]],
           [np.asarray(s) for s in jema.state_dict()["shadow"]])
    ema2 = poptim.ExponentialMovingAverage(pm.parameters(), decay=0.9)
    ema2.set_state_dict(sd)
    for a, b in zip(ema2._shadow, pema._shadow):
        assert torch.equal(a, b)
    assert ema2._t == pema._t == 1


def test_lookahead_matches_jax_and_numpy():
    jm, pm = _pair()
    alpha, k = 0.5, 2
    jla = joptim.LookAhead(joptim.SGD(learning_rate=0.1,
                                      parameters=jm.parameters()),
                           alpha=alpha, k=k)
    pla = poptim.LookAhead(poptim.SGD(learning_rate=0.1,
                                      parameters=pm.parameters()),
                           alpha=alpha, k=k)
    x, y = _data(1)
    slow = _pparams(pm)
    fast = [s.copy() for s in slow]

    def np_grads(ws):
        W, b = ws
        g = 2.0 * (x @ W + b - y) / y.size
        return [x.T @ g, g.sum(0)]

    for t in range(1, 5):
        fast = [f - 0.1 * g for f, g in zip(fast, np_grads(fast))]
        if t % k == 0:
            slow = [s + alpha * (f - s) for s, f in zip(slow, fast)]
            fast = [s.copy() for s in slow]
        _jstep(jm, jla, x, y)
        _pstep(pm, pla, x, y)
        _close(_pparams(pm), _jparams(jm))
        for p, f in zip(_pparams(pm), fast):
            np.testing.assert_allclose(p, f, rtol=1e-4, atol=1e-5)


def test_lookahead_state_dict_roundtrip():
    jm, pm = _pair()

    def make(m, mod, alpha, k):
        return mod.LookAhead(mod.Momentum(learning_rate=0.1, momentum=0.9,
                                          parameters=m.parameters()),
                             alpha=alpha, k=k)

    jla, pla = make(jm, joptim, 0.3, 3), make(pm, poptim, 0.3, 3)
    x, y = _data(2, 4)
    for _ in range(4):
        _jstep(jm, jla, x, y)
        _pstep(pm, pla, x, y)
    _close([s.numpy() for s in pla._slow],
           [np.asarray(jla._slow[id(p)]) for p in jm.parameters()])
    sd = pla.state_dict()
    la2 = make(pm, poptim, 0.9, 7)
    la2.set_state_dict(sd)
    assert la2.alpha == 0.3 and la2.k == 3 and la2._la_step == 4
    for a, b in zip(la2._slow, pla._slow):
        assert torch.equal(a, b)
    assert la2._inner._step_count == pla._inner._step_count == 4


def test_model_average_matches_jax_and_numpy():
    jm, pm = _pair()
    kw = dict(min_average_window=2, max_average_window=10)
    jma = joptim.ModelAverage(
        0.5, parameters=jm.parameters(), inner_optimizer=joptim.SGD(
            learning_rate=0.05, parameters=jm.parameters()), **kw)
    pma = poptim.ModelAverage(
        0.5, parameters=pm.parameters(), inner_optimizer=poptim.SGD(
            learning_rate=0.05, parameters=pm.parameters()), **kw)
    x, y = _data(3)
    history = []
    for _ in range(3):
        _jstep(jm, jma, x, y)
        _pstep(pm, pma, x, y)
        history.append(_pparams(pm))
    sums = [np.zeros_like(h) for h in history[0]]
    num_acc = 0
    for t, snap in enumerate(history, start=1):
        num_acc += 1
        sums = [s + a for s, a in zip(sums, snap)]
        if num_acc >= 2 and num_acc >= min(10, max(int(t * 0.5), 1)):
            num_acc = 1
            sums = [a.copy() for a in snap]
    assert pma._num_accumulates == jma._num_accumulates == num_acc
    raw = _pparams(pm)
    with jma.apply(), pma.apply():
        _close(_pparams(pm), _jparams(jm))
        _close(_pparams(pm), [s / num_acc for s in sums])
    for p, r in zip(_pparams(pm), raw):
        np.testing.assert_array_equal(p, r)


def test_model_average_state_dict_roundtrip():
    jm, pm = _pair()
    kw = dict(min_average_window=2, max_average_window=10)
    pma = poptim.ModelAverage(0.5, parameters=pm.parameters(), **kw)
    jma = joptim.ModelAverage(0.5, parameters=jm.parameters(), **kw)
    pma.accumulate()
    jma.accumulate()
    _close([s.numpy() for s in pma._sum],
           [np.asarray(jma._sum[id(p)]) for p in jm.parameters()])
    sd = pma.state_dict()
    ma2 = poptim.ModelAverage(0.5, parameters=pm.parameters(), **kw)
    ma2.set_state_dict(sd)
    assert ma2._num_accumulates == pma._num_accumulates == 1
    for a, b in zip(ma2._sum, pma._sum):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="inner_optimizer"):
        pma.step()


def test_incubate_exports():
    assert pincubate.LookAhead is poptim.LookAhead
    assert pincubate.optimizer.ModelAverage is poptim.ModelAverage
    assert poptim.ExponentialMovingAverage.__module__.endswith("averaging")
