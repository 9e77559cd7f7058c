"""The port's optimizer slice held against the JAX package, on the CPU.

The same numpy inputs go through both packages. Tolerances, each with
its reason:

  * the plain multi-tensor rules against the JAX Pallas kernels
    (`fused_*_chunks(..., interpret=True)`): rtol = atol = 1e-6 after
    three steps, the JAX package's own fused-vs-loop tolerance
    (test_pallas_fusion.py:186-193). XLA on the CPU contracts
    b1*m + (1-b1)*g into an FMA inside the interpreted kernel; the port
    rounds every operation, as its CUDA kernel does, so single elements
    differ by an ulp or two per step;
  * every optimizer over three steps against the JAX rule
    (`apply_gradients`, per parameter): the same 1e-6; a bf16 parameter
    re-derived from its master within one bf16 ulp (rtol 2^-8), since a
    master an ulp away can round the other way; Lamb and LarsMomentum
    take norms, summed in another order: 1e-5;
  * learning-rate schedulers: exact, the same host float arithmetic;
  * clips: f32 within 1e-6 relative (the squared norms are summed in
    another order); a clipped bf16 grad within one bf16 ulp (rtol 2^-8):
    a scale an ulp away can round a product the other way;
  * GradScaler: the scale and its counters exactly; parameters as the
    optimizer tests;
  * TrainStepCompiler on a 2-layer f32 GPT: losses within 1e-5
    relative, parameters within 1e-4 absolute (test_torch_train.py's
    f32 tolerances: the two differ in summation order, which Adam
    magnifies for gradients near zero); skip flags and loss scales
    exactly, and the parameters bit for bit unchanged by a tripped
    step.

The CPU plain version of each kernel is also held bit for bit to the
optimizers' per-parameter path: the same rule, as the card holds the
kernel to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jax_amp
import paddle_tpu.nn as jax_nn
import paddle_tpu.optimizer as jax_optim
from paddle_tpu.incubate.nn.pallas import optim as jax_kernels
from paddle_tpu.inference.serving.model_runner import extract_params
from paddle_tpu.jit import TrainStepCompiler as JaxTrainStep
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.text.models import gpt as jax_gpt

from paddle_tpu_torch import amp, nn
from paddle_tpu_torch import optimizer as port_optim
from paddle_tpu_torch.convert import (load_reference_params,
                                      optimizer_state_from_numpy)
from paddle_tpu_torch.incubate.nn.kernels import optim as port_kernels
from paddle_tpu_torch.jit import TrainStepCompiler
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.text.models import gpt as port_gpt

BF16_ULP = 2.0 ** -8
SHAPES = {"w": (130, 70), "b": (70,), "big": (40000,)}


@pytest.fixture(autouse=True)
def _jax_loop(monkeypatch):
    """The JAX optimizers' per-parameter loop (no Pallas fusion)."""
    monkeypatch.delenv("PADDLE_PALLAS_FUSION", raising=False)


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: (scale * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- the plain multi-tensor rules vs the JAX Pallas kernels ----------------
KERNEL_CASES = {
    "adamw_filter": dict(kind="adam", wd=0.05, decoupled=True,
                         skip=("b",)),
    "adam_l2": dict(kind="adam", wd=0.02, decoupled=False),
    "sgd": dict(kind="sgd", wd=0.0),
    "sgd_l2": dict(kind="sgd", wd=0.02),
    "momentum": dict(kind="momentum", wd=0.0, nesterov=False),
    "nesterov_l2": dict(kind="momentum", wd=0.01, nesterov=True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_multi_tensor_rules_match_jax_kernels(case):
    c = KERNEL_CASES[case]
    kind, wd, lr = c["kind"], c["wd"], 0.01
    b1, b2, eps, mu = 0.9, 0.999, 1e-8, 0.9
    names = list(SHAPES)
    params = _arrays(0)
    zeros = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    segs = jax_kernels._segments(names, params)
    # JAX state: packed buffers; port state: per-tensor tensors
    jp = jax_kernels._pack(segs, params)
    jm = jax_kernels._pack(segs, zeros)
    jv = jax_kernels._pack(segs, zeros)
    pows = {n: (np.float32(1.0), np.float32(1.0)) for n in names}
    tp = [_t(params[n]) for n in names]
    tm = [torch.zeros(SHAPES[n]) for n in names]
    tv = [torch.zeros(SHAPES[n]) for n in names]
    tp1 = [torch.ones(()) for _ in names]
    tp2 = [torch.ones(()) for _ in names]
    masters = [None] * len(names)
    decoupled = c.get("decoupled", False)
    wdc = 0.0 if decoupled else wd
    for step in range(3):
        grads = _arrays(10 + step)
        jg = jax_kernels._pack(segs, grads)
        tg = [_t(grads[n]) for n in names]
        lr32 = jnp.float32(lr)
        if kind == "adam":
            d1, d2, wds = {}, {}, {}
            for n in names:
                p1, p2 = pows[n]
                p1, p2 = np.float32(p1 * np.float32(b1)), np.float32(
                    p2 * np.float32(b2))
                pows[n] = (p1, p2)
                d1[n], d2[n] = np.float32(1) - p1, np.float32(1) - p2
                wds[n] = wd if decoupled and n not in c.get("skip", ()) \
                    else 0.0
            jp, jm, jv = jax_kernels.fused_adam_chunks(
                jp, jg, jm, jv, lr32, jax_kernels._pack_scalars(segs, d1),
                jax_kernels._pack_scalars(segs, d2),
                jax_kernels._pack_scalars(segs, wds), beta1=b1, beta2=b2,
                eps=eps, wd_coupled=wdc, interpret=True)
            decay = [float(np.float32(1) - np.float32(lr) * np.float32(wds[n]))
                     for n in names]
            port_kernels.fused_adam(tp, tg, masters, tm, tv, tp1, tp2, lr=lr,
                                    beta1=b1, beta2=b2, eps=eps, decay=decay,
                                    l2=[wdc] * len(names))
        elif kind == "momentum":
            jp, jm = jax_kernels.fused_momentum_chunks(
                jp, jg, jm, lr32, momentum=mu, nesterov=c["nesterov"],
                wd_coupled=wdc, interpret=True)
            port_kernels.fused_momentum(tp, tg, masters, tm, lr=lr,
                                        momentum=mu, nesterov=c["nesterov"],
                                        l2=[wdc] * len(names))
        else:
            jp = jax_kernels.fused_sgd_chunks(jp, jg, lr32, wd_coupled=wdc,
                                              interpret=True)
            port_kernels.fused_sgd(tp, tg, masters, lr=lr,
                                   l2=[wdc] * len(names))
    shapes = {n: SHAPES[n] for n in names}
    want_p = jax_kernels._unpack(segs, jp, shapes)
    want_m = jax_kernels._unpack(segs, jm, shapes)
    want_v = jax_kernels._unpack(segs, jv, shapes)
    for i, n in enumerate(names):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(want_p[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        if kind != "sgd":
            np.testing.assert_allclose(tm[i].numpy(), np.asarray(want_m[n]),
                                       rtol=1e-6, atol=1e-6, err_msg=n)
        if kind == "adam":
            np.testing.assert_allclose(tv[i].numpy(), np.asarray(want_v[n]),
                                       rtol=1e-6, atol=1e-6, err_msg=n)
            assert float(tp1[i]) == float(pows[n][0])
            assert float(tp2[i]) == float(pows[n][1])


# -- every optimizer vs the JAX rule ----------------------------------------
def _pair(jcls, pcls, **kw):
    return (lambda: jcls(**kw)), (lambda params: pcls(parameters=params, **kw))


OPT_CASES = {
    "sgd": _pair(jax_optim.SGD, port_optim.SGD, learning_rate=0.1),
    "momentum": _pair(jax_optim.Momentum, port_optim.Momentum,
                      learning_rate=0.1, momentum=0.9),
    "nesterov": _pair(jax_optim.Momentum, port_optim.Momentum,
                      learning_rate=0.1, momentum=0.9, use_nesterov=True),
    "adam": _pair(jax_optim.Adam, port_optim.Adam, learning_rate=0.01),
    "adam_l2": _pair(jax_optim.Adam, port_optim.Adam, learning_rate=0.01,
                     weight_decay=0.02),
    "adamw": _pair(jax_optim.AdamW, port_optim.AdamW, learning_rate=0.01,
                   weight_decay=0.05),
    "adamw_filter": _pair(jax_optim.AdamW, port_optim.AdamW,
                          learning_rate=0.01, weight_decay=0.05,
                          apply_decay_param_fun=lambda n: n != "b"),
    "adamw_lr_ratio": _pair(jax_optim.AdamW, port_optim.AdamW,
                            learning_rate=0.01, weight_decay=0.05,
                            lr_ratio=lambda p: 0.5),
    "adamax": _pair(jax_optim.Adamax, port_optim.Adamax, learning_rate=0.01),
    # initial_accumulator_value 0: the JAX rule's functional state
    # starts its moment at zeros whatever the value (ROADMAP.md queue 3)
    "adagrad": _pair(jax_optim.Adagrad, port_optim.Adagrad,
                     learning_rate=0.01),
    "adadelta": _pair(jax_optim.Adadelta, port_optim.Adadelta,
                      learning_rate=1.0),
    "rmsprop": _pair(jax_optim.RMSProp, port_optim.RMSProp,
                     learning_rate=0.01, momentum=0.9),
    "rmsprop_centered": _pair(jax_optim.RMSProp, port_optim.RMSProp,
                              learning_rate=0.01, centered=True),
    "lamb": _pair(jax_optim.Lamb, port_optim.Lamb, learning_rate=0.01),
    "lars": _pair(jax_optim.LarsMomentum, port_optim.LarsMomentum,
                  learning_rate=0.1),
    # master weights: bf16 parameters and grads, f32 masters
    "adam_master": _pair(jax_optim.Adam, port_optim.Adam, learning_rate=0.01,
                         multi_precision=True),
    "adamw_master": _pair(jax_optim.AdamW, port_optim.AdamW,
                          learning_rate=0.01, weight_decay=0.05,
                          multi_precision=True),
    "momentum_master": _pair(jax_optim.Momentum, port_optim.Momentum,
                             learning_rate=0.1, momentum=0.9,
                             multi_precision=True),
    "sgd_master": _pair(jax_optim.SGD, port_optim.SGD, learning_rate=0.1,
                        multi_precision=True),
}


def _jax_params(arrays, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return {n: jnp.asarray(a, jnp.float32).astype(dt)
            for n, a in arrays.items()}


def _port_param(arr, bf16):
    t = _t(np.asarray(jnp.asarray(arr, jnp.float32)))
    return torch.nn.Parameter(t.bfloat16() if bf16 else t)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_jax_rule(case):
    make_jax, make_port = OPT_CASES[case]
    bf16 = case.endswith("_master")
    norms = case in ("lamb", "lars")
    jo = make_jax()
    jparams = _jax_params(_arrays(0), bf16)
    state = jo.init_state(jparams)
    named = [(n, _port_param(a, bf16)) for n, a in jparams.items()]
    po = make_port(named)
    for step in range(3):
        grads = _jax_params(_arrays(20 + step, scale=0.5), bf16)
        jparams, state = jo.apply_gradients(jparams, grads, state,
                                            jo.get_lr())
        for n, p in named:
            p.grad = _port_param(grads[n], bf16).detach()
        po.step()
    rtol = 1e-5 if norms else 1e-6
    for n, p in named:
        got = p.detach().float().numpy()
        want = np.asarray(jparams[n], np.float32)
        tol = BF16_ULP if bf16 else rtol
        np.testing.assert_allclose(got, want, rtol=tol, atol=rtol,
                                   err_msg=n)
        slots = po._accumulators[n]
        assert set(slots) == set(state[n]), n
        for s, want_s in state[n].items():
            np.testing.assert_allclose(slots[s].numpy(), np.asarray(want_s),
                                       rtol=rtol, atol=rtol,
                                       err_msg=f"{n}.{s}")
    assert po.state_dict()["@step"] == 3


# -- the kernels' plain versions are the optimizers' per-parameter path ----
def _o2_set(seed):
    """An O2 parameter set: bf16 weights with f32 masters, f32
    LayerNorm-like tensors without, and a zero-size tensor."""
    a = _arrays(seed, {"w": (64, 48), "b": (48,), "ln_w": (48,),
                       "odd": (1001,), "empty": (0,)})
    return [(n, torch.nn.Parameter(_t(v).bfloat16() if n in ("w", "odd")
                                   else _t(v))) for n, v in a.items()]


@pytest.mark.parametrize("case", ["adamw_filter", "adam_l2", "momentum",
                                  "nesterov", "sgd"])
def test_kernel_plain_version_is_the_per_parameter_rule(case):
    """The optimizers' fused path (here through the wrappers' CPU plain
    versions) against their per-parameter `_update` loop: bit for bit,
    slots and parameters, after three steps."""
    kw = {"adamw_filter": (port_optim.AdamW, dict(
              learning_rate=0.01, weight_decay=0.05,
              apply_decay_param_fun=lambda n: not n.startswith("ln"))),
          "adam_l2": (port_optim.Adam, dict(learning_rate=0.01,
                                            weight_decay=0.02)),
          "momentum": (port_optim.Momentum, dict(learning_rate=0.1)),
          "nesterov": (port_optim.Momentum, dict(learning_rate=0.1,
                                                 use_nesterov=True)),
          "sgd": (port_optim.SGD, dict(learning_rate=0.1,
                                       weight_decay=0.01))}[case]
    cls, args = kw
    sets = [_o2_set(0), _o2_set(0)]
    opts = [cls(parameters=s, multi_precision=True, **args) for s in sets]
    for step in range(3):
        grads = _arrays(30 + step, {n: tuple(p.shape) for n, p in sets[0]})
        for s in sets:
            for n, p in s:
                p.grad = _t(grads[n]).to(p.dtype)
        # the fused path, as step() takes it for CUDA parameters
        items = [(n, p, p.grad) for n, p in sets[0]]
        opts[0]._fused_update(items, opts[0].get_lr())
        opts[0]._step_count += 1
        opts[1].step()
    for (n, a), (_, b) in zip(*sets):
        assert torch.equal(a, b), n
    sd = [o.state_dict() for o in opts]
    assert set(sd[0]) == set(sd[1])
    for k, v in sd[0].items():
        assert v == sd[1][k] if k == "@step" else torch.equal(v, sd[1][k]), k


def test_slots_are_updated_in_place_and_state_dict_clones():
    named = _o2_set(1)
    opt = port_optim.AdamW(0.01, parameters=named, multi_precision=True)
    for n, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    ids = {n: {s: id(t) for s, t in slots.items()}
           for n, slots in opt._accumulators.items()}
    sd = opt.state_dict()
    opt.step()
    assert ids == {n: {s: id(t) for s, t in slots.items()}
                   for n, slots in opt._accumulators.items()}
    assert not torch.equal(sd["w.moment1"], opt._accumulators["w"]["moment1"])
    assert float(sd["w.beta1_pow"]) == np.float32(0.9)


# -- learning-rate schedulers ----------------------------------------------
def _sched_args():
    lam = lambda e: 0.95 ** e  # noqa: E731
    return {
        "NoamDecay": dict(d_model=64, warmup_steps=10, learning_rate=2.0),
        "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
        "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
        "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.1),
        "PolynomialDecay": dict(learning_rate=0.5, decay_steps=20,
                                end_lr=0.01, power=2.0, cycle=True),
        "PiecewiseDecay": dict(boundaries=[5, 15, 30],
                               values=[1.0, 0.5, 0.1, 0.01]),
        "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=16,
                                     eta_min=0.01),
        "LinearWarmup": dict(learning_rate=0.5, warmup_steps=7,
                             start_lr=0.0, end_lr=0.5),
        "StepDecay": dict(learning_rate=0.5, step_size=7, gamma=0.5),
        "MultiStepDecay": dict(learning_rate=0.5, milestones=[3, 10, 40]),
        "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lam),
        "MultiplicativeDecay": dict(learning_rate=0.5, lr_lambda=lambda e:
                                    0.97),
        "OneCycleLR": dict(max_learning_rate=0.5, total_steps=40),
        "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.5,
                         step_size_up=6, step_size_down=4,
                         mode="triangular2"),
        "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=5,
                                            T_mult=2, eta_min=0.001),
        "LinearLR": dict(learning_rate=0.5, total_steps=30),
        "ConstantLR": dict(learning_rate=0.5, factor=0.25, total_steps=9),
        "ReduceOnPlateau": dict(learning_rate=0.5, patience=2, cooldown=1,
                                factor=0.5),
    }


def _drive(sched, name, n=50):
    out = [sched()]
    for i in range(n):
        if name == "ReduceOnPlateau":
            sched.step(1.0 / (1 + i) if i < 10 else 0.1 + (i % 3) * 0.01)
        else:
            sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(port_lr.__all__))
def test_lr_scheduler_matches_jax(name):
    assert sorted(port_lr.__all__) == sorted(jax_lr.__all__)
    if name == "LRScheduler":
        with pytest.raises(NotImplementedError):
            port_lr.LRScheduler(0.1)
        return
    args = _sched_args()[name]
    want = _drive(getattr(jax_lr, name)(**args), name)
    sched = getattr(port_lr, name)(**args)
    got = _drive(sched, name)
    assert got == want                      # exact: the same host floats
    # a warm-up over a schedule, as the pretraining recipe nests them
    nested = [port_lr.LinearWarmup(port_lr.CosineAnnealingDecay(1e-4, 16),
                                   2, 0.0, 1e-4),
              jax_lr.LinearWarmup(jax_lr.CosineAnnealingDecay(1e-4, 16),
                                  2, 0.0, 1e-4)]
    assert _drive(nested[0], "") == _drive(nested[1], "")
    # state dict round trip
    fresh = getattr(port_lr, name)(**args)
    fresh.set_state_dict(sched.state_dict())
    assert fresh() == sched()


# -- gradient clipping -------------------------------------------------------
class _P:
    """A parameter stand-in for the JAX clips (they read need_clip)."""

    def __init__(self, need_clip=True):
        self.need_clip = need_clip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clip_matches_jax(clip, dtype):
    bf16 = dtype == "bfloat16"
    grads = _arrays(40, scale=0.3)
    need = {"w": True, "b": clip != "global_norm", "big": True}
    make = {"value": lambda m: m.ClipGradByValue(0.5, -0.4),
            "norm": lambda m: m.ClipGradByNorm(5.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(10.0)}[clip]
    jg = _jax_params(grads, bf16)
    jout = make(jax_nn)([(_P(need[n]), g) for n, g in jg.items()])
    pout = make(nn)([(torch.nn.Parameter(torch.zeros(1)), None)]
                    + [(_port_need(need[n]), _port_param(g, bf16).detach())
                       for n, g in jg.items()])
    assert pout[0][1] is None
    for (n, g), (_, jgot), (_, pgot) in zip(jg.items(), jout, pout[1:]):
        want = np.asarray(getattr(jgot, "_value", jgot), np.float32)
        assert pgot.dtype == (torch.bfloat16 if bf16 else torch.float32)
        got = pgot.float().numpy()
        np.testing.assert_allclose(got, want, rtol=BF16_ULP if bf16 else 1e-6,
                                   atol=0, err_msg=n)
        if n != "b":                    # large enough to be clipped
            assert not np.array_equal(got, np.asarray(g, np.float32)), n
    if clip == "global_norm":           # need_clip=False: untouched
        assert torch.equal(pout[2][1].float(),
                           _t(np.asarray(jg["b"], np.float32)))


def _port_need(need):
    p = torch.nn.Parameter(torch.zeros(1))
    p.need_clip = need
    return p


# -- GradScaler --------------------------------------------------------------
def test_grad_scaler_eager_matches_jax():
    """scale / unscale_ / step / update over five steps, two of them
    with a non-finite gradient: the same skips, backoffs, growths and
    parameters in both packages; the eager unscale_ leaves f32 grads."""
    arrays = _arrays(50, {"w": (6, 3), "b": (3,)})
    lin = jax_nn.Linear(6, 3)
    jparams = {"w": lin.weight, "b": lin.bias}
    for n, p in jparams.items():
        p._value = jnp.asarray(arrays[n]).astype(jnp.bfloat16)
    jo = jax_optim.Adam(0.01, parameters=list(jparams.values()),
                        multi_precision=True)
    pnamed = [(n, torch.nn.Parameter(_t(arrays[n]).bfloat16()))
              for n in jparams]
    po = port_optim.Adam(0.01, parameters=pnamed, multi_precision=True)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ps = jax_amp.GradScaler(**kw), amp.GradScaler(**kw)
    assert float(ps.scale(torch.tensor(2.0))) == float(
        js.scale(paddle.to_tensor(np.float32(2.0))).item()) == 2048.0
    for step in range(5):
        g = _arrays(60 + step, {"w": (6, 3), "b": (3,)}, scale=100.0)
        if step in (1, 2):
            g["w"][0, 0] = np.inf if step == 1 else np.nan
        for n, p in jparams.items():
            p._grad = paddle.to_tensor(
                jnp.asarray(g[n]).astype(jnp.bfloat16))
        for n, p in pnamed:
            p.grad = _t(g[n]).bfloat16()
        if step == 3:                 # an explicit unscale_ first
            js.unscale_(jo)
            ps.unscale_(po)
            assert all(p.grad.dtype == torch.float32 for _, p in pnamed)
        js.step(jo)
        ps.step(po)
        assert ps._scale == js._scale, step
        assert ps.state_dict() == js.state_dict(), step
        for n, p in pnamed:
            np.testing.assert_allclose(
                p.detach().float().numpy(),
                np.asarray(jparams[n]._value, np.float32), rtol=BF16_ULP,
                atol=1e-6, err_msg=f"{step} {n}")
    # two skips backed off twice, then two good steps grew once
    assert ps._scale == 1024.0 * 0.25 * 2
    assert po._step_count == 3
    fresh = amp.GradScaler()
    fresh.load_state_dict(ps.state_dict())
    assert fresh.state_dict() == ps.state_dict()
    off = amp.GradScaler(enable=False)
    x = torch.tensor(3.0)
    assert off.scale(x) is x and not off.is_enable()


# -- TrainStepCompiler options vs the JAX compiled step ---------------------
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            ffn_hidden=128, max_seq_len=64, dropout=0.0)


def _models():
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(
        use_flash_attention=False, remat=False, **TINY))
    params, _ = extract_params(jm)
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = port_gpt.GPTForCausalLM(port_gpt.GPTConfig(remat=False, **TINY),
                                 device="cpu")
    load_reference_params(pm, tree)
    return jm, pm


def _batches(n, k=1, seed=5):
    rng = np.random.RandomState(seed)
    shape = (k, 2, 32) if k > 1 else (2, 32)
    return [(rng.randint(0, 128, shape).astype(np.int32),
             rng.randint(0, 128, shape).astype(np.int32)) for _ in range(n)]


def _decay(n):
    return not (n.endswith("_b") or "ln" in n)


def _recipe(pkg_optim, pkg_nn, pkg_lr, params):
    sched = pkg_lr.LinearWarmup(pkg_lr.CosineAnnealingDecay(1e-3, T_max=8),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    return sched, pkg_optim.AdamW(
        sched, parameters=params, weight_decay=0.01,
        grad_clip=pkg_nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=_decay)


def _port_flat(pm):
    return {n: p.detach().float().numpy().copy()
            for n, p in pm.gpt.named_parameters()}


def _jax_flat(jm):
    params, _ = extract_params(jm)
    out = {}
    for k, v in jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), params).items():
        if k == "blocks":
            out.update({f"blocks.{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


# A trip is a loss weight of inf or nan on chosen microsteps: the train
# step's loss_fn multiplies the model's loss by the batch's weight.
# (A GradScaler at 1e38 is no trip of the port: the scaled loss is inf,
# but the guard reads the unscaled loss and gradients, and the port's
# gradients of the scaled loss peak near 2e37 where the JAX package's
# LayerNorm backward overflows to nan.)
STEP_CASES = {
    "merge2_guard_clip_schedule": dict(merge=2, guard=True),
    "dispatch2": dict(k=2),
    "guard_trip": dict(guard=True, trips=(1,)),
    "scaler_trip": dict(scaler=True, trips=(1, 4)),
    "merge2_scaler_trip": dict(merge=2, scaler=True, trips=(1, 2)),
    "dispatch2_scaler_trip": dict(k=2, scaler=True, trips=(2,)),
}


def _weighted(loss, weight):
    return loss * weight


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_options_match_jax(case):
    c = STEP_CASES[case]
    jm, pm = _models()
    k, merge, trips = c.get("k", 1), c.get("merge", 1), c.get("trips", ())
    if case == "merge2_guard_clip_schedule":
        jsched, jo = _recipe(jax_optim, jax_nn, jax_lr, jm.parameters())
        psched, po = _recipe(port_optim, nn, port_lr, pm.named_parameters())
        loss_fn = None
    else:
        jsched = psched = None
        jo = jax_optim.AdamW(1e-3, parameters=jm.parameters(),
                             weight_decay=0.01)
        po = port_optim.AdamW(1e-3, parameters=pm.named_parameters(),
                              weight_decay=0.01)
        loss_fn = _weighted
    scalers = (None, None)
    if c.get("scaler"):
        kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
        scalers = (jax_amp.GradScaler(**kw), amp.GradScaler(**kw))
    kw = dict(accumulate_steps=merge, steps_per_dispatch=k,
              guard_nonfinite=c.get("guard", False))
    js = JaxTrainStep(jm, jo, loss_fn, grad_scaler=scalers[0], **kw)
    ps = TrainStepCompiler(pm, po, loss_fn, grad_scaler=scalers[1], **kw)
    n_calls = 6 // k
    weights = np.ones(n_calls * k, np.float32)
    for i, t in enumerate(trips):
        weights[t] = np.inf if i % 2 == 0 else np.nan
    skipped = 0
    for call, (ids, labels) in enumerate(_batches(n_calls, k)):
        w = weights[call * k:(call + 1) * k]
        batch = (ids, labels) if loss_fn is None else (
            ids, labels, w if k > 1 else w[0])
        before = _port_flat(pm)
        want = np.asarray(js(*map(paddle.to_tensor, batch))._value)
        got = ps(*batch)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        assert ps.last_skips == js.last_skips
        skipped += ps.last_skips
        if scalers[0] is not None:
            assert scalers[1]._scale == scalers[0]._scale
            assert scalers[1].state_dict() == scalers[0].state_dict()
        if ps.last_skips and merge == 1 and k == 1:   # nothing changed
            after = _port_flat(pm)
            assert all(np.array_equal(before[n], after[n]) for n in before)
        if psched is not None:
            jsched.step()
            psched.step()
            assert po.get_lr() == jo.get_lr()
    assert skipped == (len(trips) if kw["guard_nonfinite"] or scalers[0]
                       else 0)
    assert po._step_count == jo._step_count
    want = _jax_flat(jm)
    for name, got in _port_flat(pm).items():
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_steps_per_dispatch_rejects_a_batch_without_the_k_axis():
    _, pm = _models()
    ps = TrainStepCompiler(pm, port_optim.SGD(0.1, parameters=pm.parameters()),
                           steps_per_dispatch=3)
    ids, labels = _batches(1)[0]
    with pytest.raises(ValueError, match="leading axis of 3"):
        ps(ids, labels)


def test_optimizer_state_from_numpy_resumes_a_jax_run():
    """Two JAX AdamW steps (masters, decay filter), the state carried
    into the port, then one more step in each package."""
    names = {"w": "layer.w", "b": "layer.b"}
    arrays = _arrays(70, {"w": (40, 24), "b": (24,)})
    jo = jax_optim.AdamW(0.01, weight_decay=0.05, multi_precision=True,
                         apply_decay_param_fun=lambda n: n != "b")
    jp = _jax_params(arrays, True)
    state = jo.init_state(jp)
    grads = [_jax_params(_arrays(80 + s, {"w": (40, 24), "b": (24,)}), True)
             for s in range(3)]
    for g in grads[:2]:
        jp, state = jo.apply_gradients(jp, g, state, 0.01)
    named = [(names[n], torch.nn.Parameter(_t(np.asarray(a, np.float32))
                                           .bfloat16()))
             for n, a in jp.items()]
    po = port_optim.AdamW(0.01, parameters=named, weight_decay=0.05,
                          multi_precision=True,
                          apply_decay_param_fun=lambda n: n != "layer.b")
    flat = {n: {s: np.asarray(v) for s, v in sl.items()}
            for n, sl in state.items()}
    flat["@step"] = 2
    po.set_state_dict(optimizer_state_from_numpy(flat, names))
    assert po._step_count == 2
    jp, state = jo.apply_gradients(jp, grads[2], state, 0.01)
    for n, p in named:
        p.grad = _port_param(grads[2][{v: k for k, v in names.items()}[n]],
                             True).detach()
    po.step()
    for jn, pn in names.items():
        np.testing.assert_allclose(
            po._accumulators[pn]["master_weight"].numpy(),
            np.asarray(state[jn]["master_weight"]), rtol=1e-6, atol=1e-6)
        assert float(po._accumulators[pn]["beta1_pow"]) == float(
            state[jn]["beta1_pow"])
    # the eager, flat key form of a state dict maps the same way
    sd = {"w.moment1": np.ones((40, 24)), "@step": 5}
    out = optimizer_state_from_numpy(sd, names)
    assert out["@step"] == 5 and out["layer.w.moment1"].dtype == torch.float32
    with pytest.raises(KeyError):
        optimizer_state_from_numpy({"zz.moment1": np.ones(2)}, names)


def test_o1_and_bad_amp_levels_raise_and_o2_is_accepted():
    lin = torch.nn.Linear(3, 2)
    opt = port_optim.SGD(0.1, parameters=lin.parameters())
    # O1 is ported (amp.auto_cast around the forward; tests/test_torch_amp)
    assert TrainStepCompiler(lin, opt, amp_level="O1")._amp_level == "O1"
    with pytest.raises(ValueError):
        TrainStepCompiler(lin, opt, amp_level="O3")
    TrainStepCompiler(lin, opt, amp_level="O2")
    # a disabled scaler is no scaler: the guard stays off
    step = TrainStepCompiler(lin, opt, grad_scaler=amp.GradScaler(
        enable=False))
    assert step._grad_scaler is None and not step._guard_nonfinite
