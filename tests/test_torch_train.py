"""The port's training path held against the JAX package's.

The same numpy weights and batches go through the JAX package's
`_k_gpt_loss` / `TrainStepCompiler` + `AdamW` and through the port's
`gpt_loss` / `TrainStepCompiler` + `AdamW`, on the CPU (the port's
kernel wrappers then run their plain versions). Tolerances:

  * f32 loss within 1e-6 relative and every gradient within 1e-5 x
    max|g| of each parameter's JAX gradient: the two differ only in
    summation order. At head_dim 64 the port's attention is the flash
    path (its plain online-softmax versions: p recomputed from lse),
    JAX's the dense softmax it takes off the TPU. With the 0.35 init
    the attention saturates, dp - delta cancels (delta = rowsum(dO*O)
    from the f32 O, where the dense backward sums p*dp), and the flash
    form is held at 2e-4 x max|g|;
  * three f32 AdamW steps: losses within 1e-5 relative; parameters
    within 1e-4 absolute, a tenth of one step at lr 1e-3 (Adam divides
    m by sqrt(v), which magnifies the summation-order noise of
    gradients near zero);
  * bf16 O2 (`amp.decorate` + multi_precision AdamW): losses within
    1e-3 relative (they agree to ~1e-4 while falling ~20%). The two
    packages round bf16 at other places (JAX fuses the f32 softmax and
    the loss casts into its products), so an element whose gradient is
    near zero can get another Adam step, of up to 2 lr: every parameter
    is held within 2 lr x 3 steps plus two bf16 ulps. That bound alone
    would pass a port that never updates, so each parameter's change
    over the three steps is held to JAX's: ||dp_port - dp_jax|| <= 0.15
    ||dp_jax|| (measured <= 0.073; no update scores 1). The key third
    of qkv_b is left out of that check: its exact gradient is zero (a
    key bias adds one constant to each row of scores, and softmax
    ignores it), so in bf16 it is rounding noise, which Adam turns into
    steps of +-lr in either package.

The port's own contracts: `decorate` keeps LayerNorm parameters f32,
remat gives the same gradients as no remat, dropout 0 is the identity
and dropout p is inverted dropout from the model's generator (its
masks are not JAX's, so it is held to its own properties).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jax_amp
import paddle_tpu.optimizer as jax_optim
from paddle_tpu.inference.serving.model_runner import extract_params
from paddle_tpu.jit import TrainStepCompiler as JaxTrainStep
from paddle_tpu.text.models import gpt as jax_gpt

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_reference_params
from paddle_tpu_torch.jit import TrainStepCompiler
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.text.models import gpt as port_gpt

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            ffn_hidden=128, max_seq_len=64, dropout=0.0)
# head_dim 64: the port's training attention takes the flash path
WIDE_HEADS = dict(TINY, hidden_size=128, num_heads=2)


def _batch(cfg, b=2, s=32, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg["vocab_size"], (b, s)).astype(np.int32),
            rng.randint(0, cfg["vocab_size"], (b, s)).astype(np.int32))


def _models(cfg, init=0.02, remat=False):
    """(JAX model, its numpy tree, port model with the same weights)."""
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(
        use_flash_attention=False, remat=remat, initializer_range=init,
        **cfg))
    params, _ = extract_params(jm)
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = port_gpt.GPTForCausalLM(
        port_gpt.GPTConfig(initializer_range=init, remat=remat, **cfg),
        device="cpu")
    load_reference_params(pm, tree)
    return jm, tree, pm


def _leaves(tree):
    """Port parameter tree of fresh leaf tensors that require grad."""
    def leaf(a):
        return torch.from_numpy(np.array(a, np.float32)).requires_grad_()

    return {k: ({n: leaf(a) for n, a in v.items()} if k == "blocks"
                else leaf(v)) for k, v in tree.items()}


# compiled once per shape: the eager trace of the scanned model is slow
_JAX_LOSS_GRAD = jax.jit(jax.value_and_grad(jax_gpt._k_gpt_loss, argnums=2),
                         static_argnums=(3, 4, 5, 6))


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            out.update({f"blocks.{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("cfg", [TINY, WIDE_HEADS],
                         ids=["head_dim16_dense", "head_dim64_flash"])
@pytest.mark.parametrize("init", [0.02, 0.35])
def test_loss_and_grads_match_jax(cfg, init):
    _, tree, _ = _models(cfg, init)
    ids, labels = _batch(cfg)
    n_head = cfg["num_heads"]
    want_loss, want = _JAX_LOSS_GRAD(ids, labels, tree, n_head, 1e-5, False,
                                     False)
    leaves = _leaves(tree)
    loss = port_gpt.gpt_loss(torch.from_numpy(ids), torch.from_numpy(labels),
                             leaves, n_head, 1e-5, use_flash=True)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    flat = _flat(leaves)
    grads = torch.autograd.grad(loss, list(flat.values()))
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    assert set(want) == set(flat)
    tol = 2e-4 if cfg is WIDE_HEADS and init > 0.1 else 1e-5
    for (name, _), g in zip(flat.items(), grads):
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(),
                                   err_msg=name)


def _jax_train(cfg, steps, o2, ids, labels):
    jm, tree, _ = _models(cfg)
    if o2:
        jm = jax_amp.decorate(jm, level="O2", dtype="bfloat16")
    opt = jax_optim.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                          weight_decay=0.01, multi_precision=o2)
    step = JaxTrainStep(jm, opt, loss_fn=None)
    losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels))
                    .item()) for _ in range(steps)]
    params, _ = extract_params(jm)
    return tree, losses, _flat(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params))


def _port_params(pm):
    return {n: p.detach().float().numpy().copy()
            for n, p in pm.gpt.named_parameters()}


def _port_train(cfg, tree, steps, o2, ids, labels, initial=None):
    """(losses, parameters after `steps`, model); `initial`, a dict,
    receives the parameters before the first step."""
    pm = port_gpt.GPTForCausalLM(port_gpt.GPTConfig(remat=False, **cfg),
                                 device="cpu")
    load_reference_params(pm, tree)
    if o2:
        pm = amp.decorate(pm, level="O2", dtype="bfloat16")
    if initial is not None:
        initial.update(_port_params(pm))
    opt = AdamW(learning_rate=1e-3, parameters=pm.parameters(),
                weight_decay=0.01, multi_precision=o2)
    step = TrainStepCompiler(pm, opt)
    losses = [float(step(ids, labels)) for _ in range(steps)]
    return losses, _port_params(pm), pm


@pytest.mark.parametrize("cfg", [TINY, WIDE_HEADS],
                         ids=["head_dim16_dense", "head_dim64_flash"])
def test_three_adamw_steps_match_jax_f32(cfg):
    ids, labels = _batch(cfg)
    tree, jl, jp = _jax_train(cfg, 3, False, ids, labels)
    pl, pp, _ = _port_train(cfg, tree, 3, False, ids, labels)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[2] < pl[0]
    for name, want in jp.items():
        np.testing.assert_allclose(pp[name], want, rtol=0, atol=1e-4,
                                   err_msg=name)


def _update_gap(p0, got, want):
    """||(got - p0) - (want - p0)|| / ||want - p0||: how far one
    package's parameter change is from the other's, relative to its
    size. A port that never updates scores 1."""
    return (np.linalg.norm((got - p0) - (want - p0))
            / np.linalg.norm(want - p0))


def test_three_adamw_steps_match_jax_bf16_o2():
    cfg = WIDE_HEADS
    ids, labels = _batch(cfg)
    tree, jl, jp = _jax_train(cfg, 3, True, ids, labels)
    p0 = {}
    pl, pp, pm = _port_train(cfg, tree, 3, True, ids, labels, initial=p0)
    # the loss falls ~20% over the three steps
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert pl[2] < 0.9 * pl[0]
    for name, want in jp.items():
        np.testing.assert_allclose(pp[name], want, rtol=8e-3,
                                   atol=2 * 1e-3 * 3, err_msg=name)
        got, start = pp[name], p0[name]
        if name == "blocks.qkv_b":       # [L, 3H]: drop the key third
            h = want.shape[-1] // 3
            got, want, start = (np.concatenate([a[:, :h], a[:, 2 * h:]], -1)
                                for a in (got, want, start))
        assert np.abs(want - start).max() > 0, name
        gap = _update_gap(start, got, want)
        assert gap <= 0.15, (name, gap)
        # no update at all is a gap of 1
        assert _update_gap(start, start, want) > 0.15
    dtypes = {n: p.dtype for n, p in pm.gpt.named_parameters()}
    assert dtypes["blocks.qkv_w"] == torch.bfloat16


def test_decorate_keeps_layer_norm_f32():
    pm = amp.decorate(port_gpt.GPTForCausalLM(
        port_gpt.GPTConfig(**TINY), device="cpu"))
    for name, p in pm.gpt.named_parameters():
        ln = name.split(".")[-1].startswith(("ln1_", "ln2_", "lnf_"))
        assert p.dtype == (torch.float32 if ln else torch.bfloat16), name
    # norm layers keep f32 as the reference's pure_fp16_initialize does
    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4))
    amp.decorate(net)
    assert net[0].weight.dtype == torch.bfloat16
    assert net[1].weight.dtype == torch.float32
    # same Parameter objects: an optimizer built before still holds them
    before = [id(p) for p in net.parameters()]
    amp.decorate(net, level="O2", dtype="float16")
    assert [id(p) for p in net.parameters()] == before


def test_remat_gives_the_same_grads():
    cfg = dict(WIDE_HEADS, dropout=0.0)
    ids, labels = _batch(cfg)
    grads = []
    for remat in (False, True):
        _, _, pm = _models(cfg, remat=remat)
        loss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
        loss.backward()
        grads.append({n: p.grad for n, p in pm.gpt.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_dropout_zero_is_identity_and_p_is_inverted():
    _, _, pm = _models(TINY)
    ids = torch.from_numpy(_batch(TINY)[0])
    pm.train()
    with torch.no_grad():
        a = pm(ids)
        pm.eval()
        b = pm(ids)
    assert torch.equal(a, b)
    x = torch.full((200, 500), 3.0)
    gen = torch.Generator().manual_seed(7)
    y = port_gpt._dropout(x, 0.25, gen)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 4.0))
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    y2 = port_gpt._dropout(x, 0.25, torch.Generator().manual_seed(7))
    assert torch.equal(y, y2)
    assert port_gpt._dropout(x, 0.0, gen) is x


def test_dropout_masks_come_from_the_model_generator_and_replay_in_remat():
    cfg = dict(WIDE_HEADS, dropout=0.3)
    ids, labels = (torch.from_numpy(a) for a in _batch(cfg))
    grads, losses = [], []
    for remat in (False, True):
        _, _, pm = _models(cfg, remat=remat)
        pm.gpt.dropout_generator.manual_seed(11)
        loss = pm(ids, labels)
        loss.backward()
        losses.append(float(loss))
        grads.append([p.grad for p in pm.parameters()])
        pm.eval()
        with torch.no_grad():
            assert float(pm(ids, labels)) != losses[-1]
    assert losses[0] == losses[1]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # another generator state draws other masks
    pm.train()
    pm.gpt.dropout_generator.manual_seed(12)
    assert float(pm(ids, labels)) != losses[0]


def test_adam_rules_match_jax_update():
    rng = np.random.RandomState(9)
    p, g, m, v = (rng.randn(37).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    for jcls, pcls, kw in ((jax_optim.Adam, Adam, {}),
                           (jax_optim.AdamW, AdamW, {"weight_decay": 0.1})):
        jo = jcls(learning_rate=0.01, parameters=[], **kw)
        po = pcls(learning_rate=0.01, parameters=[], **kw)
        slots = {"moment1": m, "moment2": v, "beta1_pow": np.float32(0.9),
                 "beta2_pow": np.float32(0.999)}
        jp, js = jo._update(jax.numpy.asarray(p), jax.numpy.asarray(g),
                            slots, np.float32(0.01))
        tp, ts = po._update(torch.from_numpy(p), torch.from_numpy(g),
                            {k: torch.tensor(s) for k, s in slots.items()},
                            0.01)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7)


def test_optimizer_state_dict_and_queued_options():
    lin = torch.nn.Linear(3, 2)
    opt = AdamW(1e-2, parameters=lin.named_parameters(),
                apply_decay_param_fun=lambda n: n == "weight")
    lin(torch.ones(4, 3)).sum().backward()
    bias_before = lin.bias.detach().clone()
    opt.step()
    sd = opt.state_dict()
    assert sd["@step"] == 1 and set(sd) == {
        "@step", *(f"{n}.{s}" for n in ("weight", "bias")
                   for s in ("moment1", "moment2", "beta1_pow",
                             "beta2_pow"))}
    # bias is not decayed: its update is the plain Adam step of -lr
    torch.testing.assert_close(lin.bias.detach(), bias_before - 1e-2)
    opt2 = AdamW(1e-2, parameters=lin.named_parameters())
    opt2.set_state_dict(sd)
    assert opt2.state_dict()["@step"] == 1
    torch.testing.assert_close(opt2.state_dict()["weight.moment1"],
                               sd["weight.moment1"])
    opt.clear_grad()
    assert lin.weight.grad is None
    with pytest.raises(NotImplementedError):
        AdamW(1e-3, parameters=lin.parameters(), grad_clip=object())
    with pytest.raises(NotImplementedError):
        AdamW(object(), parameters=lin.parameters())
    with pytest.raises(NotImplementedError):
        AdamW(1e-3, parameters=[{"params": list(lin.parameters())}])
    for kw in ({"accumulate_steps": 2}, {"steps_per_dispatch": 4},
               {"guard_nonfinite": True}, {"grad_scaler": object()},
               {"amp_level": "O1"}):
        with pytest.raises(NotImplementedError):
            TrainStepCompiler(lin, opt, **kw)


def test_train_step_with_loss_fn_and_cuda_default():
    lin = torch.nn.Linear(4, 1)
    opt = Adam(0.1, parameters=lin.parameters())
    step = TrainStepCompiler(
        lin, opt, lambda out, y: ((out[:, 0] - y) ** 2).mean())
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = x.sum(1)
    losses = [float(step(x, y)) for _ in range(20)]
    assert losses[-1] < losses[0]
    assert step(x, y).requires_grad is False
