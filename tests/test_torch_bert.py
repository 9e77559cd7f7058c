"""The port's BERT pretraining path held against the JAX package's.

The same numpy weights (carried by `convert.load_reference_state_dict`)
and the same numpy batches go through `paddle_tpu` and
`paddle_tpu_torch` in one process, on the CPU, where the port's kernel
wrappers run their plain versions. The size is `bench_bert`'s CPU
config: vocab 512, hidden 128, 2 layers, 2 heads (head_dim 64, so the
port's unmasked attention takes the flash route), ffn 256, S 128, B 2.

Tolerances:

  * f32: outputs and losses within 1e-5 relative, every gradient within
    1e-4 x the max|g| of that gradient. The two differ in summation
    order only: the port's unmasked attention is the flash kernels'
    plain versions (online softmax, p recomputed from lse), JAX's the
    dense softmax it takes off the TPU;
  * bf16 O2 (`amp.decorate` on both, the JAX side on its Pallas
    LayerNorm route, `PADDLE_PALLAS_FUSION=1`, interpreted, as the port
    follows that route): the loss within 1e-3 relative and each gradient
    within 1e-1 x its max|g| (measured: 6.6e-5 and 3.2e-2, the worst
    gradient the token-type embedding's). The packages round bf16 at
    other places (XLA fuses elementwise chains in f32 and rounds once;
    PyTorch rounds after each op), and a one-ulp difference (2^-8
    relative) in a block's output carries through the rest of the
    network;
  * O1 (`amp.auto_cast` around the forward): the JAX Pallas LayerNorm
    route refuses BERT's bf16-x / f32-residual epilogue (ROADMAP queue
    3), so the JAX side takes its fallback route, which keeps that sum
    and the residual stream after it in f32 where the port (and the
    Pallas kernel) store them in bf16: the loss within 1e-3 relative,
    each gradient within 6e-2 x its max|g| (measured: 3.3e-5 and
    1.7e-2). These limits alone would pass an f32 port (its distance
    from the port's O1: 6.4e-5 and 1.2e-2), so the O1 tests also hold
    that O1 moves the port's loss off its f32 loss and that the flash
    route runs on bf16 q/k/v.

Dropout > 0 has no bit parity with JAX: the masks come from a
`torch.Generator`, not JAX's key. It is held to its own properties.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jax_amp
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate import nn as jax_inn
from paddle_tpu.ops import linalg as jax_linalg
from paddle_tpu.text.models import bert as jax_bert

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.incubate import nn as port_inn
from paddle_tpu_torch.incubate.nn import attention as port_attention
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import linalg as port_linalg
from paddle_tpu_torch.text.models import bert as port_bert

CPU_CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
               ffn_hidden=256, max_seq_len=128, dropout=0.0)
B, S = 2, 128
F32_REL = 1e-5
F32_GRAD = 1e-4


def _np(t):
    """numpy f32 of a JAX-package tensor, a torch tensor or None."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value if hasattr(t, "_value") else t, np.float32)


def _close(got, want, rel, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


def _grads_close(gp, gj, rel):
    assert set(gp) == set(gj)
    for name in gj:
        want, got = gj[name], gp[name]
        if want is None or got is None:
            # a parameter the loss does not reach: no gradient in either
            assert want is None and got is None, name
            continue
        _close(got, want, rel, name)


def _jt(arr, grad=False):
    return paddle.to_tensor(arr, stop_gradient=not grad)


def _tt(arr, grad=False):
    t = torch.from_numpy(np.array(arr))
    return t.requires_grad_() if grad else t


def _batch(seed=0, vocab=512, b=B, s=S):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = ids.copy()
    labels[rng.rand(b, s) < 0.3] = -1          # ignored by the MLM loss
    tt = rng.randint(0, 2, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[1, s - 40:] = 0                       # padding in one sequence
    nsp = rng.randint(0, 2, (b,)).astype(np.int64)
    return ids, tt, labels, mask, nsp


def _models(dtype_level=None, cfg=CPU_CFG):
    """(JAX BertForPretraining, port BertForPretraining) with the same
    f32 weights, both decorated O2 when `dtype_level` is "O2"."""
    paddle.seed(0)
    jm = jax_bert.BertForPretraining(jax_bert.BertConfig(**cfg))
    flat = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    pm = port_bert.BertForPretraining(port_bert.BertConfig(**cfg),
                                      device="cpu")
    load_reference_state_dict(pm, flat)
    if dtype_level == "O2":
        jm = jax_amp.decorate(jm, level="O2", dtype="bfloat16")
        pm = amp.decorate(pm, level="O2", dtype="bfloat16")
    return jm, pm


def _jax_loss_grads(jm, batch, with_mask, with_nsp, amp_level=None):
    ids, tt, labels, mask, nsp = batch
    kw = dict(token_type_ids=_jt(tt), masked_lm_labels=_jt(labels))
    if with_mask:
        kw["attention_mask"] = _jt(mask)
    if with_nsp:
        kw["next_sentence_label"] = _jt(nsp)
    for p in jm.parameters():
        p.clear_grad()
    if amp_level == "O1":
        with jax_amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = jm(_jt(ids), **kw)
    else:
        loss = jm(_jt(ids), **kw)
    loss.backward()
    return float(_np(loss)), {n: (None if p.grad is None else _np(p.grad))
                              for n, p in jm.named_parameters()}


def _port_loss_grads(pm, batch, with_mask, with_nsp, amp_level=None):
    ids, tt, labels, mask, nsp = batch
    kw = dict(token_type_ids=tt, masked_lm_labels=labels)
    if with_mask:
        kw["attention_mask"] = mask
    if with_nsp:
        kw["next_sentence_label"] = nsp
    named = list(pm.named_parameters())
    if amp_level == "O1":
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = pm(ids, **kw)
    else:
        loss = pm(ids, **kw)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return float(loss), {n: (None if g is None else _np(g))
                         for (n, _), g in zip(named, grads)}


# -- module 2: the functional ops ---------------------------------------
def _op_pair(jfn, pfn, arrays, grad_idx, cot_seed=7):
    """Run one op in both packages on the same arrays; return ((JAX
    out, grads), (port out, grads)) for the inputs in `grad_idx`, the
    gradients of sum(out * C) for a fixed random C."""
    jx = [_jt(a, i in grad_idx) for i, a in enumerate(arrays)]
    px = [_tt(a, i in grad_idx) for i, a in enumerate(arrays)]
    jo, po = jfn(*jx), pfn(*px)
    c = np.asarray(np.random.RandomState(cot_seed).randn(*po.shape),
                   np.float32)
    (paddle.sum(jo.astype("float32") * _jt(c))).backward()
    (po.float() * torch.from_numpy(c)).sum().backward()
    return ((jo, [jx[i].grad for i in grad_idx]),
            (po, [px[i].grad for i in grad_idx]))


def _assert_op(jfn, pfn, arrays, grad_idx, rel=F32_REL):
    (jo, jg), (po, pg) = _op_pair(jfn, pfn, arrays, grad_idx)
    assert str(po.dtype).split(".")[-1] == str(np.asarray(jo._value).dtype)
    _close(po, jo, rel, "out")
    for i, (a, b) in enumerate(zip(pg, jg)):
        _close(a, b, F32_GRAD, f"grad {i}")


def test_linear_matches_jax():
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(*s).astype(np.float32)
               for s in ((2, 5, 16), (16, 24), (24,)))
    _assert_op(JF.linear, PF.linear, [x, w, b], (0, 1, 2))
    _assert_op(lambda x, w: JF.linear(x, w), lambda x, w: PF.linear(x, w),
               [x, w], (0, 1))


def test_matmul_transposes_and_promotes_as_jax():
    rng = np.random.RandomState(1)
    x, y = rng.randn(3, 4, 6).astype(np.float32), \
        rng.randn(3, 5, 6).astype(np.float32)
    _assert_op(lambda a, b: jax_linalg.matmul(a, b, transpose_y=True),
               lambda a, b: port_linalg.matmul(a, b, transpose_y=True),
               [x, y], (0, 1))
    xt = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    _assert_op(lambda a, b: jax_linalg.matmul(a, b, transpose_x=True,
                                              transpose_y=True),
               lambda a, b: port_linalg.matmul(a, b, transpose_x=True,
                                               transpose_y=True),
               [xt, y], (0, 1))
    # an f32 activation against a bf16 weight: f32, as jnp promotes
    jo = jax_linalg.matmul(_jt(x), _jt(y).astype("bfloat16"),
                           transpose_y=True)
    po = port_linalg.matmul(_tt(x), _tt(y).bfloat16(), transpose_y=True)
    assert po.dtype == torch.float32 and str(jo.dtype).endswith("float32")
    _close(po, jo, F32_REL)


def test_embedding_matches_jax():
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 10, (3, 7)).astype(np.int64)
    w = rng.randn(10, 8).astype(np.float32)
    _assert_op(JF.embedding, PF.embedding, [ids, w], (1,))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.random.RandomState(3).randn(4, 33).astype(np.float32) * 3
    if approximate:
        _assert_op(lambda v: JF.gelu(v, approximate=True),
                   lambda v: PF.gelu(v, approximate=True), [x], (0,))
    else:                      # the default is the erf form
        _assert_op(JF.gelu, PF.gelu, [x], (0,))


def test_tanh_matches_jax():
    x = np.random.RandomState(4).randn(4, 9).astype(np.float32)
    _assert_op(JF.tanh, PF.tanh, [x], (0,))


def test_cross_entropy_ignore_index_matches_jax():
    """The mean over the kept labels, with ignore_index -1 (the MLM
    loss's)."""
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 9, 11).astype(np.float32) * 2
    labels = rng.randint(0, 11, (2, 9)).astype(np.int64)
    labels[0, :4] = -1
    _assert_op(lambda lg, lb: JF.cross_entropy(lg, lb, ignore_index=-1),
               lambda lg, lb: PF.cross_entropy(lg, lb, ignore_index=-1),
               [logits, labels], (0,))
    # the label with a trailing class axis, the default ignore_index
    _assert_op(JF.cross_entropy, PF.cross_entropy,
               [logits, labels[..., None].clip(0)], (0,))
    # every label ignored: the mean divides by max(count, 1)
    none = np.full_like(labels, -1)
    assert float(PF.cross_entropy(_tt(logits), _tt(none),
                                  ignore_index=-1)) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """f32 within 1e-5; bf16: the normalised value rounds to bf16 before
    the f32 affine step in both (one bf16 ulp where the f32 statistics
    round the other way)."""
    rng = np.random.RandomState(6)
    x = rng.randn(4, 64).astype(np.float32) * 2 + 0.5
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    if dtype == "float32":
        _assert_op(lambda v, w, b: JF.layer_norm(v, 64, w, b, 1e-5),
                   lambda v, w, b: PF.layer_norm(v, 64, w, b, 1e-5),
                   [x, w, b], (0, 1, 2))
        return
    jo = JF.layer_norm(_jt(x).astype("bfloat16"), 64, _jt(w), _jt(b), 1e-5)
    po = PF.layer_norm(_tt(x).bfloat16(), 64, _tt(w), _tt(b), 1e-5)
    # a bf16 row times an f32 weight: f32, in both
    assert po.dtype == torch.float32 and str(jo.dtype).endswith("float32")
    _close(po, jo, 2 ** -7)
    # and not torch's layer_norm, which rounds once at the end
    tl = torch.nn.functional.layer_norm(_tt(x).bfloat16(), (64,),
                                        _tt(w).bfloat16(), _tt(b).bfloat16())
    assert not torch.equal(tl.float(), po.float())


def test_dropout_identity_when_off_and_generator_determinism():
    x = torch.randn(64, 256)
    assert PF.dropout(x, 0.0) is x
    assert PF.dropout(x, 0.5, training=False) is x
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    a = PF.dropout(x, 0.3, generator=g1)
    b = PF.dropout(x, 0.3, generator=g2)
    assert torch.equal(a, b)
    keep = a != 0
    rate = float(keep.float().mean())
    assert abs(rate - 0.7) < 0.01, rate
    torch.testing.assert_close(a[keep], x[keep] / 0.7)
    c = PF.dropout(x, 0.3, generator=torch.Generator().manual_seed(12))
    assert not torch.equal(a, c)


# -- SDPA routing -------------------------------------------------------
def _qkv(seed, b=2, h=2, s=128, d=64):
    rng = np.random.RandomState(seed)
    return [(0.5 * rng.randn(b, h, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("case", ["unmasked", "masked", "causal"])
def test_sdpa_matches_jax_on_each_route(case, monkeypatch):
    q, k, v = _qkv(8)
    mask = None
    if case == "masked":
        m = np.ones((2, 1, 1, 128), np.float32)
        m[1, ..., 90:] = 0
        mask = (1.0 - m) * -1e4
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    causal = case == "causal"
    arrays = [q, k, v] + ([] if mask is None else [mask])

    def jf(q, k, v, m=None):
        return JF.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               is_causal=causal)

    def pf(q, k, v, m=None):
        return PF.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               is_causal=causal)

    _assert_op(jf, pf, arrays, (0, 1, 2))
    # no mask, no dropout, head_dim 64: the flash route (on the CPU its
    # plain versions); a mask: the dense route
    assert len(calls) == (0 if case == "masked" else 1)


def test_sdpa_routing_rules():
    assert port_attention.uses_flash((2, 2, 128, 64), (2, 2, 128, 64),
                                     False, 0.0, False)
    assert port_attention.uses_flash((2, 2, 100, 128), (2, 2, 333, 128),
                                     False, 0.0, False)
    assert not port_attention.uses_flash((2, 2, 128, 64), (2, 2, 128, 64),
                                         True, 0.0, False)
    assert not port_attention.uses_flash((2, 2, 128, 64), (2, 2, 128, 64),
                                         False, 0.1, False)
    # head_dim 256 is the JAX TPU kernel's only: the port's kernels take
    # 64 and 128
    assert not port_attention.uses_flash((2, 2, 128, 256),
                                         (2, 2, 128, 256), False, 0.0, False)
    assert not port_attention.uses_flash((2, 2, 100, 64), (2, 2, 128, 64),
                                         False, 0.0, True)


def test_sdpa_dropout_is_deterministic_for_a_generator():
    q, k, v = (_tt(a) for a in _qkv(9, s=64))

    def run(seed, training=True):
        return PF.scaled_dot_product_attention(
            q, k, v, dropout_p=0.25, training=training,
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    # outside training no dropout: the flash route, equal to p = 0
    torch.testing.assert_close(
        run(1, training=False), PF.scaled_dot_product_attention(q, k, v))


# -- the fused layers ----------------------------------------------------
def _layer_pair(kind, normalize_before):
    """(JAX layer, port layer) with the same weights; f32, dropout 0."""
    paddle.seed(1)
    if kind == "attn":
        jl = jax_inn.FusedMultiHeadAttention(
            128, 2, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=normalize_before)
        pl = port_inn.FusedMultiHeadAttention(
            128, 2, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=normalize_before, device="cpu")
    elif kind == "ffn":
        jl = jax_inn.FusedFeedForward(128, 256, dropout_rate=0.0,
                                      activation="gelu",
                                      normalize_before=normalize_before)
        pl = port_inn.FusedFeedForward(128, 256, dropout_rate=0.0,
                                       activation="gelu",
                                       normalize_before=normalize_before,
                                       device="cpu")
    else:
        jl = jax_inn.FusedTransformerEncoderLayer(
            128, 2, 256, dropout_rate=0.0, activation="gelu",
            normalize_before=normalize_before)
        pl = port_inn.FusedTransformerEncoderLayer(
            128, 2, 256, dropout_rate=0.0, activation="gelu",
            normalize_before=normalize_before, device="cpu")
    flat = {n: np.asarray(p) for n, p in jl.state_dict().items()}
    # non-trivial LayerNorm scales and biases, so their gradients mean
    # something
    rng = np.random.RandomState(3)
    for n in flat:
        if "ln" in n:
            flat[n] = (flat[n] + 0.1 * rng.randn(*flat[n].shape)).astype(
                np.float32)
    jl.set_state_dict({n: paddle.to_tensor(a) for n, a in flat.items()})
    load_reference_state_dict(pl, flat)
    return jl, pl


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("kind", ["attn", "ffn", "encoder"])
def test_fused_layers_match_jax(kind, normalize_before):
    jl, pl = _layer_pair(kind, normalize_before)
    x = np.random.RandomState(4).randn(2, 128, 128).astype(np.float32)
    c = np.random.RandomState(5).randn(2, 128, 128).astype(np.float32)
    jx, px = _jt(x, True), _tt(x, True)
    jo, po = jl(jx), pl(px)
    _close(po, jo, F32_REL, "out")
    paddle.sum(jo * _jt(c)).backward()
    named = list(pl.named_parameters())
    grads = torch.autograd.grad((po * torch.from_numpy(c)).sum(),
                                [px] + [p for _, p in named],
                                allow_unused=True)
    _close(grads[0], jx.grad, F32_GRAD, "dx")
    jg = {n: (None if p.grad is None else _np(p.grad))
          for n, p in jl.named_parameters()}
    _grads_close({n: (None if g is None else _np(g))
                  for (n, _), g in zip(named, grads[1:])}, jg, F32_GRAD)


def test_fused_layer_norm_functional_matches_jax():
    """The three fused LayerNorm entry points against the JAX package's
    (its fallback composition here; in f32 the same function)."""
    from paddle_tpu.incubate.nn import functional as JIF

    from paddle_tpu_torch.incubate.nn import functional as PIF

    rng = np.random.RandomState(12)
    x, r = (rng.randn(3, 5, 128).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    b = (0.1 * rng.randn(128)).astype(np.float32)
    _assert_op(lambda x, w, b: JIF.fused_layer_norm(x, w, b, 1e-12),
               lambda x, w, b: PIF.fused_layer_norm(x, w, b, 1e-12),
               [x, w, b], (0, 1, 2))
    _assert_op(lambda x, w, b: JIF.fused_layer_norm_gelu(x, w, b),
               lambda x, w, b: PIF.fused_layer_norm_gelu(x, w, b),
               [x, w, b], (0, 1, 2))
    _assert_op(lambda x, r, w, b: JIF.fused_residual_layer_norm(
                   x, r, w, b)[0] * 2 + JIF.fused_residual_layer_norm(
                   x, r, w, b)[1],
               lambda x, r, w, b: PIF.fused_residual_layer_norm(
                   x, r, w, b)[0] * 2 + PIF.fused_residual_layer_norm(
                   x, r, w, b)[1],
               [x, r, w, b], (0, 1, 2, 3))


# -- BertForPretraining --------------------------------------------------
@pytest.fixture(scope="module")
def f32_models():
    return _models()


@pytest.mark.parametrize("with_mask,with_nsp", [(False, False), (True, True)])
def test_bert_f32_loss_and_every_gradient_match_jax(f32_models, with_mask,
                                                    with_nsp):
    jm, pm = f32_models
    batch = _batch()
    lj, gj = _jax_loss_grads(jm, batch, with_mask, with_nsp)
    lp, gp = _port_loss_grads(pm, batch, with_mask, with_nsp)
    assert abs(lp - lj) <= F32_REL * abs(lj), (lp, lj)
    _grads_close(gp, gj, F32_GRAD)
    # the unused pre-LN parameters get no gradient; with NSP the pooler
    # and the NSP head do
    assert gp["bert.encoder.0.fused_attn.pre_ln_scale"] is None
    assert (gp["nsp.weight"] is not None) == with_nsp


def test_bert_logits_and_mask_path_match_jax(f32_models):
    """Without labels: (MLM logits, NSP logits); a padded sequence's
    mask changes its outputs and not the other sequence's."""
    jm, pm = f32_models
    ids, tt, _, mask, _ = _batch(seed=1)
    jl, jn = jm(_jt(ids), token_type_ids=_jt(tt), attention_mask=_jt(mask))
    pl, pn = pm(ids, token_type_ids=tt, attention_mask=mask)
    _close(pl, jl, F32_REL, "mlm logits")
    _close(pn, jn, F32_REL, "nsp logits")
    pl0, _ = pm(ids, token_type_ids=tt)
    torch.testing.assert_close(pl0[0], pl[0], rtol=1e-5, atol=1e-5)
    assert float((pl0[1] - pl[1]).abs().max()) > 1e-3


def test_bert_parameter_names_and_load_checks(f32_models):
    jm, pm = f32_models
    assert [n for n, _ in pm.named_parameters()] == [
        n for n, _ in jm.named_parameters()]
    flat = {n: np.asarray(p) for n, p in jm.state_dict().items()}
    fresh = port_bert.BertForPretraining(port_bert.BertConfig(**CPU_CFG),
                                         device="cpu")
    with pytest.raises(ValueError, match="missing"):
        load_reference_state_dict(fresh, {k: v for k, v in flat.items()
                                          if k != "mlm_bias"})
    with pytest.raises(ValueError, match="unexpected"):
        load_reference_state_dict(fresh, dict(flat, extra=np.zeros(2)))
    with pytest.raises(ValueError, match="shape"):
        load_reference_state_dict(fresh, dict(flat, mlm_bias=np.zeros(3)))


def test_bert_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_bert.BertForPretraining(port_bert.BertConfig(**CPU_CFG))


def test_bert_o2_matches_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_FUSION", "1")
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    jm, pm = _models("O2")
    # the fused layers' LayerNorm scales are bf16, the LayerNorm layers'
    # f32, in both packages
    for name, p in pm.named_parameters():
        jp = dict(jm.named_parameters())[name]
        assert str(p.dtype).split(".")[-1] == str(np.asarray(jp).dtype), name
    assert pm.bert.encoder[0].fused_attn.ln_scale.dtype == torch.bfloat16
    assert pm.bert.encoder[0].ffn.ln2_scale.dtype == torch.bfloat16
    assert pm.bert.embeddings.layer_norm.weight.dtype == torch.float32
    assert pm.mlm_norm.weight.dtype == torch.float32
    assert pm.mlm_bias.dtype == torch.bfloat16
    batch = _batch(seed=2)
    lj, gj = _jax_loss_grads(jm, batch, False, False)
    lp, gp = _port_loss_grads(pm, batch, False, False)
    assert abs(lp - lj) <= 1e-3 * abs(lj), (lp, lj)
    _grads_close(gp, gj, 1e-1)


def test_bert_o1_matches_jax_fallback_route():
    jm, pm = _models()
    batch = _batch(seed=3)
    lj, gj = _jax_loss_grads(jm, batch, False, False, amp_level="O1")
    lp, gp = _port_loss_grads(pm, batch, False, False, amp_level="O1")
    assert abs(lp - lj) <= 1e-3 * abs(lj), (lp, lj)
    _grads_close(gp, gj, 6e-2)
    # the f32 parameters get f32 gradients; O1 moved the loss off f32's
    lf, _ = _port_loss_grads(pm, batch, False, False)
    assert lp != lf


def test_bert_o1_flash_runs_on_bf16(monkeypatch):
    """Under O1 the unmasked attention takes the flash route on bf16
    q/k/v, once a layer."""
    _, pm = _models()
    seen = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, *a, **kw: (
        seen.append(q.dtype) or real(q, k, v, *a, **kw)))
    ids, tt, labels, _, _ = _batch(seed=4)
    with amp.auto_cast(level="O1"):
        loss = pm(ids, token_type_ids=tt, masked_lm_labels=labels)
    assert seen == [torch.bfloat16] * CPU_CFG["num_layers"]
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))


def test_bert_dropout_is_deterministic_and_live_in_training():
    cfg = dict(CPU_CFG, dropout=0.1)
    ids, tt, labels, _, _ = _batch(seed=5)

    def loss_of(seed, train=True):
        m = port_bert.BertForPretraining(
            port_bert.BertConfig(**cfg), device="cpu",
            generator=torch.Generator().manual_seed(seed))
        m.train(train)
        return float(m(ids, token_type_ids=tt, masked_lm_labels=labels))

    assert loss_of(0) == loss_of(0)
    # dropout 0.1 on: the loss differs from the eval-mode loss of the
    # same weights
    assert loss_of(0) != loss_of(0, train=False)


def test_bert_trains_through_the_train_step():
    """Three AdamW steps through TrainStepCompiler, f32, against the JAX
    package's: the losses within 1e-4 relative."""
    from paddle_tpu.jit import TrainStepCompiler as JaxStep
    import paddle_tpu.optimizer as jax_optim

    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    jm, pm = _models()
    ids, tt, labels, _, _ = _batch(seed=6)

    class JaxWrap(paddle.nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, tt, labels):
            return self.m(ids, token_type_ids=tt, masked_lm_labels=labels)

    class PortWrap(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, tt, labels):
            return self.m(ids, token_type_ids=tt, masked_lm_labels=labels)

    jw, pw = JaxWrap(jm), PortWrap(pm)
    jstep = JaxStep(jw, jax_optim.AdamW(learning_rate=1e-3,
                                        parameters=jw.parameters(),
                                        weight_decay=0.01))
    pstep = TrainStepCompiler(pw, AdamW(1e-3, parameters=pw.parameters(),
                                        weight_decay=0.01))
    lj = [float(_np(jstep(_jt(ids), _jt(tt), _jt(labels))))
          for _ in range(3)]
    lp = [float(pstep(ids, tt, labels)) for _ in range(3)]
    np.testing.assert_allclose(lp, lj, rtol=1e-4)
    assert lp[-1] < lp[0]
