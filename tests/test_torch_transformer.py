"""`paddle_tpu_torch.nn`'s `Layer`, `ParamAttr`, activation layers and
Transformer family against the JAX package's.

Every layer is built on both sides at 2 + 2 layers, d_model 64, 4
heads, FFN 128, dropout 0, with the JAX layer's weights carried across
(`convert.load_reference_state_dict`, name for name). Outputs are held
within 1e-5 relative (absolute floor 1e-5), gradients of every
parameter and input within 1e-4 x max|g| (the largest of the call's
gradients: a key projection's bias has a true gradient of 0), with the
same seeded cotangent. The cases: `MultiHeadAttention` (self, cross
with sq != sk, an additive mask, the bool-mask probe of ROADMAP queue 3
#30, cache concat), each encoder and decoder layer pre- and post-norm,
`Transformer` with `generate_square_subsequent_mask`, and incremental
decode through `gen_cache` against full recompute. Then `Layer`'s
methods against the JAX `Layer` on the same tree, `ParamAttr`, the
activation layers, per-layer dropout masks, and negative controls (a
cache concat that drops the past, a deep copy whose weights differ, a
generator held per layer) that must fail the comparisons above.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn as jnn
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import convert

D, H, FF = 64, 4, 128
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _carry(jl, pl):
    sd = {k: np.asarray(v._value) for k, v in jl.state_dict().items()}
    assert list(sd) == list(pl.state_dict())
    convert.load_reference_state_dict(pl, sd)
    return pl


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want._value) if isinstance(want, J.Tensor) else want
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _grads_close(jl, pl, jouts, pouts, jins, pins, seed=0):
    """d(sum out * cot) for every parameter and input, both sides."""
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in pouts]
    jps = [p for _, p in jl.named_parameters()]
    pps = [p for _, p in pl.named_parameters()]
    names = [n for n, _ in pl.named_parameters()]
    jg = J.grad(jouts, jps + jins, [J.to_tensor(c) for c in cots])
    pg = torch.autograd.grad(pouts, pps + pins,
                             [torch.from_numpy(c) for c in cots])
    jg = [np.asarray(b._value) for b in jg]
    # the scale is the largest |g| of all: a key projection's bias has a
    # true gradient of 0, and both sides give rounding noise there
    scale = max(float(np.abs(b).max()) for b in jg)
    for name, a, b in zip(names + [f"input{i}" for i in range(len(pins))],
                          pg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def _pair_inputs(*arrays):
    js = [J.to_tensor(a, stop_gradient=False) for a in arrays]
    ps = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    return js, ps


# -- MultiHeadAttention -------------------------------------------------------

def _mha():
    jl = jnn.MultiHeadAttention(D, H)
    pl = _carry(jl, pnn.MultiHeadAttention(D, H, device="cpu"))
    return jl, pl


MASK = np.where(np.random.RandomState(9).rand(1, 1, 6, 6) > 0.3, 0.0,
                -1e9).astype(np.float32)


@pytest.mark.parametrize("case", ["self", "cross", "additive_mask",
                                  "bool_mask"])
def test_multi_head_attention(case):
    jl, pl = _mha()
    q = _x(1, 2, 6, D)
    kv = _x(2, 2, 9 if case == "cross" else 6, D)
    (jq, jkv), (pq, pkv) = _pair_inputs(q, kv)
    mask = None
    if case == "additive_mask":
        mask = MASK
    elif case == "bool_mask":
        mask = MASK == 0.0
    jm = None if mask is None else J.to_tensor(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    if case == "self":
        jo, po = jl(jq), pl(pq)
        jins, pins = [jq], [pq]
    else:
        jo, po = jl(jq, jkv, jkv, jm), pl(pq, pkv, pkv, pm)
        jins, pins = [jq, jkv], [pq, pkv]
    _close(po, jo, OUT_TOL, case)
    _grads_close(jl, pl, [jo], [po], jins, pins)
    if case == "bool_mask":
        # queue 3 #30: the reference adds a bool mask's 0 / 1 to the
        # logits, so it masks nothing: the output is not the masked one
        masked = pl(pq, pkv, pkv, torch.from_numpy(MASK))
        assert (po - masked).abs().max() > 1e-2
        shifted = pl(pq, pkv, pkv, torch.from_numpy(mask.astype(
            np.float32)))
        torch.testing.assert_close(po, shifted, rtol=0, atol=0)


def _cached_steps(layer, q_steps, to_t, cache):
    outs = []
    for step in q_steps:
        out, cache = layer(to_t(step), to_t(step), to_t(step), None, cache)
        outs.append(out)
    return outs, cache


def test_multi_head_attention_cache_concat():
    """Three one-token steps through `gen_cache`: the outputs and the
    grown cache equal JAX's, and equal causal full attention's rows."""
    jl, pl = _mha()
    x = _x(3, 2, 3, D)
    steps = [x[:, i:i + 1] for i in range(3)]
    jouts, jc = _cached_steps(jl, steps, J.to_tensor,
                              jl.gen_cache(J.to_tensor(x)))
    pouts, pc = _cached_steps(pl, steps, torch.from_numpy,
                              pl.gen_cache(torch.from_numpy(x)))
    assert tuple(pc[0].shape) == (2, H, 3, D // H)
    for a, b in zip(pouts, jouts):
        _close(a, b, OUT_TOL, "step")
    for a, b in zip(pc, jc):
        _close(a, b, OUT_TOL, "cache")
    causal = np.triu(np.full((3, 3), -np.inf, np.float32), 1)
    full = pl(torch.from_numpy(x), attn_mask=torch.from_numpy(causal))
    _close(torch.cat(pouts, 1), full.detach().numpy(), OUT_TOL, "full")


# -- encoder / decoder layers -------------------------------------------------

@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
@pytest.mark.parametrize("kind", ["encoder_layer", "decoder_layer"])
def test_transformer_layers(kind, pre):
    src, tgt = _x(4, 2, 7, D), _x(5, 2, 5, D)
    mask = np.triu(np.full((5, 5), -np.inf, np.float32), 1)
    if kind == "encoder_layer":
        jl = jnn.TransformerEncoderLayer(D, H, FF, 0.0, "gelu",
                                         normalize_before=pre)
        pl = _carry(jl, pnn.TransformerEncoderLayer(
            D, H, FF, 0.0, "gelu", normalize_before=pre, device="cpu"))
        (js,), (ps,) = _pair_inputs(src)
        jo, po = jl(js), pl(ps)
        jins, pins = [js], [ps]
    else:
        jl = jnn.TransformerDecoderLayer(D, H, FF, 0.0,
                                         normalize_before=pre)
        pl = _carry(jl, pnn.TransformerDecoderLayer(
            D, H, FF, 0.0, normalize_before=pre, device="cpu"))
        (jt, jm), (pt, pm) = _pair_inputs(tgt, src)
        jo = jl(jt, jm, J.to_tensor(mask))
        po = pl(pt, pm, torch.from_numpy(mask))
        jins, pins = [jt, jm], [pt, pm]
    _close(po, jo, OUT_TOL, kind)
    _grads_close(jl, pl, [jo], [po], jins, pins)


def _transformers(pre=False, dropout=0.0):
    jt = jnn.Transformer(D, H, 2, 2, FF, dropout, normalize_before=pre)
    pt = _carry(jt, pnn.Transformer(D, H, 2, 2, FF, dropout,
                                    normalize_before=pre, device="cpu"))
    return jt, pt


@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_transformer_with_square_subsequent_mask(pre):
    jt, pt = _transformers(pre)
    jmask = jt.generate_square_subsequent_mask(5)
    pmask = pt.generate_square_subsequent_mask(5)
    _close(pmask, jmask, 0.0, "mask")
    (js, jg), (ps, pg) = _pair_inputs(_x(6, 2, 7, D), _x(7, 2, 5, D))
    jo = jt(js, jg, tgt_mask=jmask)
    po = pt(ps, pg, tgt_mask=pmask)
    _close(po, jo, OUT_TOL, "transformer")
    _grads_close(jt, pt, [jo], [po], [js, jg], [ps, pg])


def _decode(t, memory, tgt, cached, to_t):
    """The decoder's outputs for each prefix of tgt: with a cache, one
    token a step; else recomputed on the prefix under the causal mask."""
    n = tgt.shape[1]
    if cached:
        cache = t.decoder.gen_cache(memory)
        outs = []
        for i in range(n):
            out, cache = t.decoder(to_t(tgt[:, i:i + 1]), memory, None,
                                   None, cache)
            outs.append(out)
        return outs
    return [t.decoder(to_t(tgt[:, :i + 1]), memory,
                      t.generate_square_subsequent_mask(i + 1))[:, -1:]
            for i in range(n)]


def test_incremental_decode_matches_full_recompute():
    jt, pt = _transformers()
    src, tgt = _x(8, 2, 7, D), _x(9, 2, 4, D)
    jmem = jt.encoder(J.to_tensor(src))
    pmem = pt.encoder(torch.from_numpy(src))
    pc = _decode(pt, pmem, tgt, True, torch.from_numpy)
    pf = _decode(pt, pmem, tgt, False, torch.from_numpy)
    jc = _decode(jt, jmem, tgt, True, J.to_tensor)
    for i, (a, b, c) in enumerate(zip(pc, pf, jc)):
        _close(a, b.detach().numpy(), OUT_TOL, f"step {i} vs recompute")
        _close(a, c, OUT_TOL, f"step {i} vs JAX")


# -- negative controls --------------------------------------------------------

def test_negative_control_cache_concat_dropped():
    """A cache concat that keeps only this step's keys and values gives
    other decode outputs than full recompute: the comparison above
    catches it."""
    jt, pt = _transformers()
    pmem = pt.encoder(torch.from_numpy(_x(8, 2, 7, D)))
    tgt = _x(9, 2, 4, D)
    full = _decode(pt, pmem, tgt, False, torch.from_numpy)
    orig = pnn.MultiHeadAttention.forward

    def forgetful(self, query, key=None, value=None, attn_mask=None,
                  cache=None):
        if cache is not None:
            cache = tuple(c[:, :, :0] for c in cache)
        return orig(self, query, key, value, attn_mask, cache)

    pnn.MultiHeadAttention.forward = forgetful
    try:
        broken = _decode(pt, pmem, tgt, True, torch.from_numpy)
    finally:
        pnn.MultiHeadAttention.forward = orig
    with pytest.raises(AssertionError):
        for i, (a, b) in enumerate(zip(broken, full)):
            _close(a, b.detach().numpy(), OUT_TOL, f"step {i}")


def test_parameter_tree_loads_name_for_name():
    """A JAX `nn.Transformer`'s parameters as a nested tree load into
    the port's name for name, as its flat state dict does; a tree
    missing one name raises."""
    jt = jnn.Transformer(D, H, 2, 2, FF, 0.0)
    tree = {}
    for name, v in jt.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(v._value)
    pt = pnn.Transformer(D, H, 2, 2, FF, 0.0, device="cpu")
    convert.load_reference_state_dict(pt, tree)
    for name, v in pt.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jt.state_dict()[name]._value))
    del tree["decoder"]["layers"]["1"]["norm3"]["bias"]
    with pytest.raises(ValueError, match="norm3.bias"):
        convert.load_reference_state_dict(pt, tree)


def test_negative_control_deepcopy_weights():
    """The encoder's layers start equal to layer 0, as in JAX; a stack
    whose second layer is drawn anew no longer matches the JAX
    Transformer carried across name for name (its weights are then the
    JAX ones again), nor its own equal-weights start."""
    jt, pt = _transformers()
    enc = pt.encoder.layers
    for (na, a), (nb, b) in zip(enc[0].named_parameters(),
                                enc[1].named_parameters()):
        assert na == nb and a is not b
    fresh = pnn.TransformerEncoderLayer(D, H, FF, 0.0, device="cpu",
                                        generator=torch.Generator()
                                        .manual_seed(1))
    stack = pnn.TransformerEncoder(fresh, 2)
    sd = stack.state_dict()
    assert all(torch.equal(sd[k], sd[k.replace("layers.0", "layers.1")])
               for k in sd if k.startswith("layers.0"))
    src = _x(10, 2, 7, D)
    want = jt(J.to_tensor(src), J.to_tensor(src))
    broken = copy.deepcopy(pt)
    with torch.no_grad():
        for p in broken.encoder.layers[1].parameters():
            p.add_(0.05)
    with pytest.raises(AssertionError):
        _close(broken(torch.from_numpy(src), torch.from_numpy(src)), want,
               OUT_TOL, "broken")
    _close(pt(torch.from_numpy(src), torch.from_numpy(src)), want, OUT_TOL,
           "carried")


def _dropout_masks(encoder, x):
    masks = []
    hooks = [lay.dropout1.register_forward_hook(
        lambda m, i, o: masks.append(o == 0)) for lay in encoder.layers]
    try:
        encoder(x)
    finally:
        for h in hooks:
            h.remove()
    return masks


def test_dropout_masks_differ_between_layers():
    """Every layer of a deep-copied stack draws its dropout from the
    package generator, so the layers drop other positions; a generator
    held by layer 0 would be deep-copied with its state, and every
    layer would then drop the same ones (the negative control)."""
    P.seed(0)
    layer = pnn.TransformerEncoderLayer(D, H, FF, 0.5, device="cpu")
    enc = pnn.TransformerEncoder(layer, 3).train()
    x = torch.from_numpy(_x(11, 2, 16, D))
    m = _dropout_masks(enc, x)
    assert len(m) == 3 and 0.3 < float(m[0].float().mean()) < 0.7
    assert not torch.equal(m[0], m[1]) and not torch.equal(m[1], m[2])
    held = pnn.TransformerEncoderLayer(D, H, FF, 0.5, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for name in ("dropout", "dropout1", "dropout2"):
        getattr(held, name).generator = gen
    bad = pnn.TransformerEncoder(held, 3).train()
    m = _dropout_masks(bad, x)
    assert torch.equal(m[0], m[1]) and torch.equal(m[1], m[2])


# -- Layer ---------------------------------------------------------------------

class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 3)
        self.act = jnn.GELU()
        self.blocks = jnn.LayerList([jnn.Linear(3, 3), jnn.LayerNorm(3)])
        self.scale = self.create_parameter([3], default_initializer=jnn
                                           .initializer.Constant(2.0))

    def forward(self, x):
        h = self.act(self.fc(x))
        for b in self.blocks:
            h = b(h)
        return h * self.scale


class _PNet(pnn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.fc = pnn.Linear(4, 3, device="cpu")
        self.act = pnn.GELU()
        self.blocks = pnn.LayerList([pnn.Linear(3, 3, device="cpu"),
                                     pnn.LayerNorm(3, device="cpu")])
        self.scale = self.create_parameter(
            [3], default_initializer=pnn.initializer.Constant(2.0))

    def forward(self, x):
        h = self.act(self.fc(x))
        for b in self.blocks:
            h = b(h)
        return h * self.scale


def test_layer_methods_match_jax_layer():
    jn, pn = _JNet(), _PNet()
    assert [n for n, _ in pn.named_parameters()] == \
        [n for n, _ in jn.named_parameters()]
    assert [n for n, _ in pn.named_sublayers()] == \
        [n for n, _ in jn.named_sublayers()]
    assert [type(m).__name__ for m in pn.sublayers()] == \
        [type(m).__name__ for m in jn.sublayers()]
    assert pn.sublayers(include_self=True)[0] is pn
    assert list(pn.state_dict()) == list(jn.state_dict())
    assert list(pn.state_dict(include_sublayers=False)) == ["scale"]
    assert [n for n, _ in pn.named_parameters(include_sublayers=False)] \
        == ["scale"]
    assert pn.full_name() == "_pnet" and jn.full_name() == "_jnet"
    _carry(jn, pn)
    x = _x(12, 5, 4)
    _close(pn(torch.from_numpy(x)), jn(J.to_tensor(x)), OUT_TOL, "net")
    # set_state_dict: arrays or tensors, shapes checked, missing and
    # unexpected names reported as the JAX Layer reports them
    new = {k: np.full(v.shape, 0.5, np.float32)
           for k, v in pn.state_dict().items() if k != "scale"}
    new["extra"] = np.zeros(2, np.float32)
    got = pn.set_state_dict(new)
    jgot = jn.set_state_dict({k: J.to_tensor(v) for k, v in new.items()})
    assert tuple(map(list, got)) == tuple(map(list, jgot))
    assert torch.equal(pn.fc.weight, torch.full((4, 3), 0.5))
    with pytest.raises(ValueError, match="shape mismatch"):
        pn.set_dict({"fc.bias": np.zeros(4, np.float32)})
    # clear_gradients, train / eval
    pn(torch.from_numpy(x)).sum().backward()
    assert pn.fc.weight.grad is not None
    pn.clear_gradients()
    assert all(p.grad is None for p in pn.parameters())
    pn.eval()
    jn.eval()
    assert [m.training for m in pn.sublayers()] == \
        [m.training for m in jn.sublayers()] == [False] * 5
    pn.train()
    assert all(m.training for m in pn.sublayers(include_self=True))
    # hooks: a pre hook's result replaces the inputs, a post hook's the
    # outputs; remove() takes them off
    h1 = pn.register_forward_pre_hook(lambda m, inp: (inp[0] * 0,))
    h2 = pn.register_forward_post_hook(lambda m, inp, out: out + 1)
    out = pn(torch.from_numpy(x))
    h1.remove()
    h2.remove()
    assert not torch.equal(pn(torch.from_numpy(x)), out)
    # astype / to by Paddle's dtype names; buffers and add_*
    pn.astype("float64")
    assert pn.fc.weight.dtype == torch.float64
    pn.to("float32")
    assert pn.fc.weight.dtype == torch.float32
    pn.register_buffer("stat", torch.zeros(2), persistable=False)
    assert "stat" not in pn.state_dict()
    assert [n for n, _ in pn.named_buffers()] == ["stat"]
    pn.add_parameter("extra", torch.ones(2))
    pn.add_sublayer("head", pnn.Linear(3, 1, device="cpu"))
    assert "extra" in dict(pn.named_parameters())
    assert pn.sublayers()[-1] is pn.head


def test_param_attr():
    """bias_attr=False leaves no bias; an initializer replaces the
    default draw; trainable=False gives a frozen parameter; the same as
    the JAX layers on those points."""
    init = pnn.ParamAttr(initializer=pnn.initializer.Constant(0.5))
    lin = pnn.Linear(4, 3, init, False, device="cpu")
    jlin = jnn.Linear(4, 3, jnn.ParamAttr(
        initializer=jnn.initializer.Constant(0.5)), False)
    assert lin.bias is None and jlin.bias is None
    assert [n for n, _ in lin.named_parameters()] == ["weight"]
    assert torch.equal(lin.weight, torch.full((4, 3), 0.5))
    _close(lin.weight, jlin.weight, 0.0, "weight")
    frozen = pnn.Linear(2, 2, pnn.ParamAttr(trainable=False),
                        pnn.initializer.Constant(1.0), device="cpu")
    assert not frozen.weight.requires_grad and frozen.bias.requires_grad
    assert torch.equal(frozen.bias, torch.ones(2))
    ln = pnn.LayerNorm(4, 1e-5, False, False, device="cpu")
    assert ln.weight is None and ln.bias is None
    x = torch.from_numpy(_x(13, 3, 4))
    jln = jnn.LayerNorm(4, 1e-5, False, False)
    _close(ln(x), jln(J.to_tensor(x.numpy())), OUT_TOL, "layernorm")
    emb = pnn.Embedding(5, 3, weight_attr=pnn.initializer.Constant(0.25),
                        device="cpu")
    assert torch.equal(emb.weight, torch.full((5, 3), 0.25))
    mha = pnn.MultiHeadAttention(8, 2, bias_attr=False, device="cpu")
    assert all("bias" not in n for n, _ in mha.named_parameters())
    assert pnn.ParamAttr._to_attr("w").name == "w"


ACT_CASES = [
    ("ReLU", {}), ("ReLU6", {}), ("GELU", {"approximate": True}),
    ("Sigmoid", {}), ("Tanh", {}), ("Softmax", {"axis": 1}),
    ("LogSoftmax", {}), ("LeakyReLU", {"negative_slope": 0.1}),
    ("PReLU", {"num_parameters": 6, "init": 0.2}), ("ELU", {"alpha": 0.7}),
    ("SELU", {}), ("CELU", {"alpha": 1.5}), ("Silu", {}), ("Swish", {}),
    ("Mish", {}), ("Hardswish", {}), ("Hardsigmoid", {}),
    ("Hardtanh", {"min": -0.3, "max": 0.4}), ("Hardshrink", {}),
    ("Softshrink", {"threshold": 0.2}), ("Softplus", {"beta": 2.0}),
    ("Softsign", {}), ("Tanhshrink", {}),
    ("ThresholdedReLU", {"threshold": 0.3}), ("LogSigmoid", {}),
    ("Maxout", {"groups": 3}), ("GLU", {"axis": 1}), ("RReLU", {}),
]


@pytest.mark.parametrize("name,kw", ACT_CASES, ids=[c[0] for c in ACT_CASES])
def test_activation_layers(name, kw):
    """Each activation layer's output and input gradient equal the JAX
    layer's (RReLU in eval, where it is deterministic)."""
    jl = getattr(jnn, name)(**kw)
    extra = {"device": "cpu"} if name == "PReLU" else {}
    pl = getattr(pnn, name)(**kw, **extra)
    if name == "RReLU":
        jl.eval()
        pl.eval()
    assert isinstance(pl, pnn.Layer)
    x = _x(14, 2, 6, 3, 3) * 2
    (jx,), (px,) = _pair_inputs(x)
    jo, po = jl(jx), pl(px)
    _close(po, jo, OUT_TOL, name)
    cot = _x(15, *po.shape)
    (jg,) = J.grad([jo], [jx], [J.to_tensor(cot)])
    (pg,) = torch.autograd.grad([po], [px], [torch.from_numpy(cot)])
    scale = max(float(np.abs(np.asarray(jg._value)).max()), 1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg._value), rtol=0,
                               atol=GRAD_TOL * scale, err_msg=name)
