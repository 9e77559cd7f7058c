"""The port's `amp.auto_cast` (O1) held against the JAX package's.

The same numpy inputs go through both packages' ops inside their
`auto_cast`, and the dtypes each op computes in must agree: O1 casts
the f32 inputs of white-listed ops (plus the custom white list, minus
the custom black list) and nothing else; nesting restores the outer
state; the additive attention mask is cast with q, k and v. On GPT,
whose JAX loss is one dispatched op that no list names, O1 is exactly
the f32 step in both packages. The LayerNorm with a bf16 x and an f32
residual (BERT's first attention epilogue under O1) follows the JAX
Pallas kernel's contract, held here against that kernel run on the f32
sum (interpreted): s and y from the unrounded sum, stored in x's dtype
(s bit for bit, y within one bf16 ulp: the f32 statistics are summed
in another order), and its backward against the Pallas backward kernel
on the stored s (dx within one bf16 ulp, dw and db within 1e-5 x
max|ref|). The JAX package's own route refuses that case (ROADMAP queue
3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jax_amp
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.incubate.nn.pallas import layernorm as jax_pallas_ln
from paddle_tpu.ops import linalg as jax_linalg

from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.nn.kernels import layernorm as ln
from paddle_tpu_torch.jit import TrainStepCompiler
from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import linalg as port_linalg
from paddle_tpu_torch.optimizer import SGD, AdamW

from test_torch_train import WIDE_HEADS, _batch, _jax_train, _port_train


def _dt(t):
    """The dtype's short name, for either package's tensor."""
    if isinstance(t, torch.Tensor):
        return str(t.dtype).split(".")[-1]
    return str(np.asarray(t._value).dtype)


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(2, 8, 64).astype(np.float32),
        "w": rng.randn(64, 16).astype(np.float32),
        "b": rng.randn(16).astype(np.float32),
        "q": (0.5 * rng.randn(1, 2, 8, 64)).astype(np.float32),
        "mask": np.where(rng.rand(1, 1, 1, 8) < 0.3, -1e4, 0.0).astype(
            np.float32),
        "lbl": rng.randint(0, 16, (2, 8)).astype(np.int64),
    }


def _ops(pkg):
    """{op: fn(inputs) -> output} in one package's ops."""
    if pkg == "jax":
        F, mm, t = JF, jax_linalg.matmul, paddle.to_tensor
    else:
        F, mm = PF, port_linalg.matmul

        def t(a):
            return torch.from_numpy(np.array(a))
    return {
        "linear": lambda d: F.linear(t(d["x"]), t(d["w"]), t(d["b"])),
        "matmul": lambda d: mm(t(d["x"]), t(d["w"])),
        "sdpa": lambda d: F.scaled_dot_product_attention(
            t(d["q"]), t(d["q"]), t(d["q"]), attn_mask=t(d["mask"])),
        "gelu": lambda d: F.gelu(t(d["x"])),
        "layer_norm": lambda d: F.layer_norm(t(d["x"]), 64),
        "cross_entropy": lambda d: F.cross_entropy(
            t(d["x"][..., :16]), t(d["lbl"])),
    }


@pytest.mark.parametrize("config", [
    dict(enable=False),
    dict(),
    dict(custom_black_list=["linear", "scaled_dot_product_attention"]),
    dict(custom_white_list=["gelu", "layer_norm", "cross_entropy"]),
    dict(custom_white_list=["gelu"], custom_black_list=["gelu", "matmul"]),
    dict(dtype="float16"),
], ids=["off", "default", "black", "white", "white_minus_black", "fp16"])
def test_auto_cast_dtypes_match_jax(config):
    d = _inputs()
    with jax_amp.auto_cast(**config):
        want = {n: _dt(f(d)) for n, f in _ops("jax").items()}
    with amp.auto_cast(**config):
        got = {n: _dt(f(d)) for n, f in _ops("port").items()}
    assert got == want
    # outside the context everything is f32 again
    assert {n: _dt(f(d)) for n, f in _ops("port").items()} == {
        n: "float32" for n in want}


def test_auto_cast_values_match_jax():
    """Under O1, each white-listed op's value agrees with JAX's within a
    bf16 ulp of its largest output (both multiply bf16 inputs exactly
    and sum in f32, then round once)."""
    d = _inputs()
    with jax_amp.auto_cast():
        want = {n: np.asarray(f(d)._value, np.float32)
                for n, f in _ops("jax").items()}
    with amp.auto_cast():
        got = {n: f(d).float().numpy() for n, f in _ops("port").items()}
    for name in want:
        scale = float(np.abs(want[name]).max())
        assert float(np.abs(got[name] - want[name]).max()) <= \
            2 ** -7 * scale, name


def test_nesting_restores_the_outer_state():
    st = amp.amp_state()
    assert not st.enabled
    with amp.auto_cast(custom_white_list=["gelu"]):
        with amp.amp_guard(enable=False):
            assert not amp.amp_state().enabled
            x = torch.ones(2, 3)
            assert PF.linear(x, torch.ones(3, 4)).dtype == torch.float32
        assert st.enabled and st.custom_white == {"gelu"}
        assert PF.gelu(torch.ones(2)).dtype == torch.bfloat16
        with amp.auto_cast(dtype="float16", custom_black_list=["gelu"]):
            assert st.dtype == torch.float16
            assert PF.gelu(torch.ones(2)).dtype == torch.float32
        assert st.dtype == torch.bfloat16 and st.custom_black == set()
    assert not st.enabled and st.custom_white == set()


def test_only_f32_tensors_are_cast_and_the_mask_is():
    q = torch.ones(1, 1, 4, 64)
    mask = torch.full((1, 1, 1, 4), -1e4)
    ids = torch.arange(4)
    with amp.auto_cast():
        out = amp.maybe_cast_inputs(
            "scaled_dot_product_attention",
            (q, q.bfloat16(), q.half(), mask, ids, None, 2.0))
        other = amp.maybe_cast_inputs("softmax", (q,))
    assert [t.dtype for t in out[:5]] == [
        torch.bfloat16, torch.bfloat16, torch.float16, torch.bfloat16,
        torch.int64]
    assert out[5] is None and out[6] == 2.0 and other[0] is q
    # -1e4 rounds to -9984 in bf16, as in the JAX package
    assert float(out[3][0, 0, 0, 0]) == -9984.0
    with jax_amp.auto_cast():
        jout = jax_amp.maybe_cast_inputs(
            "scaled_dot_product_attention", (jnp.asarray(mask.numpy()),))
    assert float(jout[0][0, 0, 0, 0]) == -9984.0
    # the black list upcasts nothing: a bf16 input to layer_norm stays
    with amp.auto_cast():
        x = torch.randn(2, 64).bfloat16()
        assert PF.layer_norm(x, 64).dtype == torch.bfloat16
    assert amp.maybe_cast_inputs("linear", (q,))[0] is q   # auto_cast off


def test_audit_op_lists_names_exactly_the_unported_ops():
    """Every list entry the port dispatches resolves; the rest are ops
    the port has not ported yet: since the tensor API's ops, none."""
    audit = amp.audit_op_lists()
    assert audit["white"] == []
    assert audit["black"] == []
    known = amp.known_op_names()
    assert {"linear", "matmul", "scaled_dot_product_attention",
            "cross_entropy", "softmax_with_cross_entropy", "layer_norm",
            "gelu", "conv1d", "conv2d", "conv3d", "batch_norm", "addmm",
            "einsum", "mv", "cumsum", "exp", "log", "log10", "log1p",
            "log2", "log_softmax", "logsumexp", "mean", "norm", "pow",
            "softmax", "sum"} <= known
    assert amp.WHITE_LIST == jax_amp.WHITE_LIST
    assert amp.BLACK_LIST == jax_amp.BLACK_LIST
    assert amp.white_list()["bfloat16"]["O1"] == jax_amp.WHITE_LIST
    assert amp.black_list()["float16"]["O2"] == jax_amp.BLACK_LIST


def test_o1_on_gpt_is_the_f32_step_as_in_jax(monkeypatch):
    """The port's GPT calls no white-listed op (the JAX GPT dispatches
    its loss as one op, "gpt_loss"), so O1 trains it bit for bit as
    f32; the JAX O1 step equals its f32 step too, and the two packages
    agree as in the f32 parity test (test_torch_train)."""
    cfg = WIDE_HEADS
    ids, labels = _batch(cfg)
    tree, jl32, _ = _jax_train(cfg, 2, False, ids, labels)

    real = jax_amp.auto_cast

    class O1Only(real):            # count the JAX step's O1 contexts
        entered = 0

        def __enter__(self):
            O1Only.entered += 1
            return super().__enter__()

    from paddle_tpu.jit import TrainStepCompiler as JaxStep
    import paddle_tpu.optimizer as jax_optim
    from test_torch_train import _models

    jm, _, _ = _models(cfg)
    opt = jax_optim.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                          weight_decay=0.01)
    monkeypatch.setattr(jax_amp, "auto_cast", O1Only)
    step = JaxStep(jm, opt, loss_fn=None, amp_level="O1")
    jl1 = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels))
                 .item()) for _ in range(2)]
    assert O1Only.entered >= 1
    assert jl1 == jl32

    pl32, pp32, _ = _port_train(cfg, tree, 2, False, ids, labels)

    # the port's O1 step on the same weights
    from paddle_tpu_torch.convert import load_reference_params
    from paddle_tpu_torch.text.models import gpt as port_gpt

    pm = port_gpt.GPTForCausalLM(port_gpt.GPTConfig(remat=False, **cfg),
                                 device="cpu")
    load_reference_params(pm, tree)
    pstep = TrainStepCompiler(pm, AdamW(learning_rate=1e-3,
                                        parameters=pm.parameters(),
                                        weight_decay=0.01),
                              amp_level="O1")
    pl1 = [float(pstep(ids, labels)) for _ in range(2)]
    assert pl1 == pl32
    for name, p in pm.gpt.named_parameters():
        assert np.array_equal(p.detach().numpy(), pp32[name]), name
    np.testing.assert_allclose(pl1, jl1, rtol=1e-5)


def test_train_step_o1_wraps_the_forward_only():
    """amp_level="O1" casts the forward's white-listed ops; the
    parameters and their gradients stay f32; the custom lists reach
    auto_cast; the data-parallel step inherits it."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(8, 4))
    seen = []

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = w

        def forward(self, x):
            y = PF.linear(x, self.w)
            seen.append((y.dtype, PF.gelu(y).dtype))
            return y.float().square().mean()

    m = M()
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    opt = SGD(0.1, parameters=m.parameters())
    step = TrainStepCompiler(m, opt, amp_level="O1",
                             amp_custom_white_list=["gelu"])
    loss = step(x)
    assert loss.dtype == torch.float32
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert w.dtype == torch.float32 and w.grad.dtype == torch.float32
    assert not amp.amp_state().enabled         # the context closed
    step = TrainStepCompiler(m, opt, amp_level="O1", amp_dtype="float16",
                             amp_custom_black_list=["linear"])
    step(x)
    assert seen[-1] == (torch.float32, torch.float32)
    dist = DistributedTrainStepCompiler(m, opt, amp_level="O1",
                                        comm_compress=None)
    assert dist._amp_level == "O1"
    with pytest.raises(ValueError):
        TrainStepCompiler(m, opt, amp_level="O3")


# -- the bf16-x / f32-residual LayerNorm -----------------------------------
def _mixed_inputs(n=40, h=128, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h).astype(np.float32)
    r = (3 * rng.randn(n, h)).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    dy, ds = (rng.randn(n, h).astype(np.float32) for _ in range(2))
    return x, r, w, b, dy, ds


@pytest.mark.parametrize("act", [None, "gelu"])
def test_mixed_residual_layer_norm_follows_the_pallas_kernel(act):
    x, r, w, b, dy, ds = _mixed_inputs()
    xb = jnp.asarray(x, jnp.bfloat16)
    # the Pallas kernel on the f32 sum (x upcast exactly), its outputs
    # stored in x's dtype: the kernel's contract for mixed inputs
    y32, s32, mu, rs = jax_pallas_ln._ln_fwd_impl(
        xb.astype(jnp.float32), jnp.asarray(r), jnp.asarray(w),
        jnp.asarray(b), 1e-5, act, True, True)
    want_y = np.asarray(y32.astype(jnp.bfloat16), np.float32)
    want_s = np.asarray(s32.astype(jnp.bfloat16), np.float32)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    rt = torch.from_numpy(r).requires_grad_()
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    y, s = ln.fused_residual_layer_norm(xt, rt, wt, bt, 1e-5, act, True)
    assert y.dtype == s.dtype == torch.bfloat16
    assert np.array_equal(s.float().detach().numpy(), want_s)
    np.testing.assert_allclose(y.float().detach().numpy(), want_y, rtol=0,
                               atol=2 ** -7 * np.abs(want_y).max())
    _, _, pmu, prs = ln.layer_norm_fwd(xt.detach(), rt.detach(), wt.detach(),
                                       bt.detach(), 1e-5, act, True)
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu)[:, 0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(prs.numpy(), np.asarray(rs)[:, 0], rtol=1e-6)
    # the backward: the Pallas backward kernel on the stored bf16 s
    dyb, dsb = (jnp.asarray(a, jnp.bfloat16) for a in (dy, ds))
    jdx, jdw, jdb = jax_pallas_ln._ln_bwd_impl(
        dyb, dsb, jnp.asarray(want_s, jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), mu, rs, act, True, True)
    gx, gr, gw, gb = torch.autograd.grad(
        (y, s), (xt, rt, wt, bt),
        (torch.from_numpy(dy).bfloat16(), torch.from_numpy(ds).bfloat16()))
    assert gx.dtype == torch.bfloat16 and gr.dtype == torch.float32
    jdx = np.asarray(jdx, np.float32)
    np.testing.assert_allclose(gx.float().numpy(), jdx, rtol=0,
                               atol=2 ** -7 * np.abs(jdx).max())
    assert torch.equal(gr, gx.float())
    for got, want in ((gw, jdw), (gb, jdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_jax_pallas_route_refuses_the_mixed_residual(monkeypatch):
    """The reference's own Pallas route raises on a bf16 x with an f32
    residual (the f32 sum is stored into a bf16 ref), so JAX O1 BERT
    runs only on its fallback route, which keeps the sum in f32."""
    monkeypatch.setenv("PADDLE_PALLAS_FUSION", "1")
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    x, r, w, b, _, _ = _mixed_inputs(n=8)
    xj = paddle.to_tensor(x).astype("bfloat16")
    args = (paddle.to_tensor(w), paddle.to_tensor(b))
    with pytest.raises(ValueError, match="Invalid dtype"):
        JIF.fused_layer_norm(xj, *args, residual=paddle.to_tensor(r))
    monkeypatch.setenv("PADDLE_PALLAS_FUSION", "0")
    y, s = JIF.fused_layer_norm(xj, *args, residual=paddle.to_tensor(r),
                                return_residual_sum=True)
    assert _dt(y) == _dt(s) == "float32"


def test_bf16_weights_give_bf16_gradients():
    """O2 casts the fused layers' LayerNorm scales: the wrapper takes
    bf16 w and b (an exact f32 copy for the kernel) and returns dw and
    db in bf16, as `_ln_bwd_impl` casts them."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(6, 64).astype(np.float32)).bfloat16()
    w32 = torch.from_numpy((1 + 0.1 * rng.randn(64)).astype(np.float32))
    b32 = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32))
    wb, bb = (t.bfloat16().requires_grad_() for t in (w32, b32))
    y = ln.fused_layer_norm(x, wb, bb, 1e-12)
    y0 = ln.fused_layer_norm(x, wb.detach().float(), bb.detach().float(),
                             1e-12)
    assert torch.equal(y, y0)
    gw, gb = torch.autograd.grad(y.float().sum() + y.float().square().sum(),
                                 (wb, bb))
    assert gw.dtype == gb.dtype == torch.bfloat16
