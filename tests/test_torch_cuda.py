"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

The kernels are CUDA C++ with no CPU mode, so every test here needs a
CUDA device and `nvcc` (the first call builds them) and skips without
one. The file imports neither jax nor paddle_tpu, so it also runs on a
machine with only PyTorch, where tests/conftest.py (which imports jax)
is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: f32 within 1e-5 (summation order only); paged attention in
bf16 within about one bf16 ulp of the output, 1e-2 x max|out| + 1e-2
relative (the kernel and the plain version round the same
un-normalised probabilities to bf16, each against its own running
maximum). Flash attention in f32: the forward within 2e-5 and the
gradients within 2e-4, the JAX package's own tolerances for its flash
kernel (tests/test_flash_attention.py); in bf16 each row (a query of o
and dq, a key of dk and dv) within 1e-2 x its own max|ref|, one bf16
ulp of its largest value (a final rounding that falls the other way)
and a quarter ulp for the f32 sums before it: the kernel rounds p
against per-tile running maxima, the plain version against the row
maximum. The LayerNorm
backward: f32 within 1e-5 x max|ref| (dw, db sum over rows in another
order); bf16 dx within one bf16 ulp (1e-2), dw and db (f32 sums of the
same bf16 inputs) within 1e-5 x max|ref|. The optimizer kernels: bit
for bit, parameters and every slot, against the per-parameter rule and
against their plain versions (the kernel rounds every operation as
PyTorch does). The blockwise int8 quantize and dequantize kernels: bit
for bit, codes, scales and outputs (NaN at the same places), as is the
quantized allreduce over 2 gloo ranks on the card against the same call
on CPU copies.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import kernels
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.incubate.nn.kernels import layernorm as ln
from paddle_tpu_torch.incubate.nn.kernels import optim as ok
from paddle_tpu_torch.incubate.nn.kernels import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels are CUDA "
                    "C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_attention_kernel(cuda, dtype, tol, head_dim):
    rng = np.random.RandomState(0)
    b, h, bs, n, maxb = 4, 4, 8, 24, 5
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(cuda, dtype)
                 for shape in ((b, h, head_dim), (n, bs, h, head_dim),
                               (n, bs, h, head_dim)))
    bt = torch.from_numpy(rng.randint(1, n, (b, maxb)).astype(np.int32))
    bt = bt.to(cuda)
    lens = torch.tensor([37, 1, 8, 40], dtype=torch.int32, device=cuda)
    before = kernels.launches()["paged_attention"]
    out = pa.paged_attention(q, kp, vp, bt, lens, sm_scale=0.125)
    ref = pa.paged_attention_reference(q, kp, vp, bt, lens, sm_scale=0.125)
    torch.cuda.synchronize()
    assert kernels.launches()["paged_attention"] == before + 1
    assert out.dtype == dtype
    atol = tol if dtype == torch.float32 else tol * float(ref.abs().max())
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=atol)


@pytest.mark.parametrize("act,approx", [(None, True), ("gelu", True),
                                        ("gelu", False)])
@pytest.mark.parametrize("res", [False, True])
def test_layer_norm_kernel(cuda, act, approx, res):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(7, 1024, device=cuda, generator=g)
    r = torch.randn(7, 1024, device=cuda, generator=g) if res else None
    w = 1 + 0.1 * torch.randn(1024, device=cuda, generator=g)
    b = 0.1 * torch.randn(1024, device=cuda, generator=g)
    before = kernels.launches()["fused_layer_norm"]
    got = ln.layer_norm_fwd(x, r, w, b, 1e-5, act, approx)
    want = ln.layer_norm_fwd_reference(x, r, w, b, 1e-5, act, approx)
    torch.cuda.synchronize()
    assert kernels.launches()["fused_layer_norm"] == before + 1
    for g_, w_ in zip(got, want):
        if w_ is None:
            assert g_ is None
        else:
            torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 4, 32, device=cuda)          # head_dim 32
    pool = torch.randn(6, 8, 4, 32, device=cuda)
    bt = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    cl = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, pool, pool, bt, cl)
    q = torch.randn(2, 4, 64, device=cuda)
    pool = torch.randn(6, 8, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, pool, pool, bt.long(), cl)
    with pytest.raises(TypeError, match="one dtype"):
        pa.paged_attention(q, pool.bfloat16(), pool, bt, cl)
    x = torch.randn(2, 64, device=cuda, dtype=torch.float16)
    w = torch.ones(64, device=cuda)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ln.fused_layer_norm(x, w, w)


def _assert_rows_close(got, want, name, row_tol=1e-2, floor=1e-3):
    """Each row (a query of o or dq, a key of dk or dv) within row_tol x
    its own max|want|: causal rows and keys differ in scale, so a limit
    set by the tensor's largest value would pass a late row that lost a
    tile. The row scale is floored at `floor` x the tensor's max|want|
    (dq of the first causal row is rounding noise around zero)."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    row = want.float().abs().amax(dim=-1)
    row = row.clamp_min(floor * float(row.max()))
    ratio = float((err / row).max())
    assert ratio <= row_tol, (name, ratio)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [256, 129, 1000])
def test_flash_attention_kernels(cuda, dtype, head_dim, causal, seq):
    """All three kernels vs their plain versions; S 1000 leaves a ragged
    last 128-row q tile (dq, forward) and, at head_dim 128, dq's 64-key
    tiles with a diagonal tile past the first consumer's rows."""
    rng = np.random.RandomState(seq + head_dim)
    q, k, v, do = (torch.from_numpy(
        (0.5 * rng.randn(2, 3, seq, head_dim)).astype(np.float32))
        .to(cuda, dtype) for _ in range(4))
    before = kernels.launches()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, 0.125)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, 0.125)
    o0, lse0 = fa.flash_attention_fwd_reference(q, k, v, causal, 0.125)
    dq0, dk0, dv0 = fa.flash_attention_bwd_reference(q, k, v, o0, lse0, do,
                                                     causal, 0.125)
    torch.cuda.synchronize()
    after = kernels.launches()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    torch.testing.assert_close(lse, lse0, rtol=1e-5, atol=1e-4)
    for name, got, want, f32_tol in (("o", o, o0, 2e-5), ("dq", dq, dq0, 2e-4),
                                     ("dk", dk, dk0, 2e-4),
                                     ("dv", dv, dv0, 2e-4)):
        assert got.dtype == dtype and got.shape == want.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=f32_tol,
                                       atol=f32_tol, msg=name)
        else:
            _assert_rows_close(got, want, name)


def test_flash_attention_cross_lengths(cuda):
    """Non-causal with sq != sk, both ragged."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 2, 100, 64, device=cuda, generator=g)
    k = torch.randn(1, 2, 333, 64, device=cuda, generator=g)
    v = torch.randn(1, 2, 333, 64, device=cuda, generator=g)
    do = torch.randn(1, 2, 100, 64, device=cuda, generator=g)
    o, lse = fa.flash_attention_fwd(q, k, v, False, 0.125)
    o0, lse0 = fa.flash_attention_fwd_reference(q, k, v, False, 0.125)
    torch.testing.assert_close(o, o0, rtol=2e-5, atol=2e-5)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, False, 0.125)
    want = fa.flash_attention_bwd_reference(q, k, v, o0, lse0, do, False,
                                            0.125)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_flash_attention_function_grads(cuda):
    """The autograd Function's gradients: kernels vs plain versions."""
    g = torch.Generator(device=cuda).manual_seed(2)
    leaves = [torch.randn(2, 4, 192, 64, device=cuda, generator=g)
              .requires_grad_() for _ in range(3)]
    w = torch.randn(2, 4, 192, 64, device=cuda, generator=g)
    grads = []
    for use_kernel in (True, False):
        out = fa.flash_attention(*leaves, causal=True, sm_scale=0.125,
                                 use_kernel=use_kernel)
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,approx", [(None, True), ("gelu", True),
                                        ("gelu", False)])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("hidden", [64, 100, 768, 1024, 2050, 4096])
def test_layer_norm_bwd_kernel(cuda, dtype, act, approx, res, hidden):
    """Every shape the backward kernel branches on: one 16-byte vector a
    lane and a warp a row (64; 100 in f32), two vectors a lane and 2 to
    16 warps a row sharing their sums (768, whose last vector slot is
    idle; 1024; 4096), one element at a time (100 in bf16, no multiple
    of the 8-value vector; 2050, 16 warps a row); 1, 7 and 300 rows, and
    more rows than the persistent grid works on at once, so groups walk
    more than one row; a second call on the same inputs gives
    bit-identical dx, dw and db."""
    g = torch.Generator(device=cuda).manual_seed(3)
    w = 1 + 0.1 * torch.randn(hidden, device=cuda, generator=g)
    b = 0.1 * torch.randn(hidden, device=cuda, generator=g)
    vw = 16 // torch.empty(0, dtype=dtype).element_size()
    groups, ctas = ln._bwd_plan(kernels.load(), hidden,
                                ln._act_code(act, approx), ln._DTYPES[dtype],
                                res, int(hidden % vw == 0))
    for n in (1, 7, 300, groups * ctas + 5):
        x = torch.randn(n, hidden, device=cuda, generator=g).to(dtype)
        r = torch.randn(n, hidden, device=cuda, generator=g).to(dtype)
        dy = torch.randn(n, hidden, device=cuda, generator=g).to(dtype)
        ds = torch.randn(n, hidden, device=cuda, generator=g).to(dtype) \
            if res else None
        _, s, mean, rstd = ln.layer_norm_fwd(x, r if res else None, w, b,
                                             1e-5, act, approx)
        s = s if res else x
        before = kernels.launches()["fused_layer_norm_bwd"]
        got = ln.layer_norm_bwd(dy, ds, s, w, b, mean, rstd, act, approx)
        again = ln.layer_norm_bwd(dy, ds, s, w, b, mean, rstd, act, approx)
        want = ln.layer_norm_bwd_reference(dy, ds, s, w, b, mean, rstd, act,
                                           approx)
        torch.cuda.synchronize()
        assert kernels.launches()["fused_layer_norm_bwd"] == before + 2
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        assert got[1].shape == got[2].shape == (hidden,)
        dx_tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=dx_tol,
                                   atol=dx_tol * float(want[0].abs().max()),
                                   msg=f"dx, {n} rows")
        for name, a, b_ in zip(("dw", "db"), got[1:], want[1:]):
            torch.testing.assert_close(a, b_, rtol=1e-5,
                                       atol=1e-5 * float(b_.abs().max()),
                                       msg=f"{name}, {n} rows")
        for a, a2 in zip(got, again):
            assert torch.equal(a, a2), f"{n} rows: two calls differ"


def test_layer_norm_function_grads(cuda):
    """Gradients through FusedResidualLayerNormFn: kernels vs plain."""
    g = torch.Generator(device=cuda).manual_seed(4)
    leaves = [torch.randn(3, 50, 1024, device=cuda, generator=g)
              .requires_grad_() for _ in range(2)]
    w = (1 + 0.1 * torch.randn(1024, device=cuda, generator=g)
         ).requires_grad_()
    b = (0.1 * torch.randn(1024, device=cuda, generator=g)).requires_grad_()
    grads = []
    for fn in (ln.fused_residual_layer_norm,
               ln.fused_residual_layer_norm_reference):
        y, s = fn(*leaves, w, b, 1e-5, "gelu", True)
        loss = y.sin().sum() + s.cos().sum()
        grads.append(torch.autograd.grad(loss, leaves + [w, b]))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=1e-5,
                                   atol=1e-5 * float(b_.abs().max()))


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 64, 32, device=cuda)      # head_dim 32
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 2, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 2, 64, 64, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_fwd(q, q.bfloat16(), q)
    k = torch.randn(1, 2, 96, 64, device=cuda)
    with pytest.raises(ValueError, match="sq == sk"):
        fa.flash_attention_fwd(q, k, k, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 2), q.transpose(1, 2),
                               q.transpose(1, 2))
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    mean = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="dy"):
        ln.layer_norm_bwd(x.bfloat16(), None, x, w, w, mean, mean)
    with pytest.raises(ValueError, match="mean"):
        ln.layer_norm_bwd(x, None, x, w, w, mean[:3], mean)


def test_training_step_on_card_remat_and_dropout(cuda):
    """A small GPT's training forward on the card goes through the
    flash and LayerNorm kernels both ways; remat (with dropout, whose
    per-layer seeds replay the masks) gives the gradients of no remat
    within 1e-5 x max|g| (f32; the embedding's backward sums with
    atomics, in another order from run to run)."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    ids = torch.randint(0, 256, (2, 96), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(5))
    grads = []
    for remat in (False, True):
        cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                        num_heads=2, ffn_hidden=256, max_seq_len=96,
                        dropout=0.1, remat=remat)
        model = GPTForCausalLM(cfg, device=cuda)
        model.gpt.dropout_generator.manual_seed(3)
        before = kernels.launches()
        model(ids, ids).backward()
        torch.cuda.synchronize()
        after = kernels.launches()
        fwd = 2 if remat else 1          # remat runs each block twice
        assert after["flash_attention_fwd"] - before[
            "flash_attention_fwd"] == 2 * fwd
        assert after["flash_attention_bwd_dkv"] - before[
            "flash_attention_bwd_dkv"] == 2
        assert after["fused_layer_norm_bwd"] - before[
            "fused_layer_norm_bwd"] == 5
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def _optim_params(dev, seed, masters=True):
    """Named parameters of an O2-like set: bf16 weights (f32 without
    masters), f32 LayerNorm-like vectors, a tail that is no multiple of
    the vector width, a view at an odd offset (the scalar path), a
    tensor of several chunks, and a zero-size tensor."""
    rng = np.random.RandomState(seed)
    half = torch.bfloat16 if masters else torch.float32

    def t(n, dtype, offset=0):
        a = torch.from_numpy(rng.randn(n + offset).astype(np.float32))
        return a.to(dev, dtype)[offset:]

    return [("w", torch.nn.Parameter(t(3 * ok.CHUNK + 5, half).view(-1, 1))),
            ("b", torch.nn.Parameter(t(1001, half))),
            ("ln_w", torch.nn.Parameter(t(96, torch.float32))),
            ("odd", torch.nn.Parameter(t(777, half, offset=1))),
            ("odd32", torch.nn.Parameter(t(513, torch.float32, offset=3))),
            ("empty", torch.nn.Parameter(t(0, half)))]


OPTIM_CASES = {
    "adamw_filter": ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05,
                                   apply_decay_param_fun=lambda n:
                                   not n.startswith("ln"))),
    "adam_l2": ("Adam", dict(learning_rate=1e-3, weight_decay=0.02)),
    "sgd_l2": ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                  use_nesterov=True)),
    "adamw_f32_no_masters": ("AdamW", dict(learning_rate=1e-3,
                                           weight_decay=0.01)),
    "adamw_no_grad": ("AdamW", dict(learning_rate=1e-3, weight_decay=0.01)),
    "adamw_set_state_dict": ("AdamW", dict(learning_rate=1e-3,
                                           weight_decay=0.01)),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_kernels_bit_identical(cuda, case):
    """step() through the kernel against step() through the
    per-parameter rule (use_kernel=False), three steps: parameters,
    masters, moments, velocities and beta powers bit for bit; the
    kernel launched once a step."""
    from paddle_tpu_torch import optimizer as optim

    cls_name, kw = OPTIM_CASES[case]
    cls = getattr(optim, cls_name)
    masters = case != "adamw_f32_no_masters"
    sets = [_optim_params(cuda, 0, masters) for _ in range(2)]
    opts = [cls(parameters=s, multi_precision=True, use_kernel=u, **kw)
            for s, u in zip(sets, (True, False))]
    kind = {"AdamW": "fused_adam", "Adam": "fused_adam", "SGD": "fused_sgd",
            "Momentum": "fused_momentum"}[cls_name]
    rng = np.random.RandomState(1)
    for step in range(3):
        if case == "adamw_set_state_dict" and step == 2:
            sd = opts[0].state_dict()
            opts = [cls(parameters=s, multi_precision=True, use_kernel=u,
                        **kw) for s, u in zip(sets, (True, False))]
            for o in opts:
                o.set_state_dict(sd)
        grads = {n: rng.randn(*p.shape).astype(np.float32)
                 for n, p in sets[0]}
        for s in sets:
            for n, p in s:
                skip = case == "adamw_no_grad" and n == "b"
                p.grad = None if skip else torch.from_numpy(
                    grads[n]).to(cuda, p.dtype)
        before = kernels.launches()[kind]
        for o in opts:
            o.step()
        torch.cuda.synchronize()
        assert kernels.launches()[kind] == before + 1
    for (n, a), (_, b) in zip(*sets):
        assert torch.equal(a, b), n
    sd = [o.state_dict() for o in opts]
    assert set(sd[0]) == set(sd[1])
    for key, v in sd[0].items():
        assert (v == sd[1][key] if key == "@step"
                else torch.equal(v, sd[1][key])), key
    if case == "adamw_no_grad":      # no grad: no slots, no update
        assert "b.moment1" not in sd[0]


def test_optimizer_kernel_wrappers_against_plain_versions(cuda):
    """fused_adam / fused_momentum / fused_sgd vs their plain versions on
    the same tensors, and a list longer than one table (two launches)."""
    n = ok.MAX_TENSORS + 3
    rng = np.random.RandomState(2)

    def lists():
        r = np.random.RandomState(3)
        ps = [torch.from_numpy(r.randn(37 * (i + 1)).astype(np.float32))
              .to(cuda, torch.bfloat16) for i in range(n)]
        ms = [p.float() for p in ps]
        return ps, ms, [torch.zeros_like(m) for m in ms], [
            torch.zeros_like(m) for m in ms], [
            torch.ones((), device=cuda) for _ in ps], [
            torch.ones((), device=cuda) for _ in ps]

    grads = [torch.from_numpy(rng.randn(37 * (i + 1)).astype(np.float32))
             .to(cuda, torch.bfloat16) for i in range(n)]
    decay = [0.9999 if i % 2 else 1.0 for i in range(n)]
    got, want = lists(), lists()
    before = kernels.launches()["fused_adam"]
    ok.fused_adam(got[0], grads, got[1], *got[2:], lr=1e-3, beta1=0.9,
                  beta2=0.999, eps=1e-8, decay=decay)
    ok.fused_adam_reference(want[0], grads, want[1], *want[2:], lr=1e-3,
                            beta1=0.9, beta2=0.999, eps=1e-8, decay=decay)
    torch.cuda.synchronize()
    assert kernels.launches()["fused_adam"] == before + 2
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for nesterov in (False, True):
        got, want = lists(), lists()
        ok.fused_momentum(got[0], grads, got[1], got[2], lr=0.1,
                          momentum=0.9, nesterov=nesterov, l2=[0.01] * n)
        ok.fused_momentum_reference(want[0], grads, want[1], want[2], lr=0.1,
                                    momentum=0.9, nesterov=nesterov,
                                    l2=[0.01] * n)
        for a, b in zip(got[:3], want[:3]):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    got, want = lists(), lists()
    ok.fused_sgd(got[0], grads, [None] * n, lr=0.1)
    ok.fused_sgd_reference(want[0], grads, [None] * n, lr=0.1)
    for x, y in zip(got[0], want[0]):
        assert torch.equal(x, y)
    # nothing to do: nothing launched, nothing counted
    before = kernels.launches()
    ok.fused_sgd([], [], [], lr=0.1)
    empty = torch.zeros(0, device=cuda)
    ok.fused_momentum([empty], [empty], [None], [empty.clone()], lr=0.1,
                      momentum=0.9)
    assert kernels.launches() == before


def test_optimizer_kernel_wrappers_reject_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ok.fused_sgd([p], [p], [None], lr=0.1)
    p = torch.zeros(4, 4, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        ok.fused_sgd([p], [p.contiguous()], [None], lr=0.1)
    p = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="tensors on"):
        ok.fused_sgd([p], [p.cpu()], [None], lr=0.1)
    with pytest.raises(TypeError, match="master"):
        ok.fused_sgd([p], [p], [p.clone()], lr=0.1)


def _multi_inputs(cuda, dtype, t, head_dim, seed=0):
    """q [4, T, H, D], pools, tables of 5 real columns plus the NULL
    column, and contexts 1, 9, one whose deepest slot ends at the last
    real column, and 17."""
    rng = np.random.RandomState(seed)
    b, h, bs, n, maxb = 4, 4, 8, 24, 5
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(cuda, dtype)
                 for shape in ((b, t, h, head_dim), (n, bs, h, head_dim),
                               (n, bs, h, head_dim)))
    bt = np.concatenate([rng.randint(1, n, (b, maxb)),
                         np.zeros((b, 1), int)], axis=1).astype(np.int32)
    lens = np.array([1, 9, maxb * bs - t + 1, 17], np.int32)
    return (q, kp, vp, torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("t", range(1, 9))
def test_paged_attention_multi_kernel(cuda, dtype, tol, head_dim, t):
    q, kp, vp, bt, lens = _multi_inputs(cuda, dtype, t, head_dim)
    before = kernels.launches()["paged_attention_multi"]
    out = pa.paged_attention_multi(q, kp, vp, bt, lens, sm_scale=0.125)
    ref = pa.paged_attention_multi_reference(q, kp, vp, bt, lens,
                                             sm_scale=0.125)
    torch.cuda.synchronize()
    assert kernels.launches()["paged_attention_multi"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    atol = tol if dtype == torch.float32 else tol * float(ref.abs().max())
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=atol)
    # slot s reads no position at or past ctx0 + s (nor any block no
    # table maps): NaN there leaves slot s bit-identical, and at the
    # deepest slot the whole output
    tb, lb = bt.cpu().numpy(), lens.cpu().numpy()
    nan = torch.full_like(kp, float("nan"))
    for s in range(t):
        live = torch.zeros(kp.shape[:2], dtype=torch.bool)
        for b in range(len(lb)):
            for pos in range(lb[b] + s):
                live[tb[b, pos // 8], pos % 8] = True
        live = live.to(cuda)[:, :, None, None]
        out2 = pa.paged_attention_multi(q, torch.where(live, kp, nan),
                                        torch.where(live, vp, nan), bt, lens,
                                        sm_scale=0.125)
        assert torch.equal(out[:, s], out2[:, s]), s
    assert torch.equal(out, out2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_attention_multi_slot_t_is_the_decode_kernel(cuda, dtype,
                                                           head_dim):
    """Slot t equals the decode wrapper (the kernel's one-slot launch)
    run at context_lens + t, bit for bit: the same warp partition,
    update and merge order in every instantiation."""
    t = 8
    q, kp, vp, bt, lens = _multi_inputs(cuda, dtype, t, head_dim, seed=1)
    out = pa.paged_attention_multi(q, kp, vp, bt, lens, sm_scale=0.125)
    for s in range(t):
        one = pa.paged_attention(q[:, s].contiguous(), kp, vp, bt, lens + s,
                                 sm_scale=0.125)
        assert torch.equal(out[:, s], one), s


def test_paged_attention_multi_wrapper_rejects_what_the_kernel_does_not_take(
        cuda):
    q, kp, vp, bt, lens = _multi_inputs(cuda, torch.float32, 9, 64)
    with pytest.raises(ValueError, match="T=9"):
        pa.paged_attention_multi(q, kp, vp, bt, lens)
    q = q[:, :4].contiguous()
    with pytest.raises(TypeError, match="one dtype"):
        pa.paged_attention_multi(q, kp.bfloat16(), vp, bt, lens)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_multi(q, kp, vp, bt.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_multi(q.transpose(1, 2).contiguous()
                                 .transpose(1, 2), kp, vp, bt, lens)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_multi(q[..., :32].contiguous(),
                                 kp[..., :32].contiguous(),
                                 vp[..., :32].contiguous(), bt, lens)


def _chunk_inputs(cuda, dtype, t, head_dim, seed, maxb=12):
    """q [8, T, 4, D], pools of distinct blocks, tables of `maxb` real
    columns (block size 16; 12: 192 positions, three chunks) plus the
    NULL column, and contexts around the chunk's edges: 1, chunk - 1,
    chunk, chunk + 1, two chunks - 1, two chunks + 1 (or, past 8 chunks,
    8 chunks - 1 and + 1), one whose deepest slot ends at the last real
    column, and the table's width (every slot clamped)."""
    rng = np.random.RandomState(seed)
    b, h, bs = 8, 4, 16
    n = b * maxb + 1
    c = pa.PAGED_CHUNK
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(cuda, dtype)
                 for shape in ((b, t, h, head_dim), (n, bs, h, head_dim),
                               (n, bs, h, head_dim)))
    bt = np.concatenate([rng.permutation(np.arange(1, n)).reshape(b, maxb),
                         np.zeros((b, 1), int)], axis=1).astype(np.int32)
    cap = maxb * bs
    k = 8 if cap > 9 * c else 2
    lens = np.array([1, c - 1, c, c + 1, k * c - 1, k * c + 1,
                     cap - t + 1, cap], np.int32)
    return (q, kp, vp, torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("t,maxb", [(1, 12), (2, 12), (4, 12), (8, 12),
                                    (1, 40), (4, 40)])
def test_paged_attention_chunks(cuda, dtype, tol, head_dim, t, maxb):
    """The split context: contexts one short of, at and one past a
    chunk's edge, of one token and at the table's width, T 1/2/4/8, and
    tables of 40 blocks (640 positions: the merge reads chunks past its
    first 8 from global memory). The kernel matches its plain version;
    slot s equals the decode wrapper (the one-slot launch) at context +
    s bit for bit, whichever chunks the two merge; NaN at every position
    past slot s's context (and in every block no table maps) leaves slot
    s bit-identical; a second launch gives the same bits (the counters
    were left at zero)."""
    assert kernels.load().ptt_paged_chunk() == pa.PAGED_CHUNK
    q, kp, vp, bt, lens = _chunk_inputs(cuda, dtype, t, head_dim, seed=t,
                                        maxb=maxb)
    out = pa.paged_attention_multi(q, kp, vp, bt, lens, sm_scale=0.125)
    ref = pa.paged_attention_multi_reference(q, kp, vp, bt, lens,
                                             sm_scale=0.125)
    torch.cuda.synchronize()
    atol = tol if dtype == torch.float32 else tol * float(ref.abs().max())
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=atol)
    assert torch.equal(out, pa.paged_attention_multi(q, kp, vp, bt, lens,
                                                     sm_scale=0.125))
    for s in range(t):
        one = pa.paged_attention(q[:, s].contiguous(), kp, vp, bt, lens + s,
                                 sm_scale=0.125)
        assert torch.equal(out[:, s], one), s
    tb, lb = bt.cpu().numpy(), lens.cpu().numpy()
    cap = (tb.shape[1]) * kp.shape[1]
    nan = torch.full_like(kp, float("nan"))
    for s in range(t):
        live = torch.zeros(kp.shape[:2], dtype=torch.bool)
        for b in range(len(lb)):
            for pos in range(min(int(lb[b]) + s, cap)):
                live[tb[b, pos // 16], pos % 16] = True
        live = live.to(cuda)[:, :, None, None]
        out2 = pa.paged_attention_multi(q, torch.where(live, kp, nan),
                                        torch.where(live, vp, nan), bt, lens,
                                        sm_scale=0.125)
        assert torch.equal(out[:, s], out2[:, s]), s


def test_paged_attention_workspace_follows_the_table(cuda):
    """A table one chunk wide needs no workspace; a wider one gets one
    partial per sequence, head, slot and chunk; a context of 0 gives
    zeros, as the plain version does."""
    assert pa.workspace_numel(8, 4, 16, 64, 4, 16) == 0
    assert pa.workspace_numel(8, 4, 16, 64, 65, 16) == 8 * 4 * 16 * 17 * 66
    q, kp, vp, bt, lens = _chunk_inputs(cuda, torch.float32, 2, 64, seed=9)
    lens = torch.zeros_like(lens)
    out = pa.paged_attention_multi(q, kp, vp, bt, lens, sm_scale=0.125)
    ref = pa.paged_attention_multi_reference(q, kp, vp, bt, lens,
                                             sm_scale=0.125)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[:, 0], torch.zeros_like(out[:, 0]))


_LN_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,approx", [(None, True), ("gelu", True),
                                        ("gelu", False)])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("hidden", [768, 1000, 1002, 1024, 4094, 4096])
def test_layer_norm_fwd_training_rows(cuda, dtype, act, approx, res, hidden):
    """The forward kernel at 4096 rows: one or two 16-byte vectors a lane
    on 1 to 8 warps a row (768, 1000, 1024, 4096) and four at f32 4096,
    one element at a time (1002 and 4094: no multiple of either vector;
    8 and 16 a lane); y within phase 4's limits (f32 1e-5, bf16 one ulp),
    mean and rstd within 1e-5, s bit-identical to the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(hidden)
    x = torch.randn(4096, hidden, device=cuda, generator=g).to(dtype)
    r = torch.randn(4096, hidden, device=cuda, generator=g).to(dtype) \
        if res else None
    w = 1 + 0.1 * torch.randn(hidden, device=cuda, generator=g)
    b = 0.1 * torch.randn(hidden, device=cuda, generator=g)
    before = kernels.launches()["fused_layer_norm"]
    y, s, mu, rs = ln.layer_norm_fwd(x, r, w, b, 1e-5, act, approx)
    y0, s0, mu0, rs0 = ln.layer_norm_fwd_reference(x, r, w, b, 1e-5, act,
                                                   approx)
    torch.cuda.synchronize()
    assert kernels.launches()["fused_layer_norm"] == before + 1
    tol = _LN_FWD_TOL[dtype]
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mu, mu0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, rs0, rtol=1e-5, atol=1e-5)
    if res:
        assert torch.equal(s, s0)
    else:
        assert s is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_fwd_row_counts_and_alignment(cuda, dtype):
    """1, 7 and more rows than the persistent grid works on at once (so
    row groups walk several rows), and row tensors that are not 16-byte
    aligned (the one-element path), each against the plain version."""
    hidden = 1024
    g = torch.Generator(device=cuda).manual_seed(5)
    w = 1 + 0.1 * torch.randn(hidden, device=cuda, generator=g)
    b = 0.1 * torch.randn(hidden, device=cuda, generator=g)
    vw = 16 // torch.empty(0, dtype=dtype).element_size()
    groups, ctas = ln._fwd_plan(kernels.load(), hidden, 0, ln._DTYPES[dtype],
                                True, 1)
    tol = _LN_FWD_TOL[dtype]
    for n, offset in ((1, 0), (7, 0), (groups * ctas + 5, 0), (300, 1)):
        buf = torch.randn(2, n * hidden + vw, device=cuda,
                          generator=g).to(dtype)
        x = buf[0, offset:offset + n * hidden].view(n, hidden)
        r = buf[1, offset:offset + n * hidden].view(n, hidden)
        y, s, mu, rs = ln.layer_norm_fwd(x, r, w, b, 1e-5)
        y0, s0, mu0, rs0 = ln.layer_norm_fwd_reference(x, r, w, b, 1e-5)
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol,
                                   msg=f"{n} rows, offset {offset}")
        torch.testing.assert_close(mu, mu0, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rs, rs0, rtol=1e-5, atol=1e-5)
        assert torch.equal(s, s0), f"{n} rows, offset {offset}"


def test_speculative_prefix_engine_on_card(cuda):
    """A 2-layer GPT (head_dim 64) served with spec_k=4 and prefix
    caching on the card gives the k=1, cache-off engine's tokens, and
    the verify dispatches went through the multi-query kernel."""
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, ffn_hidden=256, max_seq_len=128,
                    initializer_range=0.35)
    model = GPTForCausalLM(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prefix = list(rng.randint(1, 256, 32))
    prompts = [prefix + list(rng.randint(1, 256, n)) for n in (3, 17, 40, 9)]
    sp = SamplingParams(max_new_tokens=24)
    want = LLMEngine(model, max_batch=4, block_size=16, num_blocks=64,
                     device=cuda).generate(prompts, sampling=sp)
    eng = LLMEngine(model, max_batch=4, block_size=16, num_blocks=64,
                    device=cuda, spec_k=4, prefix_cache=True)
    hits = cmon.stat_get("serve/prefix/hits")
    rounds = cmon.stat_get("serve/decode_dispatches")
    kernels.reset_launches()
    got = eng.generate(prompts, sampling=sp)
    torch.cuda.synchronize()
    counts = kernels.launches()
    rounds = cmon.stat_get("serve/decode_dispatches") - rounds
    assert got == want
    assert cmon.stat_get("serve/prefix/hits") - hits == 3
    assert rounds > 0
    assert counts["paged_attention_multi"] == 2 * rounds
    assert counts["paged_attention"] == 1 * 4 * rounds   # 1-layer draft
    assert eng.check_drained() == {}
    assert eng.cache.allocator.used_blocks == 0


def _compress_buffers(rng, block):
    """Blocks of randn x 3 with an all-zero block, exact k + 0.5
    multiples of the scale with +-absmax (scale 1), subnormals, a block
    whose scale rounds to 0, and NaN, Inf and -Inf blocks."""
    x = (3 * rng.randn(9, block)).astype(np.float32)
    x[1] = 0
    x[2] = rng.randint(-126, 126, block) + 0.5
    x[2, :2] = [127.0, -127.0]
    x[3] = (rng.randn(block) * 1e-40).astype(np.float32)
    x[4] = 0
    x[4, 3] = np.float32(1.4e-45)
    x[5, 7], x[6, 8], x[7, 9] = np.nan, np.inf, -np.inf
    return [x.reshape(-1), (3 * rng.randn(4096 * block)).astype(np.float32),
            x[2], x[5]]


def _same_bits(a, b):
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


@pytest.mark.parametrize("block", [128, 256, 1024, 2048])
def test_compress_kernels_match_plain_versions_bit_for_bit(cuda, block):
    """#11 quantize_i8 and #12 dequantize_i8: codes, scales and outputs
    bit for bit (2048: a block read twice, past the registers)."""
    from paddle_tpu_torch.distributed.compress import kernels as K

    rng = np.random.RandomState(block)
    for x in _compress_buffers(rng, block):
        xd = torch.from_numpy(x).to(cuda)
        before = kernels.launches()
        q, s = K.quantize_blocks(xd, block, "int8")
        d = K.dequantize_blocks(q, s, block, "int8")
        after = kernels.launches()
        assert after["quantize_i8"] == before["quantize_i8"] + 1
        assert after["dequantize_i8"] == before["dequantize_i8"] + 1
        q0, s0 = K.quantize_ref(xd, block, "int8")
        torch.cuda.synchronize()
        assert torch.equal(q, q0) and _same_bits(s, s0)
        assert _same_bits(d, K.dequantize_ref(q, s, block, "int8"))
    s = K.quantize_blocks(torch.from_numpy(_compress_buffers(
        np.random.RandomState(0), block)[0]).to(cuda), block, "int8")[1]
    assert s[1] == 1 and s[4] == 0 and s[5] == 1 and torch.isinf(s[6:8]).all()


def test_compress_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.distributed.compress import kernels as K

    x = torch.randn(1024, device=cuda)
    for bad, match in ((x[1:257], "aligned"), (x.double(), "float32"),
                       (x[:300], "multiple"), (x.view(8, 128).t(),
                                               "contiguous")):
        with pytest.raises(ValueError, match=match):
            K.quantize_blocks(bad, 128, "int8")
    q, s = K.quantize_blocks(x, 128, "int8")
    with pytest.raises(ValueError, match="scales"):
        K.dequantize_blocks(q, s[:-1], 128, "int8")
    with pytest.raises(ValueError, match="multiple of 128"):
        K.quantize_blocks(x, 96, "int8")


def _card_allreduce_rank(out_dir):
    import os

    from paddle_tpu_torch.distributed import compress as C
    from paddle_tpu_torch.distributed import get_rank

    r = get_rank()
    x = torch.from_numpy(np.random.RandomState(r).randn(8192).astype(
        np.float32))
    cfg = C.parse_spec("int8:ef:block=256")
    before = kernels.launches()
    got, res = C.all_reduce_flat(x.cuda(), None, cfg,
                                 residual=torch.zeros(8192, device="cuda"))
    after = kernels.launches()
    want, res0 = C.all_reduce_flat(x, None, cfg, residual=torch.zeros(8192))
    ok = (_same_bits(got.cpu(), want) and _same_bits(res.cpu(), res0)
          and after["quantize_i8"] - before["quantize_i8"] == 2
          and after["dequantize_i8"] - before["dequantize_i8"] == 4)
    with open(os.path.join(out_dir, f"r{r}"), "w") as f:
        f.write("ok" if ok else "differs")


def test_all_reduce_flat_two_ranks_on_the_card_via_gloo(cuda, tmp_path):
    """2 gloo ranks on the one card: the kernel path of all_reduce_flat
    (int8:ef) bit-identical to the same call on CPU copies (the plain
    path), with 2 quantize and 4 dequantize launches a rank."""
    from paddle_tpu_torch.distributed import spawn

    kernels.load()          # built once, before the ranks load it
    spawn(_card_allreduce_rank, args=(str(tmp_path),), nprocs=2,
          backend="gloo", join=False).join(timeout=300)
    assert [(tmp_path / f"r{r}").read_text() for r in range(2)] == ["ok"] * 2
