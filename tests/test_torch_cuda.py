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
same bf16 inputs) within 1e-5 x max|ref|.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import kernels
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.incubate.nn.kernels import layernorm as ln
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
@pytest.mark.parametrize("seq", [256, 129])
def test_flash_attention_kernels(cuda, dtype, head_dim, causal, seq):
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
def test_layer_norm_bwd_kernel(cuda, dtype, act, approx, res):
    g = torch.Generator(device=cuda).manual_seed(3)
    n, h = 300, 1024               # more rows than the kernel's CTAs
    x = torch.randn(n, h, device=cuda, generator=g).to(dtype)
    r = torch.randn(n, h, device=cuda, generator=g).to(dtype)
    w = 1 + 0.1 * torch.randn(h, device=cuda, generator=g)
    b = 0.1 * torch.randn(h, device=cuda, generator=g)
    dy = torch.randn(n, h, device=cuda, generator=g).to(dtype)
    ds = torch.randn(n, h, device=cuda, generator=g).to(dtype) if res \
        else None
    _, s, mean, rstd = ln.layer_norm_fwd(x, r if res else None, w, b, 1e-5,
                                         act, approx)
    s = s if res else x
    before = kernels.launches()["fused_layer_norm_bwd"]
    got = ln.layer_norm_bwd(dy, ds, s, w, b, mean, rstd, act, approx)
    want = ln.layer_norm_bwd_reference(dy, ds, s, w, b, mean, rstd, act,
                                       approx)
    torch.cuda.synchronize()
    assert kernels.launches()["fused_layer_norm_bwd"] == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    dx_tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=dx_tol,
                               atol=dx_tol * float(want[0].abs().max()))
    for a, b_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b_, rtol=1e-5,
                                   atol=1e-5 * float(b_.abs().max()))


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
