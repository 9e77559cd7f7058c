"""The port's kernel modules held against the JAX package's.

`paddle_tpu_torch.incubate.nn.kernels` wraps hand-written CUDA kernels
and keeps each one's plain PyTorch version beside it; on CPU tensors
the wrappers run those plain versions. Here the same numpy inputs go
through the JAX package's Pallas kernels (interpret mode, on the CPU)
and dense references, and through the port, at stated tolerances:

  * paged attention: f32 within 2e-6 (the dense and the online-softmax
    forms differ only in summation order); bf16 within 1e-2 of the JAX
    dense reference (which rounds normalised probabilities to bf16, the
    port and the Pallas kernel un-normalised ones) and within about one
    bf16 ulp of the Pallas kernel (1e-2 x max|out| + 1e-2 relative);
  * LayerNorm: f32 within 1e-5; bf16 outputs within one bf16 ulp
    (1e-2), the residual sum bit-identical (both round the exact sum
    once), the f32 statistics within 1e-5. Its gradients, through the
    port's autograd Functions and `jax.grad` of the Pallas kernels'
    custom VJPs, within 1e-5 x max|g| (the same formulas, summed in
    another order);
  * flash attention in f32 against the Pallas kernels (interpret mode)
    and their `jax.grad`: the forward within 2e-5, lse within 1e-5 and
    the gradients within 2e-4, the JAX package's own tolerances for its
    kernel (tests/test_flash_attention.py); in bf16 the forward within
    2e-2 x max|out| + 2e-2 relative (one or two bf16 ulps: the Pallas
    kernel rounds p against the running maximum of 128-key tiles, the
    port's plain version against the row maximum).

Also the contracts: CPU tensors take the plain version and never touch
the kernel library; other devices raise; asking for CUDA without a GPU
raises. The kernels themselves run only on the card:
`tests/test_torch_cuda.py` compares them with their plain versions
there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.incubate.nn import attention_pallas as jax_fa
from paddle_tpu.incubate.nn.pallas import layernorm as jax_ln
from paddle_tpu.incubate.nn.pallas import paged_attention as jax_pa

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.incubate.nn import kernels
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.incubate.nn.kernels import layernorm as ln
from paddle_tpu_torch.incubate.nn.kernels import paged_attention as pa


def _paged_inputs(b=4, h=4, d=32, bs=8, n=24, maxb=5):
    rng = np.random.RandomState(0)
    return (rng.randn(b, h, d).astype(np.float32),
            rng.randn(n, bs, h, d).astype(np.float32),
            rng.randn(n, bs, h, d).astype(np.float32),
            rng.randint(1, n, (b, maxb)).astype(np.int32))


def _jax_paged(q, kp, vp, bt, lens, dtype, scale):
    args = (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(bt),
            jnp.asarray(np.asarray(lens, np.int32)))
    kern = jax_pa.paged_attention(*args, sm_scale=scale, interpret=True)
    ref = jax_pa.paged_attention_reference(*args, sm_scale=scale)
    return (np.asarray(kern, np.float32), np.asarray(ref, np.float32))


def _port_paged(q, kp, vp, bt, lens, dtype, scale, fn):
    return fn(torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
              torch.from_numpy(vp).to(dtype), torch.from_numpy(bt),
              torch.from_numpy(np.asarray(lens, np.int32)),
              sm_scale=scale)


@pytest.mark.parametrize("lens", [
    (1, 1, 1, 1),            # single token everywhere
    (8, 16, 32, 40),         # exact block boundaries
    (1, 8, 9, 40),           # boundary +/- 1 mixed
    (37, 3, 23, 15),         # odd ragged lengths
])
@pytest.mark.parametrize("fn", ["paged_attention",
                                "paged_attention_reference"])
def test_paged_attention_matches_jax_f32(lens, fn):
    q, kp, vp, bt = _paged_inputs()
    jk, jr = _jax_paged(q, kp, vp, bt, lens, jnp.float32, 0.2)
    out = _port_paged(q, kp, vp, bt, lens, torch.float32, 0.2,
                      getattr(pa, fn))
    assert out.dtype == torch.float32 and out.shape == (4, 4, 32)
    np.testing.assert_allclose(out.numpy(), jk, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), jr, rtol=2e-6, atol=2e-6)


def test_paged_attention_matches_jax_bf16():
    q, kp, vp, bt = _paged_inputs()
    lens = (5, 17, 33, 40)
    jk, jr = _jax_paged(q, kp, vp, bt, lens, jnp.bfloat16, 0.2)
    out = _port_paged(q, kp, vp, bt, lens, torch.bfloat16, 0.2,
                      pa.paged_attention)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), jr, rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(out.float().numpy(), jk, rtol=1e-2,
                               atol=1e-2 * np.abs(jk).max())


def test_paged_attention_dead_positions_never_matter():
    """Poisoning every pool position outside the live contexts leaves
    the output bit-identical."""
    q, kp, vp, bt = _paged_inputs(maxb=4)
    lens = np.array([9, 3, 17, 8], np.int32)
    out = _port_paged(q, kp, vp, bt, lens, torch.float32, 0.3,
                      pa.paged_attention)
    live = np.zeros(kp.shape[:2], bool)
    for b in range(len(lens)):
        for t in range(lens[b]):
            live[bt[b, t // 8], t % 8] = True
    pk = np.where(live[:, :, None, None], kp, 1e9).astype(np.float32)
    pv = np.where(live[:, :, None, None], vp, -1e9).astype(np.float32)
    out2 = _port_paged(q, pk, pv, bt, lens, torch.float32, 0.3,
                       pa.paged_attention)
    assert torch.equal(out, out2)


def test_paged_decode_supported_geometry():
    assert pa.paged_decode_supported(64, 16)
    assert pa.paged_decode_supported(128, 8)
    assert not pa.paged_decode_supported(32, 16)
    assert not pa.paged_decode_supported(64, 12)
    assert not pa.paged_decode_supported(64, 0)
    assert pa.paged_decode_supported(64, 512)


@pytest.mark.parametrize("b,t,h,d,maxb,bs,want", [
    (8, 1, 16, 64, 4, 16, 0),                       # one chunk: no partials
    (8, 1, 16, 64, 64, 16, 8 * 1 * 16 * 16 * 66),   # the decode table
    (8, 4, 16, 64, 65, 16, 8 * 4 * 16 * 17 * 66),   # + the NULL column
    (2, 8, 8, 128, 3, 24, 2 * 8 * 8 * 2 * 130),     # 72 positions: 2 chunks
])
def test_paged_workspace_follows_the_table_width(b, t, h, d, maxb, bs, want):
    """The kernel's chunk partials: one (m, l, acc[D]) per sequence,
    head, slot and PAGED_CHUNK-token chunk of the table's width; none
    when the table spans one chunk."""
    assert pa.PAGED_CHUNK == 64
    assert pa.workspace_numel(b, t, h, d, maxb, bs) == want


_LN_CASES = [(act, approx, res)
             for act, approx in ((None, True), ("gelu", True),
                                 ("gelu", False))
             for res in (False, True)]


@pytest.mark.parametrize("act,approx,res", _LN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(act, approx, res, dtype):
    rng = np.random.RandomState(3)
    n, h = 10, 96
    x = rng.randn(n, h).astype(np.float32)
    r = rng.randn(n, h).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, js, jmu, jrs = jax_ln._ln_fwd_impl(
        jnp.asarray(x, jd), jnp.asarray(r, jd) if res else None,
        jnp.asarray(w), jnp.asarray(b), 1e-5, act, approx, True)
    if res and dtype == "bfloat16":
        # Run through XLA on the CPU, the Pallas kernel writes s rounded
        # to bf16 but takes its statistics from the unrounded f32 sum
        # (the f32->bf16->f32 round trip is folded away). Its stated
        # contract (layernorm.py:86-91) is the unfused composition's:
        # statistics of the ROUNDED sum. Hold the port to that: the
        # kernel's statistics over its own (rounded) s output.
        jy, _, jmu, jrs = jax_ln._ln_fwd_impl(
            js, None, jnp.asarray(w), jnp.asarray(b), 1e-5, act, approx,
            True)
    ty, ts, tmu, trs = ln.layer_norm_fwd(
        torch.from_numpy(x).to(td),
        torch.from_numpy(r).to(td) if res else None,
        torch.from_numpy(w), torch.from_numpy(b), 1e-5, act, approx)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert ty.dtype == td and tmu.shape == (n,) and trs.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trs.numpy(), np.asarray(jrs)[:, 0],
                               rtol=1e-5, atol=1e-5)
    if res:
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
    else:
        assert ts is None


def test_public_layer_norm_api_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 64).astype(np.float32)
    r = rng.randn(2, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    jy = jax_ln.fused_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), 1e-5, "gelu", True, True)
    ty = ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), 1e-5, "gelu", True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    jy, js = jax_ln.fused_residual_layer_norm(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), jnp.asarray(b),
        1e-5, None, True, True)
    ty, ts = ln.fused_residual_layer_norm(
        torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(w),
        torch.from_numpy(b), 1e-5)
    assert ty.shape == (2, 5, 64) and ts.shape == (2, 5, 64)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="activation"):
        ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), activation="relu")


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: the kernel
    library is never built or loaded and no launch is counted."""
    def no_kernels():
        raise AssertionError("kernel library touched for CPU tensors")

    monkeypatch.setattr(kernels, "load", no_kernels)
    monkeypatch.setattr(kernels, "build", no_kernels)
    monkeypatch.setattr(ln, "load", no_kernels)
    monkeypatch.setattr(pa, "load", no_kernels)
    before = kernels.launches()
    q, kp, vp, bt = _paged_inputs()
    out = _port_paged(q, kp, vp, bt, (3, 4, 5, 6), torch.float32, 0.2,
                      pa.paged_attention)
    ref = _port_paged(q, kp, vp, bt, (3, 4, 5, 6), torch.float32, 0.2,
                      pa.paged_attention_reference)
    assert torch.equal(out, ref)
    x = torch.randn(3, 64)
    w, b = torch.ones(64), torch.zeros(64)
    assert torch.equal(ln.fused_layer_norm(x, w, b),
                       ln.fused_layer_norm_reference(x, w, b))
    assert kernels.launches() == before


def test_other_devices_raise():
    """No quiet path for devices the port has no kernel for."""
    meta = torch.device("meta")
    x = torch.empty(4, 64, device=meta)
    w = torch.empty(64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ln.fused_layer_norm(x, w, w)
    q = torch.empty(2, 4, 64, device=meta)
    pool = torch.empty(6, 8, 4, 64, device=meta)
    bt = torch.empty(2, 3, dtype=torch.int32, device=meta)
    cl = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q, pool, pool, bt, cl)


def test_cuda_requested_without_gpu_raises(monkeypatch):
    from paddle_tpu_torch.inference.serving import LLMEngine, PagedKVCache
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                    num_heads=2, ffn_hidden=32, max_seq_len=16)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(1, 2, 8, block_size=4, num_blocks=4)
    model = GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(model, num_blocks=8)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_input_checks_raise():
    """The checks a wrapper runs on CUDA tensors before launching
    reject what the kernel does not take."""
    x = torch.randn(2, 5000)
    with pytest.raises(ValueError, match="hidden size"):
        ln._check(x, None, torch.ones(5000), torch.zeros(5000))
    x = torch.randn(2, 64)
    with pytest.raises(ValueError, match="weight"):
        ln._check(x, None, torch.ones(64, dtype=torch.float64),
                  torch.zeros(64))
    with pytest.raises(ValueError, match="residual"):
        ln._check(x, torch.randn(3, 64), torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="contiguous"):
        ln._check(torch.randn(64, 2).T, None, torch.ones(64),
                  torch.zeros(64))
    q = torch.randn(2, 4, 64)
    with pytest.raises(ValueError, match="heads/dim"):
        pa._check(q, torch.randn(6, 8, 4, 32), torch.randn(6, 8, 4, 32),
                  torch.zeros(2, 3, dtype=torch.int32),
                  torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="batch"):
        pa._check(q, torch.randn(6, 8, 4, 64), torch.randn(6, 8, 4, 64),
                  torch.zeros(3, 3, dtype=torch.int32),
                  torch.ones(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,approx,res", _LN_CASES)
def test_layer_norm_grads_match_jax(act, approx, res):
    """Gradients of sum(sin(y)) (+ sum(cos(s))) through the port's
    Functions and through jax.grad of the Pallas kernels' VJPs: the
    cotangent trick of test_pallas_fusion.py, which makes both outputs
    carry a non-trivial cotangent."""
    rng = np.random.RandomState(6)
    x, r = (rng.randn(3, 7, 96).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.randn(96)).astype(np.float32)
    b = (0.1 * rng.randn(96)).astype(np.float32)

    if res:
        def f(x, r, w, b):
            y, s = jax_ln.fused_residual_layer_norm(x, r, w, b, 1e-5, act,
                                                    approx, True)
            return jnp.sum(jnp.sin(y)) + jnp.sum(jnp.cos(s))
        want = jax.grad(f, (0, 1, 2, 3))(x, r, w, b)
    else:
        def f(x, w, b):
            return jnp.sum(jnp.sin(jax_ln.fused_layer_norm(
                x, w, b, 1e-5, act, approx, True)))
        want = jax.grad(f, (0, 1, 2))(x, w, b)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in ((x, r, w, b) if res else (x, w, b))]
    if res:
        y, s = ln.fused_residual_layer_norm(*leaves, 1e-5, act, approx)
        loss = y.sin().sum() + s.cos().sum()
    else:
        loss = ln.fused_layer_norm(*leaves, 1e-5, act, approx).sin().sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())
    if res:   # x and the residual get the same gradient
        assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("h", [64, 100, 1024])
def test_layer_norm_bwd_matches_jax_kernel(h, res, dtype):
    """The plain backward against `_ln_bwd_impl` (interpret mode) on
    the same saved statistics, tanh GeLU, at the widths the CUDA kernel
    branches on (100: no multiple of its 8-value bf16 vector; 1024: the
    training width), with and without the residual, f32 and bf16: the
    oracle the kernel is held to on the card is held to JAX here. dx in
    f32 within 1e-5 (summation order), in bf16 within one ulp (1e-2); dw
    and db within 1e-5 x max|ref|."""
    rng = np.random.RandomState(8)
    n = 20
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    s = jnp.asarray(rng.randn(n, h), jdt)
    dy, ds = (jnp.asarray(rng.randn(n, h), jdt) for _ in range(2))
    ds = ds if res else None
    w = jnp.asarray(1 + 0.1 * rng.randn(h), jnp.float32)
    b = jnp.asarray(0.1 * rng.randn(h), jnp.float32)
    _, _, mu, rs = jax_ln._ln_fwd_impl(s, None, w, b, 1e-5, "gelu", True,
                                       True)
    jdx, jdw, jdb = jax_ln._ln_bwd_impl(dy, ds, s, w, b, mu, rs, "gelu",
                                        True, True)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    dx, dw, db = ln.layer_norm_bwd(
        t(dy).to(tdt), None if ds is None else t(ds).to(tdt), t(s).to(tdt),
        t(w), t(b), t(mu)[:, 0].contiguous(), t(rs)[:, 0].contiguous(),
        "gelu", True)
    assert dx.dtype == tdt and dw.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(jdx, np.float32),
                               rtol=tol, atol=tol)
    for got, want in ((dw, jdw), (db, jdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(b, h, s, d, seed, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (0.5 * rng.randn(b, h, s, d).astype(np.float32),
            0.5 * rng.randn(b, h, sk, d).astype(np.float32),
            0.5 * rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, s, d).astype(np.float32))


@pytest.mark.parametrize("s,d,causal", [(256, 64, False), (256, 64, True),
                                        (129, 64, True), (256, 16, True),
                                        (129, 16, False)])
def test_flash_attention_matches_jax(s, d, causal):
    """Forward, lse and all three gradients of the port's Function (the
    plain versions, on CPU tensors) against the Pallas kernels in
    interpret mode with 128 blocks, and their custom VJP."""
    q, k, v, w = _qkv(1, 2, s, d, seed=s + d)
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jax_fa._flash_fwd_impl(q, k, v, causal, scale, 128, 128, True)

    def f(q, k, v):
        return jnp.sum(jax_fa.flash_attention(q, k, v, causal, scale, 128,
                                              128, True) * w)
    want = jax.grad(f, (0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, sm_scale=scale)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=2e-5, atol=2e-5)
    _, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal, scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    for g, w_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}")


def test_flash_attention_bf16_matches_jax_kernel():
    q, k, v, _ = _qkv(1, 2, 256, 64, seed=3)
    jo, _ = jax_fa._flash_fwd_impl(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v)), True, 0.125, 128,
                                   128, True)
    jo = np.asarray(jo, np.float32)
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(a).bfloat16()
                                      for a in (q, k, v)), True, 0.125)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), jo, rtol=2e-2,
                               atol=2e-2 * np.abs(jo).max())


def test_flash_attention_cross_attention_matches_jax():
    """Non-causal, sq != sk, ragged: the padded-KV mask."""
    q, k, v, _ = _qkv(1, 2, 100, 64, seed=4, sk=200)
    jo, jlse = jax_fa._flash_fwd_impl(q, k, v, False, 0.125, 128, 128, True)
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    False, 0.125)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


def test_causal_masks_diverge_when_sq_ne_sk():
    """A divergence in the reference: the Pallas kernel masks causal
    attention from the top left (q_pos >= k_pos, `_mask_scores`),
    `_attn_ref` from the bottom right (tril(k=sk-sq)). With sq == sk
    they agree; with sq != sk they do not, and the port, which follows
    the kernel, refuses the call."""
    q, k, v, _ = _qkv(1, 1, 128, 16, seed=5, sk=256)
    kern, _ = jax_fa._flash_fwd_impl(q, k, v, True, 0.25, 128, 128, True)
    _, dense = jax_fa._attn_ref(q, k, v, True, 0.25)
    assert np.abs(np.asarray(kern) - np.asarray(dense)).max() > 0.1
    # query row 0 sees key 0 alone under the kernel's mask
    np.testing.assert_allclose(np.asarray(kern)[0, 0, 0], v[0, 0, 0],
                               rtol=1e-6, atol=1e-6)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="sq == sk"):
        fa.flash_attention(tq, tk, tv, causal=True, sm_scale=0.25)
    with pytest.raises(ValueError, match="sq == sk"):
        fa.flash_attention_fwd_reference(tq, tk, tv, True, 0.25)
    q, k, v, _ = _qkv(1, 1, 128, 16, seed=5)
    kern, _ = jax_fa._flash_fwd_impl(q, k, v, True, 0.25, 128, 128, True)
    _, dense = jax_fa._attn_ref(q, k, v, True, 0.25)
    np.testing.assert_allclose(np.asarray(kern), np.asarray(dense),
                               rtol=2e-5, atol=2e-5)


def test_flash_plain_versions_round_like_the_kernel():
    """bf16: the forward rounds the un-normalised p (so o differs from
    a dense softmax that rounds the normalised p), the backward pieces
    compose to flash_attention_bwd_reference."""
    q, k, v, w = (torch.from_numpy(a).bfloat16()
                  for a in _qkv(2, 2, 64, 64, seed=6))
    o, lse = fa.flash_attention_fwd_reference(q, k, v, True, 0.125)
    s = fa._masked_scores(q, k, True, 0.125)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    want = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    assert torch.equal(o, want.bfloat16())
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, o, lse, w, True,
                                                  0.125)
    delta = (w.float() * o.float()).sum(-1)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, w, lse, delta,
                                                     True, 0.125))
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, w, lse, delta, True,
                                          0.125)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_flash_supported_and_shape_checks():
    assert fa.flash_supported(64) and fa.flash_supported(128)
    assert not fa.flash_supported(32) and not fa.flash_supported(16)
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="B, H, S, D"):
        fa.flash_attention_fwd(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention_fwd(q, torch.randn(1, 3, 8, 16),
                               torch.randn(1, 3, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        m = torch.empty(1, 2, 8, 64, device="meta")
        fa.flash_attention_fwd(m, m, m)
