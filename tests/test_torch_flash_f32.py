"""Why the f32 flash kernels have a float64 gate, on the CPU.

The port's f32 forward, dq and dk/dv kernels run every product on the
tensor cores as three tf32 products (3xTF32: each f32 operand split as x
= hi + lo, hi rounded to tf32, and a . b taken as lo_a.hi_b + hi_a.lo_b
+ hi_a.hi_b; the tensor cores read lo's top 19 bits). `chip_smoke.py`'s
gate 1 (`flash_f64_gate`) holds every f32
flash output within FLASH_F32_ORACLE_TOL x max|ref| of a float64 oracle
(`flash_f64_oracle`), per tensor and, causal, per row. Here, at B 1, H
2, S 256 and a ragged 129, D 64 and 128, causal and not, three versions
of the backward go through that gate:

  * the port's plain f32 version: passes, at half the limit or less;
  * the backward with each product emulated as the kernels take it,
    3xTF32 (hi by bit arithmetic on the f32 pattern, rounded to nearest
    on the low 13 bits; lo's low 13 bits cleared, as the tensor cores
    drop them): passes, at half the limit or less;
  * the same with one-pass TF32 products: fails by 10x or more. Not
    causal, as ERNIE's and BERT's f32 attention is, it still passes the
    JAX package's 2e-4 tolerance against the plain version (at 0.15-0.57
    of it), the only check the card had before gate 1: that check could
    not tell a TF32 kernel from an f32 one on the main path. Causal, it
    fails that tolerance too (dv at 2.7-3.5x).

The f32 forward kernel runs both of its products (S = Q.K^T, O += P.V)
as 3xTF32 over 64-key tiles with an online softmax in base 2, each
tile's P.V summed from 0 and added to O in f32. A tiled emulation of it
(`_fwd_tiled`) with plain f32 or 3xTF32 products passes gate 1 on o and
lse at half the limit or less; with either product in one-pass TF32 it
fails (S alone by 8.5x or more, P.V alone by 31x or more).

Causal, dq's first 8 rows are held by the per-tensor limit only: at
phase 7's S129 inputs one head's row 2 nearly cancels, and the f32
grades read past half the limit there when only row 0 is left out.

The forward (o, lse) of the three backward versions is the plain f32
one. The tiled forward and the plain backward are also held against
the JAX package's flash forward and backward (its Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them) at the JAX
tolerances.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.incubate.nn import attention_pallas as jax_fa

from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TOL = cs.FLASH_F32_ORACLE_TOL
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
SHAPES = [(s, d, causal) for s in (256, 129) for d in (64, 128)
          for causal in (True, False)]


def _inputs(s, d, seed):
    """chip_smoke's input scales: q, k, v 0.5 randn, dO randn."""
    rng = np.random.RandomState(seed)
    q, k, v = (0.5 * rng.randn(1, 2, s, d).astype(np.float32)
               for _ in range(3))
    return q, k, v, rng.randn(1, 2, s, d).astype(np.float32)


def _tf32(x):
    """x rounded to tf32 on its f32 bit pattern: half a unit added at bit
    12, the low 13 bits cleared (to nearest, ties away from zero)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _truncate(x):
    """x's low 13 bits cleared: what the tensor cores read of a tf32
    operand that was not rounded."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b in f32 from three tf32 products, the small terms first."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _truncate(a - ah), _truncate(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    """a @ b from one tf32 product: the operands' low 13 bits rounded
    away."""
    return _tf32(a) @ _tf32(b)


def _fwd_tiled(mm_s, mm_pv, q, k, v, causal, scale, keys=64):
    """(o, lse) as the f32 forward kernel computes them: KV tiles of
    `keys`, S = Q.K^T through `mm_s`, the online softmax in base 2 (scale
    * log2(e) folded in as one f32 factor, masked scores -1e30), O
    rescaled by alpha and each tile's P.V through `mm_pv` summed from 0
    and added to O in f32; o = O / max(l, 1e-30), lse = m ln 2 + log(max(l,
    1e-30)). Causal tiles past a row weigh exactly 0 here, as the kernel
    skips them."""
    f32 = torch.float32
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    sq, sk = q.shape[-2], k.shape[-2]
    m = torch.full(q.shape[:-1] + (1,), -1e30, dtype=f32)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=f32)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, keys):
        kt = k[..., k0:k0 + keys, :]
        s = mm_s(q, kt.transpose(-1, -2).contiguous())
        cols = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm_pv(p, v[..., k0:k0 + keys, :].contiguous())
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l, (m * torch.tensor(LN2, dtype=f32) + torch.log(l))[..., 0]


def _fwd_versions(s, d, causal, seed):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, d, seed))
    scale = d ** -0.5
    mm = torch.matmul
    out = {"plain f32": _fwd_tiled(mm, mm, q, k, v, causal, scale),
           "3xTF32": _fwd_tiled(_mm_3xtf32, _mm_3xtf32, q, k, v, causal,
                                scale),
           "one-pass TF32 on S": _fwd_tiled(_mm_tf32, _mm_3xtf32, q, k, v,
                                            causal, scale),
           "one-pass TF32 on P.V": _fwd_tiled(_mm_3xtf32, _mm_tf32, q, k, v,
                                              causal, scale)}
    return out, cs.flash_f64_oracle(q, k, v, do, causal, scale)[:2]


def _bwd(mm, q, k, v, do, o, lse, causal, scale):
    """The kernels' backward with every product through `mm`: p =
    exp(s - lse), ds = p (dp - delta) scale, masked scores -1e30."""
    t = lambda x: x.transpose(-1, -2).contiguous()  # noqa: E731
    s = mm(q, t(k)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - lse[..., None])
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (mm(do, t(v)) - delta) * scale
    return mm(ds, k), mm(t(ds), q), mm(t(p), do)


def _versions(s, d, causal, seed):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, d, seed))
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    plain = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale)
    out = {"plain f32": plain,
           "3xTF32": _bwd(_mm_3xtf32, q, k, v, do, o, lse, causal, scale),
           "one-pass TF32": _bwd(_mm_tf32, q, k, v, do, o, lse, causal,
                                 scale)}
    ref = cs.flash_f64_oracle(q, k, v, do, causal, scale)
    return {n: (o, lse) + g for n, g in out.items()}, ref


@pytest.mark.parametrize("variant", ["plain f32", "3xTF32"])
@pytest.mark.parametrize("s,d,causal", SHAPES)
def test_f32_grade_tiled_forward_passes_gate_1(s, d, causal, variant):
    outs, ref = _fwd_versions(s, d, causal, seed=s + d + 2)
    read = cs.flash_f64_gate(variant, outs[variant], ref, causal)
    assert max(read.values()) <= TOL / 2, read


@pytest.mark.parametrize("variant,times", [("one-pass TF32 on S", 8),
                                           ("one-pass TF32 on P.V", 30)])
@pytest.mark.parametrize("s,d,causal", SHAPES)
def test_one_pass_tf32_forward_fails_gate_1(s, d, causal, variant, times):
    """Either product in one pass fails gate 1 on o: S by 8.5x (not
    causal) to 18x, P.V by 31x to 69x at these shapes."""
    outs, ref = _fwd_versions(s, d, causal, seed=s + d + 2)
    with pytest.raises(AssertionError, match="float64 oracle"):
        cs.flash_f64_gate(variant, outs[variant], ref, causal)
    read = cs.flash_f64_gate(variant, outs[variant], ref, causal,
                             tol=float("inf"))
    assert read["o"] >= times * TOL, read


@pytest.mark.parametrize("variant", ["plain f32", "3xTF32"])
@pytest.mark.parametrize("s,d,causal", SHAPES)
def test_f32_grade_backward_passes_gate_1(s, d, causal, variant):
    outs, ref = _versions(s, d, causal, seed=s + d)
    read = cs.flash_f64_gate(variant, outs[variant], ref, causal)
    assert max(read.values()) <= TOL / 2, read


@pytest.mark.parametrize("s,d,causal", SHAPES)
def test_one_pass_tf32_fails_gate_1_where_the_jax_tolerance_passes(s, d,
                                                                    causal):
    outs, ref = _versions(s, d, causal, seed=s + d)
    got, plain = outs["one-pass TF32"], outs["plain f32"]

    def parity():
        for name, g, w in zip(cs.FLASH_OUTPUTS[2:], got[2:], plain[2:]):
            cs.assert_close(f"one-pass TF32 {name}", g, w, 2e-4, 2e-4)
    if causal:
        with pytest.raises(AssertionError, match="over tolerance"):
            parity()
    else:
        parity()
    with pytest.raises(AssertionError, match="float64 oracle"):
        cs.flash_f64_gate("one-pass TF32", got, ref, causal)
    read = cs.flash_f64_gate("one-pass TF32", got, ref, causal,
                             tol=float("inf"))
    assert min(read[n] for n in ("dq", "dk", "dv")) >= 10 * TOL, read


@pytest.mark.parametrize("variant", ["plain f32", "3xTF32"])
def test_dq_first_causal_rows_are_held_per_tensor(monkeypatch, variant):
    """Phase 7's S129 case (its inputs as chip_smoke draws them): one
    head's dq row 2 is 0.008 x max|dq|, its terms nearly cancelling, so
    with only row 0 left to the per-tensor limit the f32 grades read
    past half the limit there; with dq's first 8 rows left to it they
    pass at half the limit or less."""
    rng = np.random.RandomState(2)
    for tag, b, h, sq, d, dtype, causal, sk in cs.FLASH_CASES:
        q, k, v, do = cs._flash_inputs(rng, b, h, sq, d, dtype, "cpu", sk)
        if tag == "S129":
            break
    assert dtype == torch.float32 and causal
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, True, scale)
    if variant == "plain f32":
        g = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True,
                                             scale)
    else:
        g = _bwd(_mm_3xtf32, q, k, v, do, o, lse, True, scale)
    outs, ref = (o, lse) + tuple(g), cs.flash_f64_oracle(q, k, v, do, True,
                                                         scale)
    assert max(cs.flash_f64_gate(variant, outs, ref, True).values()) \
        <= TOL / 2
    monkeypatch.setattr(cs, "FLASH_F32_DQ_FIRST_ROWS", 1)
    read = cs.flash_f64_gate(variant, outs, ref, True, tol=float("inf"))
    assert read["dq"] > TOL / 2, read


@pytest.mark.parametrize("s,d,causal", SHAPES)
def test_tiled_forward_matches_jax_pallas(s, d, causal):
    """o and lse of the kernel's algorithm (`_fwd_tiled`, plain f32
    products) against `_flash_fwd_impl` (interpret mode, 128 blocks):
    2e-5 abs + rel (tests/test_flash_attention.py:34)."""
    q, k, v, _ = _inputs(s, d, seed=s + d + 3)
    scale = d ** -0.5
    jo, jlse = jax_fa._flash_fwd_impl(q, k, v, causal, scale, 128, 128, True)
    mm = torch.matmul
    o, lse = _fwd_tiled(mm, mm, *(torch.from_numpy(a) for a in (q, k, v)),
                        causal, scale)
    for g, w, name in ((o, jo, "o"), (lse, jlse, "lse")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("s,d,causal", SHAPES)
def test_plain_backward_matches_jax_pallas(s, d, causal):
    """dq, dk, dv of the plain f32 backward against `_flash_bwd_impl`
    (interpret mode, 128 blocks), each from its own package's forward:
    2e-4 abs + rel (tests/test_flash_attention.py:53)."""
    q, k, v, do = _inputs(s, d, seed=s + d + 1)
    scale = d ** -0.5
    jo, jlse = jax_fa._flash_fwd_impl(q, k, v, causal, scale, 128, 128, True)
    want = jax_fa._flash_bwd_impl(q, k, v, jo, jlse, jnp.asarray(do), causal,
                                  scale, 128, 128, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_reference(tq, tk, tv, causal, scale)
    got = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, causal,
                                           scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
