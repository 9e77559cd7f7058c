"""Flash attention, forward and backward: the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd Function that joins them.

Counterpart of `paddle_tpu/incubate/nn/attention_pallas.py`, in its
layout: q [B, H, Sq, D], k and v [B, H, Sk, D], one dtype (f32 or
bf16), head_dim 64 or 128 (`flash_supported`).

- `flash_attention_fwd(q, k, v, causal, sm_scale) -> (o, lse)`: one
  launch of the forward kernel; lse [B, H, Sq] f32 is the per-row
  log-sum-exp the backward recomputes p from.
- `flash_attention_bwd(q, k, v, o, lse, do, causal, sm_scale) ->
  (dq, dk, dv)`: delta = rowsum(dO * O) in f32 by torch here, outside
  the kernels, as `_flash_bwd_impl` computes it outside its kernels
  (:331); then one launch each of the dq kernel and the dk/dv kernel.
- `flash_attention(q, k, v, causal=False, sm_scale=1.0)`: the
  `torch.autograd.Function` over both (the JAX `custom_vjp`).

The causal mask is the TPU kernel's, q_pos >= k_pos from the top left
(`_mask_scores`, :81-85). The JAX package's dense `_attn_ref` masks from
the bottom right (`tril(k=sk-sq)`, :395); the two agree only when
sq == sk, so a causal call with sq != sk raises here on every device.
Masked scores are -1e30, never -inf.

The plain versions follow the kernels' rounding, not `_attn_ref`'s:
the forward rounds the UN-normalised p = exp(s - rowmax) to v's dtype
before P.V and divides by max(l, 1e-30) after (:134-147); the backward
recomputes p = exp(s - lse) in f32 and rounds ds to k's dtype and p to
dO's dtype before their products (:244-295). For CUDA tensors the
wrappers launch the kernels; for CPU tensors they run the plain
versions.
"""
from __future__ import annotations

import torch

from . import DTYPE_BF16, DTYPE_F32, check, count, load

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "flash_supported",
           "FlashAttentionFn"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}


def flash_supported(head_dim):
    """Can the CUDA kernels take this head_dim? 64 or 128, the TPU
    path's shape gate (gpt.py:124) without its S % 128 condition: the
    kernels mask a ragged sequence themselves."""
    return head_dim in (64, 128)


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention takes [B, H, S, D] tensors, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}")
    if causal and k.shape[2] != sq:
        raise ValueError(
            f"causal flash_attention needs sq == sk, got {sq} and "
            f"{k.shape[2]}: the kernel masks q_pos >= k_pos from the top "
            f"left, the JAX dense reference from the bottom right")
    return b, h, sq, k.shape[2], d


def _masked_scores(q, k, causal, sm_scale):
    """f32 scores with the kernels' mask: -1e30 where q_pos < k_pos."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def flash_attention_fwd_reference(q, k, v, causal=False, sm_scale=1.0):
    """Plain PyTorch (o, lse) with the kernel's rounding: p = exp(s -
    rowmax) cast to v's dtype, P.V in f32, then acc / max(l, 1e-30)
    rounded once to q's dtype; lse = rowmax + log(max(l, 1e-30))."""
    _check_shapes(q, k, v, causal)
    s = _masked_scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _delta(o, do):
    """rowsum(dO * O) in f32 (attention_pallas.py:331)."""
    return (do.float() * o.float()).sum(dim=-1)


def _ds(q, k, v, do, lse, delta, causal, sm_scale):
    """(p, ds) in f32: p = exp(s - lse), ds = p * (dp - delta) * scale."""
    p = torch.exp(_masked_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal=False,
                                     sm_scale=1.0):
    """Plain dq (`_fa_bwd_dq_kernel`): ds cast to k's dtype, ds.K."""
    _, ds = _ds(q, k, v, do, lse, delta, causal, sm_scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal=False, sm_scale=1.0):
    """Plain (dk, dv) (`_fa_bwd_dkv_kernel`): p cast to dO's dtype for
    dv = p^T.dO, ds cast to q's dtype for dk = ds^T.Q."""
    p, ds = _ds(q, k, v, do, lse, delta, causal, sm_scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  sm_scale=1.0):
    """Plain (dq, dk, dv) from the forward's o and lse."""
    _check_shapes(q, k, v, causal)
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                          sm_scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, sm_scale)
    return dq, dk, dv


def _check_cuda(name, tensors, rows, q):
    """The kernels' contract for CUDA tensors; raises on the rest."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {q.dtype}")
    d = q.shape[-1]
    if not flash_supported(d):
        raise ValueError(f"{name} kernel takes head_dim 64 or 128, got {d}")
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} takes tensors of one dtype, got "
                            f"{t.dtype} and {q.dtype}")
    for t in tensors + rows:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != q.shape[:3]:
            raise ValueError(
                f"{name}: lse/delta must be f32 of shape "
                f"{tuple(q.shape[:3])}, got {t.dtype} {tuple(t.shape)}")


def _device(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{name} runs on CUDA (kernel) or CPU (plain version), got "
            f"{q.device}")
    return q.device.type == "cuda"


def flash_attention_fwd(q, k, v, causal=False, sm_scale=1.0):
    """(o, lse) of attention over [B, H, S, D]. CUDA tensors launch the
    forward kernel; CPU tensors take `flash_attention_fwd_reference`."""
    b, h, sq, sk, d = _check_shapes(q, k, v, causal)
    if not _device("flash_attention", q):
        return flash_attention_fwd_reference(q, k, v, causal, sm_scale)
    _check_cuda("flash_attention", [q, k, v], [], q)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if b * h == 0 or sq == 0:          # nothing to launch
        return o, lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    lib = load()
    rc = lib.ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, sq, sk, d, float(sm_scale), int(causal),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attention_fwd")
    count("flash_attention_fwd")
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           sm_scale=1.0):
    """dq from the saved lse and delta = rowsum(dO * O): one launch of
    the dq kernel for CUDA tensors, the plain version for CPU ones."""
    b, h, sq, sk, d = _check_shapes(q, k, v, causal)
    if not _device("flash_attention", q):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, sm_scale)
    _check_cuda("flash_attention_bwd", [q, k, v, do], [lse, delta], q)
    dq = torch.empty_like(q)
    if b * h == 0 or sq == 0 or sk == 0:
        return dq.zero_()
    lib = load()
    rc = lib.ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, sq, sk, d,
        float(sm_scale), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attention_bwd_dq")
    count("flash_attention_bwd_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            sm_scale=1.0):
    """(dk, dv): one launch of the dk/dv kernel for CUDA tensors, the
    plain version for CPU ones."""
    b, h, sq, sk, d = _check_shapes(q, k, v, causal)
    if not _device("flash_attention", q):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, sm_scale)
    _check_cuda("flash_attention_bwd", [q, k, v, do], [lse, delta], q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if b * h == 0 or sq == 0 or sk == 0:
        return dk.zero_(), dv.zero_()
    lib = load()
    rc = lib.ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, sq, sk, d, float(sm_scale), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attention_bwd_dkv")
    count("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=1.0):
    """(dq, dk, dv) from the forward's o and lse: delta by torch, then
    the dq kernel and the dk/dv kernel (CPU tensors: the plain
    versions)."""
    _check_shapes(q, k, v, causal)
    if not _device("flash_attention", q):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             sm_scale)
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     sm_scale)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the flash kernels as forward and backward
    (`use_kernel=False`: the plain versions both ways)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, use_kernel):
        fwd = flash_attention_fwd if use_kernel \
            else flash_attention_fwd_reference
        o, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, sm_scale, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, use_kernel = ctx.cfg
        bwd = flash_attention_bwd if use_kernel \
            else flash_attention_bwd_reference
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal, sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, sm_scale=1.0, use_kernel=True):
    """softmax(q k^T * sm_scale [causal mask]) v over [B, H, S, D], with
    gradients. `use_kernel=False` runs the plain versions explicitly, on
    any device: the comparison path."""
    return FlashAttentionFn.apply(q, k, v, causal, sm_scale, use_kernel)
