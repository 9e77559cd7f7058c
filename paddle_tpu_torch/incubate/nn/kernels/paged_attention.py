"""Ragged paged attention: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of `paddle_tpu/incubate/nn/pallas/paged_attention.py`.
Decode shape, one query token per sequence:

    q            [B, H, D]           this step's query rows
    k/v pool     [N, BS, H, D]       one layer's paged pool
    block_tables [B, MAXB] int32     pool block id per (seq, slot)
    context_lens [B]       int32     real tokens per sequence

One launch (`csrc/paged_attention.cu`) covers every sequence of a
continuous-batching decode step at mixed context lengths, reading only
the blocks each sequence's context covers. `paged_attention_reference`
is the dense gather the kernel must match, with the kernel's rounding,
and the path CPU tensors take.

`paged_attention_multi` is the multi-query form that verifies a
speculative window in one launch: q [B, T, H, D] with T <= 8 slots,
slot t of sequence b seeing `context_lens[b] + t` tokens through the
same table (per-slot causal masking). `paged_attention_multi_reference`
is its plain version, with the same rounding; it has no limit on T, and
the prefix cache's tail prefill uses it for a whole prompt tail. One
kernel serves both wrappers: the decode step is its one-slot launch,
counted apart as `paged_attention`.
"""
from __future__ import annotations

import torch

from . import DTYPE_BF16, DTYPE_F32, check, count, load

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_multi", "paged_attention_multi_reference",
           "paged_decode_supported", "MAX_QUERY_SLOTS"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}
# the multi-query kernel unrolls its slot loop (paged_attention.py:260)
MAX_QUERY_SLOTS = 8


def paged_decode_supported(head_dim, block_size):
    """Can the CUDA kernel take this geometry? head_dim 64 or 128 and
    block_size a multiple of 8, as the TPU kernel asks."""
    return head_dim in (64, 128) and block_size > 0 and block_size % 8 == 0


def paged_attention_reference(q, k_pool, v_pool, block_tables,
                              context_lens, sm_scale=1.0):
    """Dense gather with the kernel's rounding: f32 scores, -1e30 mask
    past each context, un-normalised p = exp(s - max) cast to the pool
    dtype before P.V (as the TPU kernel does, paged_attention.py:113),
    P.V and the denominator in f32, then acc / max(l, 1e-30) rounded
    once to q's dtype. Positions past a context get exactly zero
    weight, as in the kernel, which never reads them."""
    tables = block_tables.long()
    seq_k = k_pool[tables]                 # [B, MAXB, BS, H, D]
    seq_v = v_pool[tables]
    b, maxb, bs, h, d = seq_k.shape
    seq_k = seq_k.reshape(b, maxb * bs, h, d)
    seq_v = seq_v.reshape(b, maxb * bs, h, d)
    s = torch.einsum("bhd,bshd->bhs", q.float(), seq_k.float()) * sm_scale
    pos = torch.arange(maxb * bs, device=q.device)
    mask = (pos[None, :] < context_lens.long()[:, None])[:, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)[..., None]           # [B, H, 1]
    pt = p.to(v_pool.dtype).float()        # p in the pool dtype
    acc = torch.einsum("bhs,bshd->bhd", pt, seq_v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, context_lens):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [B, H, D] and pools [N, BS, H, D], got "
            f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    b, h, d = q.shape
    n, bs, hk, dk = k_pool.shape
    if (hk, dk) != (h, d) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool heads/dim {(hk, dk)} (v {tuple(v_pool.shape)}) != "
            f"query {(h, d)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or context_lens.shape != (b,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / context_lens "
            f"{tuple(context_lens.shape)} do not match batch {b}")
    return b, h, d, bs


def _kernel_checks(name, q, k_pool, v_pool, block_tables, context_lens):
    """Raise unless the kernels can take this call: a CUDA device,
    head_dim 64 or 128 and block_size % 8 == 0, q and pools of one
    dtype (f32 or bf16), int32 tables and lengths, one device,
    contiguous tensors."""
    if q.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA (kernel) or CPU (plain version), got "
            f"{q.device}")
    d, bs = q.shape[-1], k_pool.shape[1]
    if not paged_decode_supported(d, bs):
        raise ValueError(
            f"{name} kernel takes head_dim 64/128 and block_size % 8 == 0,"
            f" got head_dim {d}, block_size {bs}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            f"{name} takes q and pools of one dtype, f32 or bf16; got "
            f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 \
            or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    for t in (k_pool, v_pool, block_tables, context_lens):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    for t in (q, k_pool, v_pool, block_tables, context_lens):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    sm_scale=1.0):
    """Ragged paged-attention decode: one launch, all sequences.

    CUDA tensors launch the kernel (q and pools one dtype, f32 or bf16;
    tables and lens int32; all contiguous); CPU tensors take
    `paged_attention_reference`; anything else raises."""
    b, h, d, _ = _check(q, k_pool, v_pool, block_tables, context_lens)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens, sm_scale)
    _kernel_checks("paged_attention", q, k_pool, v_pool, block_tables,
                   context_lens)
    # the decode step is the multi-query kernel's one-slot launch
    out = _launch("paged_attention", q.view(b, 1, h, d), k_pool, v_pool,
                  block_tables, context_lens, sm_scale)
    return out.view(b, h, d)


def paged_attention_multi_reference(q, k_pool, v_pool, block_tables,
                                    context_lens, sm_scale=1.0):
    """Dense multi-query gather with the kernel's rounding (as
    `paged_attention_reference`): q [B, T, H, D], slot t of sequence b
    sees `context_lens[b] + t` tokens; f32 scores, -1e30 mask, p
    un-normalised and cast to the pool dtype before P.V, then
    acc / max(l, 1e-30) rounded once to q's dtype. Any T: the tail
    prefill runs a whole prompt tail through it (slot t at absolute
    position context_lens[b] - 1 + t)."""
    tables = block_tables.long()
    seq_k = k_pool[tables]                 # [B, MAXB, BS, H, D]
    seq_v = v_pool[tables]
    b, maxb, bs, h, d = seq_k.shape
    t = q.shape[1]
    seq_k = seq_k.reshape(b, maxb * bs, h, d)
    seq_v = seq_v.reshape(b, maxb * bs, h, d)
    s = torch.einsum("bthd,bshd->bths", q.float(), seq_k.float()) \
        * sm_scale
    pos = torch.arange(maxb * bs, device=q.device)
    ctx = context_lens.long()[:, None] \
        + torch.arange(t, device=q.device)[None, :]      # [B, T]
    mask = (pos[None, None, :] < ctx[:, :, None])[:, :, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)[..., None]           # [B, T, H, 1]
    pt = p.to(v_pool.dtype).float()        # p in the pool dtype
    acc = torch.einsum("bths,bshd->bthd", pt, seq_v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def paged_attention_multi(q, k_pool, v_pool, block_tables, context_lens,
                          sm_scale=1.0):
    """Multi-query ragged paged attention: one launch verifies a whole
    speculative window. q [B, T, H, D] with T <= 8 (more raises
    ValueError, as the TPU kernel's wrapper does); slot t of sequence b
    sees `context_lens[b] + t` tokens. The table's width is read from
    `block_tables` (the speculative path passes one NULL column more).

    CUDA tensors launch the kernel (q and pools one dtype, f32 or bf16;
    tables and lens int32; all contiguous); CPU tensors take
    `paged_attention_multi_reference`; anything else raises."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    t = q.shape[1]
    if t < 1 or t > MAX_QUERY_SLOTS:
        raise ValueError(
            f"paged_attention_multi unrolls its slot loop: T={t} query "
            f"slots, it takes 1..{MAX_QUERY_SLOTS}; use the plain version "
            "for long windows")
    _check(q[:, 0], k_pool, v_pool, block_tables, context_lens)
    if q.device.type == "cpu":
        return paged_attention_multi_reference(q, k_pool, v_pool,
                                               block_tables, context_lens,
                                               sm_scale)
    _kernel_checks("paged_attention_multi", q, k_pool, v_pool,
                   block_tables, context_lens)
    return _launch("paged_attention_multi", q, k_pool, v_pool, block_tables,
                   context_lens, sm_scale)


def _launch(name, q, k_pool, v_pool, block_tables, context_lens, sm_scale):
    """One launch of the kernel on checked CUDA tensors, q [B, T, H, D];
    counts it under `name`."""
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    if b == 0:                     # no sequences: nothing to launch
        return out
    lib = load()
    rc = lib.ptt_paged_attention_multi(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, t, h, d, k_pool.shape[1], block_tables.shape[1], float(sm_scale),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, name)
    count(name)
    return out
