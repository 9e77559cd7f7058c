"""Quantized allreduce — compress, reduce-scatter in low precision,
requantize, all-gather (EQuARX, arxiv 2506.17615). The port of
`paddle_tpu/distributed/compress/allreduce.py`.

Runs in every rank of a torch.distributed group, on the flat packed
f32 gradient buffer (pack.py). For W ranks the local (L,) contribution
is viewed as W segments of S = L // W:

  phase 1  quantize all W segments blockwise (one launch),
           `all_to_all_single` the codes and the scales, so that rank r
           holds every rank's segment r; dequantize them (one launch)
           and sum in f32, in rank order — the reduce-scatter leg,
           int8/fp8 on the wire;
  phase 2  requantize the reduced segment, `all_gather` codes and
           scales, dequantize (one launch) — every rank rebuilds the
           same full reduced vector.

Error feedback (":ef"): the residual carries THIS rank's quantization
error in local-contribution units. Phase 1 adds the residual before
quantizing and keeps `x - deq(Q(x))`; phase 2's error on the segment
this rank owns (`reduced - deq(Q(reduced))`) is added into the
residual at that segment — re-contributed by exactly one rank next
step, so the long-run reduced sum is unbiased. One EF call launches 2
quantizes (over L and over S) and 4 dequantizes (L, L, S, L); without
EF 2 and 2.

Wire accounting: `comm/all_reduce/wire_bytes` uses the logical
per-rank payload convention of `comm/<op>/bytes`: codes counted once
(as the fp32 payload is, though a ring allreduce moves about twice
either way, so the fp32:quantized ratio is exact) plus both phases'
scale sidecars, which are real extra traffic.

The JAX package runs this inside a compiled shard_map island, where
XLA contracts the phase-1 dequantize-and-sum into FMAs; the port
rounds the dequantize and the sum separately, so a reduced element
can differ from the JAX package's by an ulp or two.

Monitor hooks (JAX :96-128, 159-160): `account` records the
`comm_compress` flight event, and the `comm_compress` chaos site's
`bitflip` fault XORs bit 6 into every code of scale block 0 after the
phase-1 quantize. The JAX package fires the site once, at trace time,
and bakes the flip into that built program; the port fires it on
every call while armed, so `times=` / `after=` count calls (ROADMAP
queue 3).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...core import monitor as _monitor
from ...monitor import chaos as _chaos
from ...monitor import flight as _flight
from ..env import group_rank, group_size
from . import kernels as K
from . import pack as P

__all__ = ["account", "all_reduce_flat", "effective_block",
           "padded_elems", "padded_len", "reduce_tree",
           "wire_bytes_of"]


def effective_block(cfg, total, nranks):
    """The scale block used for a `total`-element payload: cfg.block,
    clamped to the 128-multiple covering ONE rank's segment, so that a
    small payload does not pad to W * block and put more bytes on the
    'compressed' wire than on the fp32 one."""
    seg = -(-int(total) // int(nranks))
    seg128 = max(128, -(-seg // 128) * 128)
    return min(cfg.block, seg128)


def padded_len(total, nranks, block):
    """Smallest L >= total with L % (nranks * block) == 0 — the flat
    buffer length every rank packs to."""
    unit = int(nranks) * int(block)
    return int(-(-int(total) // unit) * unit) if total else unit


def padded_elems(cfg, total, nranks):
    """Elements put on the wire for a `total`-element payload: the
    quantized pipeline pads to a W*block multiple (the pads cross the
    wire and are counted); the fp32 twin reduces the exact payload."""
    if cfg is None or cfg.mode == "fp32":
        return int(total)
    return padded_len(total, nranks, effective_block(cfg, total, nranks))


def wire_bytes_of(cfg, elems, block=None):
    """Logical per-rank wire payload of one (possibly quantized)
    allreduce over `elems` on-wire f32 elements. `block` is the
    effective scale block (default cfg.block)."""
    if cfg is None or cfg.mode == "fp32":
        return elems * 4
    nblocks = elems // (block or cfg.block)
    return elems * K.wire_itemsize(cfg.mode) + 2 * nblocks * 4


def account(cfg, logical_bytes, elems, where="train_step", block=None):
    """Count one (possibly quantized) gradient allreduce in
    comm/all_reduce/{calls,bytes,wire_bytes}. `elems` is the on-wire
    element count (padded_elems), `block` the effective scale block;
    `where` names the caller in the `comm_compress` flight event.
    Returns the wire bytes."""
    wire = wire_bytes_of(cfg, elems, block=block)
    _monitor.stat_add("comm/all_reduce/calls", 1)
    _monitor.stat_add("comm/all_reduce/bytes", int(logical_bytes))
    _monitor.stat_add("comm/all_reduce/wire_bytes", int(wire))
    if _flight.recorder.enabled:
        _flight.record(
            "comm_compress", op="all_reduce",
            bytes=int(logical_bytes), wire_bytes=int(wire),
            compress=(cfg.spec() if cfg is not None else "fp32"),
            group=where)
    return wire


def _maybe_bitflip(q, cfg, block):
    """`comm_compress` chaos site, `bitflip` fault (site-interpreted):
    XOR bit 6 into every code of scale block 0 of this call's phase-1
    codes. Disarmed calls never reach this branch."""
    act = _chaos.hit("comm_compress", mode=cfg.mode, block=int(block))
    if act is None or act.fault != "bitflip":
        return q
    flat = q.reshape(-1).clone()
    if q.dtype == torch.int8:
        flat[:block] ^= 0x40
    else:
        bits = flat[:block].to(torch.bfloat16).view(torch.int16)
        flat[:block] = (bits ^ 0x40).view(torch.bfloat16).to(q.dtype)
    return flat.view(q.shape)


def _all_to_all(x, nranks, group):
    if nranks == 1:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x, nranks, group):
    if nranks == 1:
        return x[None]
    out = torch.empty((nranks,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def all_reduce_flat(flat, *, group=None, cfg, residual=None, block=None):
    """SUM-allreduce the local flat f32 buffer over `group` (None: the
    default group). Its length must be a multiple of W * block (pack.py
    guarantees it; `block` is the EFFECTIVE scale block —
    effective_block() — default cfg.block). Returns (reduced_sum,
    new_residual): new_residual is `residual` unchanged unless it was
    given (same shape as flat) and cfg.ef is on. `flat` and `residual`
    are not modified."""
    mode = cfg.mode if cfg is not None else "fp32"
    if mode == "fp32":
        out = flat.clone()
        if group_size(group) > 1:
            dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        return out, residual
    block = int(block or cfg.block)
    W = group_size(group)
    L = int(flat.shape[0])
    if L % (W * block):
        raise ValueError(f"all_reduce_flat: length {L} is not a multiple "
                         f"of W * block = {W} * {block}")
    S = L // W
    use_ef = cfg.ef and residual is not None
    x = flat + residual if use_ef else flat

    # phase 1: quantize, all_to_all (after it, row i holds rank i's
    # segment of MY output shard), dequantize, sum in rank order
    q, s = K.quantize_blocks(x.view(W, S), block, mode)
    if _chaos._armed:
        q = _maybe_bitflip(q, cfg, block)
    if use_ef:
        new_res = x - K.dequantize_blocks(q, s, block, mode).view(L)
    qr = _all_to_all(q, W, group)
    sr = _all_to_all(s, W, group)
    parts = K.dequantize_blocks(qr, sr, block, mode)
    reduced = parts[0]
    for i in range(1, W):
        reduced = reduced + parts[i]

    # phase 2: requantize the reduced segment, all_gather, dequantize
    q2, s2 = K.quantize_blocks(reduced, block, mode)
    if use_ef:
        # this rank owns output segment `me`: its requantization error
        # re-enters the sum through exactly one rank's residual. Added
        # as the JAX package adds it, mask * err2 over every row, so a
        # non-finite err2 reaches the other rows as it does there.
        err2 = reduced - K.dequantize_blocks(q2, s2, block, mode)
        mask = torch.zeros((W, 1), dtype=torch.float32, device=x.device)
        mask[group_rank(group)] = 1.0
        new_res = (new_res.view(W, S) + mask * err2).view(L)
    qg = _all_gather(q2, W, group)                  # (W, S)
    sg = _all_gather(s2, W, group)                  # (W, S // block)
    out = K.dequantize_blocks(qg, sg.view(-1), block, mode).view(L)
    return out, (new_res if use_ef else residual)


def reduce_tree(grads, segs, *, group=None, cfg, residual=None):
    """Pack a gradient dict (name -> tensor) into ONE flat f32 buffer
    (pack.py segs), SUM-allreduce it (quantized unless cfg is None or
    fp32), unpack and divide by W — the data-parallel MEAN. A cfg
    (fp32 included) counts the allreduce through account(). Returns
    (mean_grads in each gradient's dtype, new_residual)."""
    W = group_size(group)
    total = P.total_elems(segs)
    L = padded_elems(cfg, total, W)
    flat = P.pack_flat(segs, grads, L)
    blk = (effective_block(cfg, total, W)
           if cfg is not None and cfg.mode != "fp32" else None)
    if cfg is not None:
        account(cfg, total * 4, L, block=blk)
    summed, new_res = all_reduce_flat(flat, group=group, cfg=cfg,
                                      residual=residual,
                                      block=blk)
    # a true division: on the card PyTorch turns a division by a host
    # scalar into a multiplication by its reciprocal
    mean = summed / torch.tensor(float(W), device=summed.device)
    shapes = {n: grads[n].shape for n, _ in segs}
    out = P.unpack_flat(segs, mean, shapes)
    return {n: out[n].to(grads[n].dtype) for n in out}, new_res
