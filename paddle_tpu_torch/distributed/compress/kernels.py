"""Blockwise quantize / dequantize for the quantized allreduce: the
CUDA kernels' wrappers and their plain PyTorch versions.

Counterpart of `paddle_tpu/distributed/compress/kernels.py`. A flat f32
buffer is viewed as (nblocks, block) rows, each with ONE f32 abs-max
scale:

    int8  codes = round(x / (absmax/127)) in [-127, 127]   (1 B/elem)
    fp8   codes = f8e4m3(x / (absmax/448)) on a bf16 wire carrier
          (2 B/elem; the e4m3 cast is the lossy step)

A zero block (absmax 0) gets scale 1, so its codes are exactly 0 and it
dequantizes to exactly 0: padding is bit-neutral. A block holding a NaN
gets scale 1 too (`absmax > 0` is false for NaN) and the NaN's int8 code
is 0, so the block dequantizes to finite values; an Inf gives scale
inf, codes 0 and NaN after dequantize. That is the JAX package's
behaviour, which the kernels keep.

`quantize_blocks` / `dequantize_blocks` launch the int8 kernels
(`csrc/compress.cu`, counted as `quantize_i8` / `dequantize_i8` in
`incubate.nn.kernels.launches()`) for CUDA tensors, and take the plain
versions `quantize_ref` / `dequantize_ref` for CPU tensors. fp8 has no
kernel, in the JAX package either: it is the plain version on every
device.

The plain versions are bit-identical to the JAX package's eager
`quantize_ref` / `dequantize_ref`: the scale is a true division
`absmax / 127` (divided by a tensor, since on the card PyTorch turns a
division by a host scalar into a multiplication by its reciprocal), the
codes a true division rounded half to even. A NaN is mapped to code 0
before the int8 cast, which PyTorch leaves undefined for NaN. On the
card the int8 kernels are bit-identical to them.
"""
from __future__ import annotations

import torch

from ...incubate.nn.kernels import check, count, load

__all__ = ["quantize_blocks", "dequantize_blocks", "quantize_ref",
           "dequantize_ref", "wire_dtype", "wire_itemsize",
           "INT8_QMAX", "FP8_MAX"]

INT8_QMAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn finite max


def wire_dtype(mode):
    """The dtype that crosses the wire for a compress mode."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.bfloat16  # e4m3 values on a bf16 carrier
    return torch.float32


def wire_itemsize(mode):
    return torch.empty((), dtype=wire_dtype(mode)).element_size()


def _as_blocks(flat, block):
    if flat.numel() % block:
        raise ValueError(
            f"compress: buffer of {flat.numel()} elements is not a "
            f"multiple of the scale block ({block}) — pack/pad upstream")
    return flat.reshape(-1, block)


def _block_scales(xb, qmax):
    amax = xb.abs().amax(dim=-1)            # propagates NaN
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones_like(amax))


def quantize_ref(flat, block, mode):
    """flat f32 (any shape, numel % block == 0) -> (codes, scales).
    codes: wire-dtype tensor of flat's shape; scales: f32
    (numel/block,)."""
    xb = _as_blocks(flat.float(), block)
    if mode == "int8":
        s = _block_scales(xb, INT8_QMAX)
        r = torch.round(xb / s[:, None]).clamp(-INT8_QMAX, INT8_QMAX)
        q = torch.nan_to_num(r, nan=0.0).to(torch.int8)
    elif mode == "fp8":
        s = _block_scales(xb, FP8_MAX)
        q = (xb / s[:, None]).to(torch.float8_e4m3fn).to(torch.bfloat16)
    else:
        raise ValueError(f"compress: unknown quantize mode {mode!r}")
    return q.reshape(flat.shape), s


def dequantize_ref(codes, scales, block, mode):
    """Inverse of quantize_ref: wire codes + per-block scales -> f32 of
    codes' shape (`float(code) * scale`, one rounding)."""
    del mode
    qb = _as_blocks(codes, block).float()
    return (qb * scales.reshape(-1, 1)).reshape(codes.shape)


def _check_cuda(name, t, dtype, block, align):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                         f"version), got {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor, got "
                         f"{t.dtype} (contiguous={t.is_contiguous()})")
    if block <= 0 or block % 128:
        raise ValueError(f"{name}: block {block} must be a positive "
                         "multiple of 128")
    if t.numel() % block:
        raise ValueError(f"{name}: {t.numel()} elements is not a multiple "
                         f"of the scale block ({block})")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the buffer must be {align}-byte "
                         "aligned (the kernel moves vectors)")


def quantize_blocks(flat, block, mode):
    """quantize_ref's result; int8 on a CUDA tensor launches kernel
    `quantize_i8`, anything else takes the plain version."""
    if mode != "int8" or flat.device.type == "cpu":
        return quantize_ref(flat, block, mode)
    _check_cuda("quantize_i8", flat, torch.float32, block, 16)
    nb = flat.numel() // block
    q = torch.empty(flat.shape, dtype=torch.int8, device=flat.device)
    s = torch.empty(nb, dtype=torch.float32, device=flat.device)
    if nb:
        rc = load().ptt_quantize_i8(
            flat.data_ptr(), q.data_ptr(), s.data_ptr(), nb, block,
            torch.cuda.current_stream(flat.device).cuda_stream)
        check(rc, "quantize_i8")
        count("quantize_i8")
    return q, s


def dequantize_blocks(codes, scales, block, mode):
    """dequantize_ref's result; int8 codes on the card launch kernel
    `dequantize_i8`, anything else takes the plain version."""
    if mode != "int8" or codes.device.type == "cpu":
        return dequantize_ref(codes, scales, block, mode)
    _check_cuda("dequantize_i8", codes, torch.int8, block, 4)
    nb = codes.numel() // block
    if (scales.device != codes.device or scales.dtype != torch.float32
            or not scales.is_contiguous() or scales.numel() != nb):
        raise ValueError(f"dequantize_i8: scales must be {nb} contiguous "
                         f"f32 values on {codes.device}, got "
                         f"{scales.numel()} {scales.dtype} on "
                         f"{scales.device}")
    if codes.numel() >= 1 << 33:
        raise ValueError(f"dequantize_i8: {codes.numel()} codes; the "
                         "kernel's 32-bit index takes fewer than 2^33")
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if nb:
        rc = load().ptt_dequantize_i8(
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
            codes.numel(), block,
            torch.cuda.current_stream(codes.device).cuda_stream)
        check(rc, "dequantize_i8")
        count("dequantize_i8")
    return out
