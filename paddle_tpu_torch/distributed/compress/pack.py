"""Flat-buffer packing for the quantized allreduce, the port of
`paddle_tpu/distributed/compress/pack.py`.

Every gradient raveled to f32, concatenated in a stable segment order
and zero-padded to the allreduce's (W * block)-multiple length. Zero
pads quantize to exactly 0 and add exactly 0 to the reduced sum, so
padding never changes the result, only the wire accounting, which
counts it.
"""
from __future__ import annotations

import torch

__all__ = ["segments", "total_elems", "pack_flat", "unpack_flat"]


def segments(names, arrays):
    """(name, n_elems) per packed tensor, in the given stable order."""
    return [(n, int(arrays[n].numel())) for n in names]


def total_elems(segs):
    return sum(ne for _, ne in segs)


def pack_flat(segs, arrays, padded):
    """arrays: name -> tensor (any shape and float dtype, one device).
    Returns the (padded,) f32 buffer, written in one pass."""
    total = total_elems(segs)
    if int(padded) < total:
        raise ValueError(
            f"compress.pack: padded length {padded} < payload {total}")
    dev = arrays[segs[0][0]].device if segs else None
    flat = torch.empty(int(padded), dtype=torch.float32, device=dev)
    off = 0
    for n, ne in segs:
        flat[off:off + ne].copy_(arrays[n].reshape(-1))
        off += ne
    flat[off:].zero_()
    return flat


def unpack_flat(segs, flat, shapes):
    """{name: view of flat reshaped to shapes[name]}."""
    out = {}
    off = 0
    for n, ne in segs:
        out[n] = flat[off:off + ne].view(shapes[n])
        off += ne
    return out
