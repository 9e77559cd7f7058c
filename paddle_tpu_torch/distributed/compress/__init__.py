"""paddle_tpu_torch.distributed.compress — the quantized gradient
allreduce with error feedback, the port of
`paddle_tpu/distributed/compress` (EQuARX, arxiv 2506.17615).

    kernels.py    blockwise int8 / fp8-on-bf16-carrier quantize and
                  dequantize: plain PyTorch versions, and wrappers that
                  launch the CUDA kernels (csrc/compress.cu) for int8
                  on the card
    pack.py       the flat f32 buffer the gradients are packed into
    allreduce.py  the two-phase quantized allreduce over a
                  torch.distributed group, and the
                  comm/all_reduce/{bytes,wire_bytes} accounting

Wired through `jit.distributed.DistributedTrainStepCompiler(
comm_compress=...)` (default `$PADDLE_COMM_COMPRESS`) and
`distributed.all_reduce(tensor, compress=...)`.

Spec grammar (PADDLE_COMM_COMPRESS / comm_compress= / compress=):

    fp32 | int8 | fp8 [:ef] [:block=N]

`fp32` is the explicit twin: the same accounting over an uncompressed
wire, the baseline the wire_bytes ratio is judged against. The block
size defaults to $PADDLE_COMM_BLOCK (1024 elements a scale, a multiple
of 128).
"""
from __future__ import annotations

import os
import warnings

from ...core import monitor as _monitor

__all__ = ["CompressConfig", "parse_spec", "from_env", "resolve",
           "MODES", "DEFAULT_BLOCK"]

MODES = ("fp32", "int8", "fp8")
DEFAULT_BLOCK = 1024


def _env_block():
    try:
        return int(os.environ.get("PADDLE_COMM_BLOCK", DEFAULT_BLOCK))
    except ValueError:
        return DEFAULT_BLOCK


class CompressConfig:
    """One resolved compression policy: mode (fp32/int8/fp8), error
    feedback on/off, elements per scale block."""

    def __init__(self, mode, ef=False, block=None):
        if mode not in MODES:
            raise ValueError(
                f"comm compress mode {mode!r} unknown (known: "
                f"{', '.join(MODES)})")
        block = int(block if block is not None else _env_block())
        if block <= 0 or block % 128:
            raise ValueError(
                f"comm compress block {block} must be a positive "
                "multiple of 128 (the packed-lane width)")
        if ef and mode == "fp32":
            raise ValueError(
                "comm compress 'fp32:ef' is meaningless — error "
                "feedback corrects quantization error and fp32 has "
                "none")
        self.mode = mode
        self.ef = bool(ef)
        self.block = block

    def spec(self):
        return self.mode + (":ef" if self.ef else "")

    def __repr__(self):
        return f"CompressConfig({self.spec()}, block={self.block})"

    def __eq__(self, other):
        return (isinstance(other, CompressConfig)
                and (self.mode, self.ef, self.block)
                == (other.mode, other.ef, other.block))


def parse_spec(spec):
    """`mode[:ef][:block=N]` -> CompressConfig; ''/'0'/'off'/'none'
    -> None. Raises ValueError on anything else."""
    s = str(spec).strip().lower()
    if s in ("", "0", "off", "none", "false"):
        return None
    fields = [f.strip() for f in s.split(":")]
    mode, ef, block = fields[0], False, None
    for f in fields[1:]:
        if f == "ef":
            ef = True
        elif f.startswith("block="):
            block = f.split("=", 1)[1]
        else:
            raise ValueError(
                f"comm compress spec field {f!r} unknown in {spec!r} "
                "(grammar: mode[:ef][:block=N])")
    try:
        block = int(block) if block is not None else None
    except ValueError:
        raise ValueError(
            f"comm compress block {block!r} in {spec!r} is not an "
            "integer")
    return CompressConfig(mode, ef=ef, block=block)


def from_env():
    """$PADDLE_COMM_COMPRESS -> CompressConfig or None. A bad spec
    counts `comm/compress/spec_errors`, warns and gives None: it must
    not break the construction of a compiler."""
    spec = os.environ.get("PADDLE_COMM_COMPRESS", "")
    if not spec:
        return None
    try:
        return parse_spec(spec)
    except ValueError as e:
        _monitor.stat_add("comm/compress/spec_errors", 1)
        warnings.warn(f"comm compress: ignoring invalid "
                      f"PADDLE_COMM_COMPRESS spec ({e})", stacklevel=2)
        return None


def resolve(compress):
    """Normalize a per-call/constructor `compress=` value: None/False
    -> None, True -> the env config, str -> parsed, CompressConfig ->
    itself."""
    if compress is None or compress is False:
        return None
    if compress is True:
        return from_env()
    if isinstance(compress, CompressConfig):
        return compress
    return parse_spec(compress)


from . import kernels, pack  # noqa: E402  (public submodules)
from . import allreduce  # noqa: E402
from .allreduce import (account, all_reduce_flat, effective_block,  # noqa: E402
                        padded_elems, padded_len, reduce_tree,
                        wire_bytes_of)

__all__ += ["kernels", "pack", "allreduce", "account",
            "all_reduce_flat", "effective_block", "padded_elems",
            "padded_len", "reduce_tree", "wire_bytes_of"]
