"""paddle_tpu_torch.incubate.nn.kernels — the hand-written Hopper kernels.

Counterpart of `paddle_tpu.incubate.nn.pallas`. Every kernel is CUDA
C++ under `paddle_tpu_torch/csrc/`, compiled for `sm_90a` at first use
and bound through `ctypes` (a plain C interface: no PyTorch headers, so
a build takes seconds):

- `layernorm.fused_layer_norm` / `fused_residual_layer_norm`: row
  LayerNorm with an optional residual-add prologue and GeLU epilogue,
  forward and backward (`csrc/layernorm.cu`).
- `paged_attention.paged_attention_multi`: ragged paged attention, up
  to 8 query slots per sequence, K/V read through block tables, slot t
  seeing t more tokens (speculative-decode verification), and
  `paged_attention.paged_attention`: the decode step, its one-slot
  launch (`csrc/paged_attention.cu`).
- `flash_attention.flash_attention`: tiled online-softmax attention,
  forward and the two backward kernels, dq and dk/dv
  (`csrc/flash_attention.cu`).
- `optim.fused_adam` / `fused_sgd` / `fused_momentum`: multi-tensor
  optimizer updates, one launch over a whole parameter list
  (`csrc/optim.cu`).
- `paddle_tpu_torch.distributed.compress.kernels.quantize_blocks` /
  `dequantize_blocks`: blockwise int8 quantize and dequantize, the wire
  format of the quantized gradient allreduce (`csrc/compress.cu`).

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version only for CPU tensors. There is no switch that turns the
kernels off on the card and no fallback when a build or launch fails:
on CUDA the kernels are the path. Each wrapper adds one to its launch
count (`launches()`) when its kernel launched.

The build goes into `paddle_tpu_torch/_build/`, one `nvcc -c` per
source started together, then one link into a shared library named by
a digest of the sources and flags. Nothing is compiled or loaded when
this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["build", "load", "check", "count", "launches",
           "reset_launches", "build_info", "SOURCES", "NVCC_FLAGS"]

PKG_DIR = Path(__file__).resolve().parents[3]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("layernorm.cu", "paged_attention.cu", "flash_attention.cu",
           "optim.cu", "compress.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes shared with csrc/*.cu
DTYPE_F32 = 0
DTYPE_BF16 = 1

# kernel name -> launches since the last reset (one per wrapper call
# that launched the kernel; plain-version calls on the CPU never count)
_LAUNCHES = {"paged_attention": 0, "paged_attention_multi": 0,
             "fused_layer_norm": 0,
             "fused_layer_norm_bwd": 0, "flash_attention_fwd": 0,
             "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
             "fused_adam": 0, "fused_sgd": 0, "fused_momentum": 0,
             "quantize_i8": 0, "dequantize_i8": 0}

_lib = None
_lib_lock = threading.Lock()
_build_info = {}


def count(name):
    _LAUNCHES[name] += 1


def launches():
    """{kernel name: launches since the last reset_launches()}."""
    return dict(_LAUNCHES)


def reset_launches():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
        "port's CUDA kernels are compiled from paddle_tpu_torch/csrc "
        "at first use")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile csrc/*.cu into one shared library (cached by digest);
    returns its path. Records the build seconds and nvcc's output
    (`-Xptxas=-v`: registers, shared memory, spills) in build_info()."""
    so = BUILD_DIR / f"libpaddle_tpu_torch_kernels-{_digest()}.so"
    if so.exists():
        _build_info.setdefault("seconds", 0.0)
        _build_info.setdefault("log", "")
        _build_info["path"] = str(so)
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
             "-shared", "-o", tmp_so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _build_info.update(seconds=time.perf_counter() - t0,
                       log="\n".join(logs), path=str(so))
    return so


def build_info():
    """{"seconds", "log", "path"} of this process's build (seconds is
    0.0 when the library was already built)."""
    return dict(_build_info)


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ptt_layer_norm_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                       f, i, i, i, p]
    lib.ptt_layer_norm_fwd.restype = i
    lib.ptt_layer_norm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i,
                                       i, i, i, i, p]
    lib.ptt_layer_norm_bwd.restype = i
    ip = ctypes.POINTER(i)
    for name in ("ptt_layer_norm_fwd_plan", "ptt_layer_norm_bwd_plan"):
        getattr(lib, name).argtypes = [i, i, i, i, i, ip, ip]
        getattr(lib, name).restype = i
    lib.ptt_paged_attention_multi.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                              i, i, i, i, f, i, p]
    lib.ptt_paged_attention_multi.restype = i
    lib.ptt_paged_chunk.argtypes = []
    lib.ptt_paged_chunk.restype = i
    lib.ptt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, p]
    lib.ptt_flash_fwd.restype = i
    lib.ptt_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i,
                                     i, p]
    lib.ptt_flash_bwd_dq.restype = i
    lib.ptt_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f,
                                      i, i, p]
    lib.ptt_flash_bwd_dkv.restype = i
    lib.ptt_fused_optim.argtypes = [p, p, i, p]
    lib.ptt_fused_optim.restype = i
    for name in ("ptt_optim_entry_size", "ptt_optim_max_tensors",
                 "ptt_optim_chunk"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    q = ctypes.c_longlong
    lib.ptt_quantize_i8.argtypes = [p, p, p, q, i, p]
    lib.ptt_quantize_i8.restype = i
    lib.ptt_dequantize_i8.argtypes = [p, p, p, q, i, p]
    lib.ptt_dequantize_i8.restype = i
    lib.ptt_error_string.argtypes = [i]
    lib.ptt_error_string.restype = ctypes.c_char_p


def load():
    """The kernel library, built and loaded at first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def check(rc, name):
    """Raise when a C entry point's cudaGetLastError() was not 0."""
    if rc:
        msg = _lib.ptt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
