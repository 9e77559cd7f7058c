"""Device resolution for the port's entry points.

The port runs on a CUDA card. `None` means the card, and asking for it
on a machine without one raises — nothing falls back to the CPU
quietly. The CPU is used only when a caller names it, as the tests do;
there every kernel wrapper takes its plain PyTorch version.

The memory half of `paddle_tpu/device/__init__.py` (reference:
paddle.device.cuda.memory_allocated / max_memory_allocated /
reset_max_memory_allocated / memory_stats) reads the card's caching
allocator through `monitor.memory`; `synchronize` waits for the card
and `cuda_device_count` counts the cards.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "memory_allocated", "max_memory_allocated",
           "reset_max_memory_allocated", "memory_stats", "synchronize",
           "cuda_device_count"]


def resolve_device(device=None):
    """`torch.device` for an entry point's `device=` argument.

    None -> "cuda" (raises when CUDA is absent); "cpu" only when asked
    for; "cuda[:N]" checked for availability. Any other device type
    raises: the kernels exist for CUDA and their plain versions for
    the CPU, nothing else."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on a CUDA card "
                "by default; pass device='cpu' to run its plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"unsupported device {dev!s}: expected 'cuda[:N]' or 'cpu'")


def memory_allocated(device=None):
    """Bytes currently allocated on the device (monitor.memory)."""
    from .monitor import memory as _mem

    return _mem.memory_allocated(device)


def max_memory_allocated(device=None):
    """High-water mark of allocated bytes since process start or the
    last reset_max_memory_allocated()."""
    from .monitor import memory as _mem

    return _mem.max_memory_allocated(device)


def reset_max_memory_allocated(device=None):
    from .monitor import memory as _mem

    return _mem.reset_max_memory_allocated(device)


def memory_stats(device=None):
    """The allocator's stat dict plus the normalized keys
    (allocated_bytes, peak_bytes, source)."""
    from .monitor import memory as _mem

    return _mem.memory_stats(device)


def synchronize(device=None):
    """Block until all queued work on the card completes (a no-op
    without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def cuda_device_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
