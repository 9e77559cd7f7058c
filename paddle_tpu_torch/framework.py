"""`save` / `load`, the port of `paddle_tpu/framework.py` (:31-103).

    framework.save(model.state_dict(), "run/model.pdparams")
    state = framework.load("run/model.pdparams")     # CPU tensors

A checkpoint is a pickle of the nested dicts, lists and tuples it was
given. Every torch tensor in them is stored as a `_SavedTensor`: its
dtype name, its shape and its raw bytes (a uint8 array), so that a
bf16 tensor round-trips bit for bit without numpy knowing bf16. Other
leaves (numbers, strings, numpy arrays) are pickled as they are.
`load` gives the tensors back on the CPU (`return_numpy=True`: numpy
arrays, which bf16 cannot be).

`save` is atomic (`_atomic_write`): the pickle goes into a tmp file in
the same directory, which is fsynced and then `os.replace`d over the
path, so a kill mid-write leaves the old file or the new one.

Files the JAX package wrote load too: its `_SavedTensor`
(`paddle_tpu.framework._SavedTensor`, a numpy array under `.array`) is
mapped to a class of this module by the unpickler, so nothing of
`paddle_tpu` is imported. f32 and integer arrays load as tensors. A
bf16 array in such a file is pickled as numpy's `ml_dtypes.bfloat16`,
and reading it needs the `ml_dtypes` package: without it, `load`
raises an error that names it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


class _SavedTensor:
    """A tensor on disk: dtype name, shape, raw bytes."""

    __slots__ = ("dtype", "shape", "data")

    def __init__(self, dtype, shape, data):
        self.dtype = dtype
        self.shape = tuple(shape)
        self.data = data

    @classmethod
    def of(cls, t):
        """The saved form of a CPU tensor; `data` is a view of its
        memory (no copy for a contiguous tensor)."""
        t = t.detach().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy()
        return cls(str(t.dtype).replace("torch.", ""), t.shape, data)

    def tensor(self):
        dtype = getattr(torch, self.dtype)
        if not len(self.data):
            return torch.empty(self.shape, dtype=dtype)
        raw = torch.from_numpy(np.array(self.data, dtype=np.uint8))
        return raw.view(dtype).reshape(self.shape)


class _JaxSavedTensor:
    """What the JAX package's `_SavedTensor` unpickles into: its state,
    `{"array": ndarray}`, lands in `__dict__`."""

    def tensor(self):
        arr = np.asarray(self.array)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(arr))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "paddle_tpu.framework" and name == "_SavedTensor":
            return _JaxSavedTensor
        if module.split(".")[0] == "ml_dtypes":
            try:
                import ml_dtypes  # noqa: F401
            except ImportError:
                raise ImportError(
                    f"this checkpoint holds a numpy {name} array (written "
                    "by the JAX package); reading it needs the ml_dtypes "
                    "package, which is not installed") from None
        return super().find_class(module, name)


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return _SavedTensor.of(obj.cpu())
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj, return_numpy=False):
    if isinstance(obj, (_SavedTensor, _JaxSavedTensor)):
        t = obj.tensor()
        if not return_numpy:
            return t
        if t.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: load with "
                            "return_numpy=False for a bf16 tensor")
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _from_saved(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy) for v in obj)
    return obj


def _atomic_write(path, write_fn):
    """Crash-safe publish: `write_fn(f)` writes into a same-directory
    tmp file, which is fsynced and then `os.replace`d over `path`. A
    crash (or kill -9) mid-write leaves the old complete file or the
    new complete one, never a torn one. Shared by `save` and the
    elastic checkpoint writer."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # never leave the partial tmp behind (it would look like a
        # stray checkpoint to directory scanners)
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _dump(obj, f, protocol=5):
    """Pickle `obj` (tensors in their saved form) into the open file
    `f`. Under protocol 5 each tensor's bytes go to the file straight
    from its memory."""
    pickle.dump(_to_saveable(obj), f, protocol=protocol)


def _load(f, return_numpy=False):
    """Inverse of `_dump` on an open file."""
    return _from_saved(_Unpickler(f).load(), return_numpy=return_numpy)


def save(obj, path, protocol=4, **configs):
    """paddle.save: state dicts and nested containers of tensors.
    Atomic at every call site (tmp + fsync + os.replace)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    _atomic_write(path, lambda f: _dump(obj, f, protocol))


def load(path, return_numpy=False, **configs):
    """paddle.load: tensors come back on the CPU."""
    with open(path, "rb") as f:
        return _load(f, return_numpy=return_numpy)
