"""`save` / `load`, the port of `paddle_tpu/framework.py` (:31-103).

    framework.save(model.state_dict(), "run/model.pdparams")
    state = framework.load("run/model.pdparams")     # CPU tensors

A checkpoint is a pickle of the nested dicts, lists and tuples it was
given; other leaves (numbers, strings, numpy arrays) are pickled as
they are. A torch tensor is stored in one of two forms:

- in the JAX package's form, which that package's `load` and
  `hapi.Model.load` read: a `paddle_tpu.framework._SavedTensor` whose
  state is `{"array": ndarray}`. Every tensor numpy can hold (f32,
  f16, the integers, bool) is written so;
- as this module's `_SavedTensor`: its dtype name, its shape and its
  raw bytes (a uint8 array). Only bf16 tensors are written so, since
  numpy knows no bf16 without the `ml_dtypes` package: a bf16 tensor
  round-trips bit for bit, but the JAX package cannot read it.

The JAX form names a class of the JAX package, and `pickle`'s own
`save_global` imports the module it names to check the class, which
would import `paddle_tpu` and JAX. `_Pickler`, a subclass of the
pure-Python pickler, writes that one global itself, so saving imports
nothing of `paddle_tpu`. It also writes the large buffers of protocol 5
from the arrays' memory, without the copy the pure-Python pickler makes.
`load` gives the tensors back on the CPU (`return_numpy=True`: numpy
arrays, which bf16 cannot be).

`save` is atomic (`_atomic_write`): the pickle goes into a tmp file in
the same directory, which is fsynced and then `os.replace`d over the
path, so a kill mid-write leaves the old file or the new one.

`load` reads all three kinds of file: the raw form, the JAX form this
module writes and the JAX form the JAX package writes. The unpickler
maps `paddle_tpu.framework._SavedTensor` to `_JaxSavedTensor`, so
nothing of `paddle_tpu` is imported. A bf16 array in a file of the JAX
package is pickled as numpy's `ml_dtypes.bfloat16`, and reading it
needs the `ml_dtypes` package: without it, `load` raises an error that
names it.
"""
from __future__ import annotations

import os
import pickle
import struct

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
    """The JAX package's `_SavedTensor`: a numpy array under `.array`.
    A file of that package unpickles its tensors into this class (their
    state, `{"array": ndarray}`, lands in `__dict__`), and `_Pickler`
    writes this class under the JAX package's name."""

    def __init__(self, array=None):
        self.array = array

    def tensor(self):
        arr = np.asarray(self.array)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(arr))


_JAX_CLASS = ("paddle_tpu.framework", "_SavedTensor")


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing `_JaxSavedTensor` as the global
    `paddle_tpu.framework._SavedTensor` without importing that module,
    and a large protocol-5 buffer straight from its memory."""

    def save_global(self, obj, name=None):
        if obj is not _JaxSavedTensor:
            return super().save_global(obj, name)
        module, qualname = _JAX_CLASS
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)

    def save_picklebuffer(self, obj):
        with obj.raw() as m:
            if not (m.contiguous and self._buffer_callback is None
                    and m.nbytes >= self.framer._FRAME_SIZE_TARGET):
                return super().save_picklebuffer(obj)
            # what the C pickler writes, from the buffer itself; not
            # memoized (nothing refers to it again)
            op = pickle.BINBYTES8 if m.readonly else pickle.BYTEARRAY8
            self._write_large_bytes(op + struct.pack("<Q", m.nbytes),
                                    m.cast("B"))

    dispatch = dict(pickle._Pickler.dispatch)
    dispatch[pickle.PickleBuffer] = save_picklebuffer


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


def _saved(t):
    """The saved form of a tensor: the JAX package's unless numpy cannot
    hold its dtype (bf16)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        try:
            return _JaxSavedTensor(t.contiguous().numpy())
        except TypeError:
            pass
    return _SavedTensor.of(t)


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return _saved(obj)
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
    _Pickler(f, protocol=protocol).dump(_to_saveable(obj))


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
