"""`save` / `load`, the port of `paddle_tpu/framework.py` (:31-103).

    framework.save(model.state_dict(), "run/model.pdparams")
    state = framework.load("run/model.pdparams")     # CPU tensors

A checkpoint is a pickle of the nested dicts, lists and tuples it was
given; other leaves (numbers, strings, numpy arrays) are pickled as
they are. Every torch tensor is stored in the JAX package's form, which
that package's `load` and `hapi.Model.load` read: a
`paddle_tpu.framework._SavedTensor` whose state is `{"array":
ndarray}`. A bf16 tensor is written as numpy pickles an ndarray of
`ml_dtypes.bfloat16` (`_Bf16Array`): the array's reconstructor, then
its state, whose dtype is `numpy.dtype(ml_dtypes.bfloat16)` and whose
data is the tensor's raw 2-byte values. Numpy knows no bf16 without
`ml_dtypes`, so the port writes those opcodes itself and imports
neither numpy's bf16 nor `ml_dtypes`.

The JAX form names classes that the saving process must not import
(`paddle_tpu`, and so JAX; `ml_dtypes`), and `pickle`'s own
`save_global` imports the module it names to check the class.
`_Pickler`, a subclass of the pure-Python pickler, writes those globals
by name (`_Global`), so saving imports nothing of `paddle_tpu`. It also
writes the large buffers of protocol 5 from the tensors' memory,
without the copy the pure-Python pickler makes.

`save` is atomic (`_atomic_write`): the pickle goes into a tmp file in
the same directory, which is fsynced and then `os.replace`d over the
path, so a kill mid-write leaves the old file or the new one.

`load` reads the JAX form, whichever package wrote it, and the raw form
(`_SavedTensor`: dtype name, shape, raw bytes) that the port wrote for
bf16 before. The unpickler (`_Unpickler`) maps
`paddle_tpu.framework._SavedTensor` to `_JaxSavedTensor`,
`ml_dtypes.bfloat16` to a stand-in, and numpy's array reconstructor to
`_PickledArray`, which builds the ndarray, or, for the stand-in dtype, a
`torch.bfloat16` tensor from the raw values: nothing of `paddle_tpu` or
`ml_dtypes` is imported, and a bf16 array comes back bit for bit.
`load` gives the tensors back on the CPU (`return_numpy=True`: numpy
arrays, which bf16 cannot be).

`set_default_dtype` / `get_default_dtype` (:23-28) write and read the
`default_dtype` flag (`core.flags`), the float dtype of creation and
random ops given none.
"""
from __future__ import annotations

import os
import pickle
import struct

import numpy as np
import torch

__all__ = ["save", "load", "set_default_dtype", "get_default_dtype"]


class _SavedTensor:
    """The port's earlier form of a bf16 tensor on disk: dtype name,
    shape, raw bytes (a uint8 array). Read, no longer written."""

    __slots__ = ("dtype", "shape", "data")

    def __init__(self, dtype, shape, data):
        self.dtype = dtype
        self.shape = tuple(shape)
        self.data = data

    def tensor(self):
        dtype = getattr(torch, self.dtype)
        if not len(self.data):
            return torch.empty(self.shape, dtype=dtype)
        raw = torch.from_numpy(np.array(_value(self.data), dtype=np.uint8))
        return raw.view(dtype).reshape(self.shape)


class _JaxSavedTensor:
    """The JAX package's `_SavedTensor`: a numpy array under `.array`.
    A file of that package unpickles its tensors into this class (their
    state, `{"array": ndarray}`, lands in `__dict__`), and `_Pickler`
    writes this class under the JAX package's name."""

    def __init__(self, array=None):
        self.array = array

    def tensor(self):
        arr = _value(self.array)
        if isinstance(arr, torch.Tensor):
            return arr
        return torch.from_numpy(np.array(arr))


_JAX_CLASS = ("paddle_tpu.framework", "_SavedTensor")
# numpy's own state of `numpy.dtype(ml_dtypes.bfloat16)`: (version, byte
# order, subarray, names, fields, item size, alignment, flags)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Global:
    """A module-level name (`module.name`) that `_Pickler` writes as a
    pickle global without importing its module. Callable only so that
    the pickler takes it as a reconstructor."""

    __slots__ = ("module", "name")

    def __init__(self, module, name):
        self.module = module
        self.name = name

    def __call__(self, *args):
        raise TypeError(f"{self.module}.{self.name} is written by name, "
                        "not called")


class _Bf16Dtype:
    """`numpy.dtype(ml_dtypes.bfloat16)`, as numpy pickles it."""

    def __reduce__(self):
        return (_Global("numpy", "dtype"),
                (_Global("ml_dtypes", "bfloat16"), False, True),
                _BF16_DTYPE_STATE)


class _Bf16Array:
    """A bf16 tensor pickled as numpy pickles an ndarray of
    `ml_dtypes.bfloat16`: `_reconstruct(ndarray, (0,), b"b")`, then the
    state (1, shape, dtype, False, raw bytes). Under protocol 5 the
    bytes go out from the tensor's memory."""

    def __init__(self, t):
        self.t = t.contiguous()

    def __reduce_ex__(self, protocol):
        raw = self.t.reshape(-1).view(torch.uint8).numpy()
        data = (pickle.PickleBuffer(memoryview(raw).toreadonly())
                if protocol >= 5 else raw.tobytes())
        rebuild = np.ndarray.__reduce__(np.zeros(1))[0]
        return (_Global(rebuild.__module__, rebuild.__name__),
                (_Global("numpy", "ndarray"), (0,), b"b"),
                (1, tuple(self.t.shape), _Bf16Dtype(), False, data))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing `_JaxSavedTensor` as the global
    `paddle_tpu.framework._SavedTensor` and every `_Global` by its name,
    without importing their modules, and a large protocol-5 buffer
    straight from its memory."""

    def _write_global(self, obj, module, qualname):
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)

    def save_global(self, obj, name=None):
        if obj is not _JaxSavedTensor:
            return super().save_global(obj, name)
        self._write_global(obj, *_JAX_CLASS)

    def save_named(self, obj):
        self._write_global(obj, obj.module, obj.name)

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
    dispatch[_Global] = save_named


class _Bf16:
    """Stands for `ml_dtypes.bfloat16` in a file being read."""


class _Bf16DtypeRead:
    """`numpy.dtype(ml_dtypes.bfloat16)` in a file being read; numpy's
    dtype state it is given (`_BF16_DTYPE_STATE`) says nothing the raw
    values need."""

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=False):
    """`numpy.dtype` for the unpickler: the stand-in for bf16."""
    if obj is _Bf16:
        return _Bf16DtypeRead()
    return np.dtype(obj, align, copy)


class _PickledArray:
    """An ndarray as the unpickler rebuilds it (numpy's `_reconstruct`,
    then its state). `value` is the ndarray, or for a bf16 array a
    `torch.bfloat16` tensor of its raw values."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        if len(state) == 5:
            state = state[1:]
        shape, dtype, fortran, raw = state
        if not isinstance(dtype, _Bf16DtypeRead):
            arr = np.ndarray((0,), "b")
            arr.__setstate__(state)
            self.value = arr
            return
        bits = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
        if fortran:
            t = bits.reshape(tuple(reversed(shape))).permute(
                *reversed(range(len(shape)))).contiguous()
        else:
            t = bits.reshape(tuple(shape))
        self.value = t.view(torch.bfloat16)


def _value(obj):
    return obj.value if isinstance(obj, _PickledArray) else obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_CLASS:
            return _JaxSavedTensor
        if module.split(".")[0] == "ml_dtypes":
            if name != "bfloat16":
                raise pickle.UnpicklingError(
                    f"this checkpoint holds a numpy {name} array; of the "
                    "ml_dtypes types only bfloat16 is read")
            return _Bf16
        if module == "numpy" and name == "dtype":
            return _dtype
        if (module in ("numpy.core.multiarray", "numpy._core.multiarray")
                and name == "_reconstruct"):
            return _PickledArray
        return super().find_class(module, name)


def _saved(t):
    """The saved form of a tensor, the JAX package's."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _JaxSavedTensor(_Bf16Array(t))
    return _JaxSavedTensor(t.contiguous().numpy())


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return _saved(obj)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj, return_numpy=False):
    if isinstance(obj, _PickledArray):
        if isinstance(obj.value, np.ndarray):
            return obj.value
        obj = _JaxSavedTensor(obj)   # a bare bf16 array
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


def set_default_dtype(d):
    """The float dtype creation and random ops take when given none
    (paddle.set_default_dtype; the `default_dtype` flag)."""
    from .core import flags
    from .core.dtype import dtype_name

    flags.set_flags({"default_dtype": dtype_name(d)})


def get_default_dtype():
    from .core import flags

    return flags.get_flag("default_dtype")
