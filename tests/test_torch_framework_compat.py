"""Files saved by the port's `framework.save` load in the JAX package,
and the other way round.

The port writes every tensor in the JAX package's form (a pickled
`paddle_tpu.framework._SavedTensor` with state `{"array": ndarray}`), so
`paddle_tpu.framework.load` and `paddle_tpu.hapi.Model.load` read it; a
bf16 tensor is written as numpy pickles an `ml_dtypes.bfloat16` array,
without the port importing `ml_dtypes`, and a JAX-written bf16 array
reads in the port with `ml_dtypes` absent. Every comparison is exact: a
saved tensor comes back bit for bit.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.framework as jframework
import paddle_tpu.optimizer as joptim
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.text.models import bert as jbert

import paddle_tpu_torch.optimizer as poptim
from paddle_tpu_torch import framework
from paddle_tpu_torch.hapi import Model as PModel
from paddle_tpu_torch.text.models import bert as pbert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           ffn_hidden=64, max_seq_len=16, dropout=0.0)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 5, generator=g),
            "big": torch.randn(1 << 17, generator=g),
            "ids": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
            "i32": torch.tensor([7, -1], dtype=torch.int32),
            "scalar": torch.tensor(2.5),
            "nested": [torch.ones(2), (torch.zeros(1, dtype=torch.int64),)],
            "step": 4, "name": "run"}


def test_port_file_loads_in_the_jax_package(tmp_path):
    """f32 and int64 tensors, a large one (the no-copy buffer path), a
    0-d one and nested containers, through `paddle_tpu.framework.load`
    as tensors and as numpy."""
    sd = _state()
    path = str(tmp_path / "a.pdparams")
    framework.save(sd, path)
    got = jframework.load(path, return_numpy=True)
    for k in ("w", "big", "ids", "i32", "scalar"):
        assert got[k].dtype == sd[k].numpy().dtype, k
        np.testing.assert_array_equal(got[k], sd[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got["nested"][0], np.ones(2, np.float32))
    assert got["nested"][1][0].dtype == np.int64
    assert got["step"] == 4 and got["name"] == "run"
    tensors = jframework.load(path)
    assert isinstance(tensors["w"], paddle.Tensor)
    np.testing.assert_array_equal(np.asarray(tensors["w"]._value),
                                  sd["w"].numpy())


def test_checkpoint_writer_file_loads_in_the_jax_package(tmp_path):
    """`framework._dump` (protocol 5, the elastic writer's) writes the
    same global, and the buffers of its arrays straight from memory."""
    sd = _state(1)
    path = str(tmp_path / "b.pd")
    with open(path, "wb") as f:
        framework._dump(sd, f)
    got = jframework.load(path, return_numpy=True)
    for k in ("w", "big", "ids"):
        np.testing.assert_array_equal(got[k], sd[k].numpy(), err_msg=k)
    with open(path, "rb") as f:
        mine = framework._load(f)
    for k in ("w", "big", "ids", "scalar"):
        assert torch.equal(mine[k], sd[k]) and mine[k].dtype == sd[k].dtype


class _Pair:
    """The same small BERT in both packages, each inside a hapi Model."""

    def __init__(self):
        paddle.seed(0)
        self.jnet = jbert.BertForPretraining(jbert.BertConfig(**CFG))
        self.pnet = pbert.BertForPretraining(pbert.BertConfig(**CFG),
                                             device="cpu",
                                             generator=torch.Generator(
                                                 ).manual_seed(5))
        self.jm = JModel(self.jnet).prepare(joptim.AdamW(
            1e-3, parameters=self.jnet.parameters()))
        self.pm = PModel(self.pnet).prepare(poptim.AdamW(
            1e-3, parameters=self.pnet.parameters()))


def test_port_model_save_loads_through_jax_model_load(tmp_path):
    """`Model.save` in the port, `Model.load` in the JAX package: every
    parameter lands bit for bit in the JAX model of the same
    structure."""
    pair = _Pair()
    pair.pm.save(str(tmp_path / "p"))
    pair.jm.load(str(tmp_path / "p"), reset_optimizer=True)
    jsd = {k: np.asarray(v._value) for k, v in pair.jnet.state_dict().items()}
    names = [n for n, _ in pair.pnet.named_parameters()]
    assert set(names) <= set(jsd)
    for n, p in pair.pnet.named_parameters():
        np.testing.assert_array_equal(jsd[n], p.detach().numpy(), err_msg=n)
    # the optimizer's file reads in the JAX package too
    opt = jframework.load(str(tmp_path / "p") + ".pdopt", return_numpy=True)
    assert opt["@step"] == 0


def test_jax_save_loads_in_the_port_and_port_round_trip_is_exact(tmp_path):
    """The other direction (JAX `save`, port `load`) and the port's own
    round trip, bf16 included, bit for bit."""
    arrays = {"w": np.random.RandomState(0).randn(4, 3).astype(np.float32),
              "ids": np.arange(6, dtype=np.int32)}
    jframework.save({k: paddle.to_tensor(v) for k, v in arrays.items()},
                    str(tmp_path / "j.pd"))
    got = framework.load(str(tmp_path / "j.pd"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    sd = _state(2)
    sd["bf16"] = torch.randn(7, 3).to(torch.bfloat16)
    sd["bf16_0d"] = torch.tensor(-0.0, dtype=torch.bfloat16)
    framework.save(sd, str(tmp_path / "r.pd"))
    back = framework.load(str(tmp_path / "r.pd"))
    for k in ("w", "big", "ids", "i32", "scalar", "bf16", "bf16_0d"):
        assert back[k].dtype == sd[k].dtype, k
        assert torch.equal(back[k].view(torch.int16) if k.startswith("bf16")
                           else back[k],
                           sd[k].view(torch.int16) if k.startswith("bf16")
                           else sd[k]), k
    # every tensor, bf16 too, is in the JAX package's form
    with open(tmp_path / "r.pd", "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["bf16"], jframework._SavedTensor)
    assert raw["bf16"].array.dtype.name == "bfloat16"
    assert isinstance(raw["w"], jframework._SavedTensor)


def test_saving_imports_nothing_of_the_jax_package(tmp_path):
    """In a fresh interpreter, `framework.save` and `_dump` write the
    JAX form without importing `paddle_tpu` or `jax`."""
    code = (
        "import sys, torch\n"
        "from paddle_tpu_torch import framework\n"
        f"framework.save({{'w': torch.ones(3)}}, {str(tmp_path / 'x.pd')!r})\n"
        f"with open({str(tmp_path / 'y.pd')!r}, 'wb') as f:\n"
        "    framework._dump({'w': torch.ones(1 << 17)}, f)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('paddle_tpu', 'jax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in ("x.pd", "y.pd"):
        data = (tmp_path / name).read_bytes()
        assert b"paddle_tpu.framework" in data and b"_SavedTensor" in data


def _bf16_arrays():
    """bf16 arrays with every kind of bit pattern: values, -0.0, inf,
    NaN, subnormals; a 0-d one, an empty one and a large one."""
    rng = np.random.RandomState(3)
    bits = rng.randint(-32768, 32767, size=(6, 5)).astype(np.int16)
    bits[0, :4] = [-32768, 0x7F80, 0x7FC1, 0x0001]   # -0, inf, NaN, subnormal
    return {"w": bits, "0d": np.array(0x3FC0, np.int16),
            "empty": np.zeros((0, 4), np.int16),
            "big": rng.randint(-32768, 32767, size=1 << 17).astype(np.int16)}


def test_jax_saved_bf16_loads_in_the_port_without_ml_dtypes(tmp_path):
    """A bf16 state saved by the JAX package (an O2 BERT's parameters
    and loose bf16 arrays) reads in the port bit for bit, in a fresh
    interpreter where `ml_dtypes` cannot be imported."""
    import ml_dtypes

    arrays = {k: v.view(ml_dtypes.bfloat16) for k, v in _bf16_arrays().items()}
    paddle.seed(0)
    from paddle_tpu import amp as jamp

    jnet = jamp.decorate(jbert.BertForPretraining(jbert.BertConfig(**CFG)),
                         level="O2", dtype="bfloat16")
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    assert any(v.dtype == ml_dtypes.bfloat16 for v in state.values())
    jframework.save({"arrays": {k: paddle.to_tensor(v)
                                for k, v in arrays.items()},
                     "model": jnet.state_dict(), "step": 3},
                    str(tmp_path / "j.pd"))
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from paddle_tpu_torch import framework\n"
        f"got = framework.load({str(tmp_path / 'j.pd')!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('paddle_tpu', 'jax', 'ml_dtypes') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "out = {}\n"
        "for group in ('arrays', 'model'):\n"
        "    for k, t in got[group].items():\n"
        "        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 "
        "else t\n"
        "        out[group + '/' + k] = bits.numpy()\n"
        "        out[group + '/' + k + '/dtype'] = np.array(str(t.dtype))\n"
        "assert got['step'] == 3\n"
        f"np.savez({str(tmp_path / 'bits.npz')!r}, **out)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    bits = np.load(tmp_path / "bits.npz")
    for k, v in arrays.items():
        assert str(bits[f"arrays/{k}/dtype"]) == "torch.bfloat16", k
        np.testing.assert_array_equal(bits[f"arrays/{k}"], v.view(np.int16),
                                      err_msg=k)
    for k, v in state.items():
        if v.dtype == ml_dtypes.bfloat16:
            assert str(bits[f"model/{k}/dtype"]) == "torch.bfloat16", k
            v = v.view(np.int16)
        np.testing.assert_array_equal(bits[f"model/{k}"], v, err_msg=k)


def test_port_saved_bf16_loads_in_the_jax_package(tmp_path):
    """bf16 tensors the port saves (`save` and the checkpoint writer's
    `_dump`, contiguous and transposed) read in the JAX package as
    `ml_dtypes.bfloat16` arrays, bit for bit, as numpy and as tensors;
    an O2 BERT saved by the port's `Model.save` loads through the JAX
    `Model.load` into the JAX O2 BERT."""
    import ml_dtypes

    sd = {k: torch.from_numpy(v).view(torch.bfloat16)
          for k, v in _bf16_arrays().items()}
    sd["t"] = sd["w"].t()
    framework.save(sd, str(tmp_path / "s.pd"))
    with open(tmp_path / "d.pd", "wb") as f:
        framework._dump(sd, f)
    for name in ("s.pd", "d.pd"):
        path = str(tmp_path / name)
        got = jframework.load(path, return_numpy=True)
        for k, t in sd.items():
            assert got[k].dtype == ml_dtypes.bfloat16, (name, k)
            np.testing.assert_array_equal(
                got[k].view(np.int16),
                t.contiguous().view(torch.int16).numpy(), err_msg=k)
        tensors = jframework.load(path)
        np.testing.assert_array_equal(
            np.asarray(tensors["w"]._value).view(np.int16),
            sd["w"].view(torch.int16).numpy())
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as pamp

    pair = _Pair()
    pamp.decorate(pair.pnet, level="O2", dtype="bfloat16")
    jamp.decorate(pair.jnet, level="O2", dtype="bfloat16")
    pair.pm.save(str(tmp_path / "p"))
    pair.jm.load(str(tmp_path / "p"), reset_optimizer=True)
    jsd = {k: np.asarray(v._value) for k, v in pair.jnet.state_dict().items()}
    n_bf16 = 0
    for n, p in pair.pnet.named_parameters():
        if p.dtype == torch.bfloat16:
            n_bf16 += 1
            assert jsd[n].dtype == ml_dtypes.bfloat16, n
            np.testing.assert_array_equal(
                jsd[n].view(np.int16),
                p.detach().view(torch.int16).numpy(), err_msg=n)
        else:
            np.testing.assert_array_equal(jsd[n], p.detach().numpy(),
                                          err_msg=n)
    assert n_bf16 > 0


def test_saving_bf16_imports_neither_the_jax_package_nor_ml_dtypes(tmp_path):
    """In a fresh interpreter, saving bf16 tensors (`save` and `_dump`)
    imports nothing of `paddle_tpu`, `jax` or `ml_dtypes`, and the
    file names `ml_dtypes bfloat16` for the JAX package to read."""
    code = (
        "import sys, torch\n"
        "from paddle_tpu_torch import framework\n"
        "sd = {'h': torch.randn(3, 2).bfloat16(), "
        "'big': torch.randn(1 << 17).bfloat16(), 'w': torch.ones(2)}\n"
        f"framework.save(sd, {str(tmp_path / 'x.pd')!r})\n"
        f"with open({str(tmp_path / 'y.pd')!r}, 'wb') as f:\n"
        "    framework._dump(sd, f)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('paddle_tpu', 'jax', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in ("x.pd", "y.pd"):
        data = (tmp_path / name).read_bytes()
        assert b"ml_dtypes" in data and b"bfloat16" in data
        assert b"paddle_tpu.framework" in data
