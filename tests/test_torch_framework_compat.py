"""Files saved by the port's `framework.save` load in the JAX package,
and the other way round.

The port writes every tensor numpy can hold in the JAX package's form
(a pickled `paddle_tpu.framework._SavedTensor` with state `{"array":
ndarray}`), so `paddle_tpu.framework.load` and `paddle_tpu.hapi.Model.load`
read it; a bf16 tensor stays in the port's raw form, which only the
port reads (numpy has no bf16 without `ml_dtypes`). Every comparison is
exact: a saved tensor comes back bit for bit.
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
    # the bf16 tensors are the port's raw form: one-way
    with open(tmp_path / "r.pd", "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["bf16"], framework._SavedTensor)
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
