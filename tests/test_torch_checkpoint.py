"""The port's checkpoint store: `framework.save` / `load` and the elastic
`CheckpointManager` (`paddle_tpu_torch.incubate.checkpoint.elastic`),
on the CPU, against the JAX package where both write the same thing.

Everything here is exact: a saved tensor must come back bit for bit
(dtype, shape and bytes), a JAX-written f32 `.pdparams` / `.pdopt` must
load to the same values, and a restored snapshot must equal the state
at its capture, whatever the caller did to its tensors afterwards.
"""
import json
import os
import pickle
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.incubate.checkpoint import (CheckpointManager,
                                                  auto_checkpoint)
from paddle_tpu_torch.incubate.checkpoint import elastic


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(5, 3, generator=g),
            "bf16": torch.randn(4, 7, generator=g).bfloat16(),
            "scalar": torch.tensor(2.5),
            "ints": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "mask": torch.tensor([True, False, True]),
            "empty": torch.zeros(0, 3),
            "strided": torch.randn(6, 4, generator=g).t(),
            "nested": [torch.ones(2, dtype=torch.float16),
                       ({"k": np.arange(3.0)}, 7, "s")]}


def _assert_same(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(-1).view(torch.uint8)
                           if got.numel() else got,
                           want.contiguous().view(-1).view(torch.uint8)
                           if want.numel() else want)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got == want


# -- framework.save / load ------------------------------------------------
def test_save_load_round_trips_every_dtype_bit_for_bit(tmp_path):
    tree = _tree()
    framework.save(tree, str(tmp_path / "a" / "t.pdparams"))
    _assert_same(framework.load(str(tmp_path / "a" / "t.pdparams")), tree)
    assert os.listdir(tmp_path / "a") == ["t.pdparams"]
    npy = framework.load(str(tmp_path / "a" / "t.pdparams"),
                         return_numpy=False)["w"]
    assert torch.equal(npy, tree["w"])
    framework.save({"w": tree["w"]}, str(tmp_path / "w.pd"))
    np.testing.assert_array_equal(
        framework.load(str(tmp_path / "w.pd"), return_numpy=True)["w"],
        tree["w"].numpy())
    with pytest.raises(TypeError, match="bfloat16"):
        framework.load(str(tmp_path / "a" / "t.pdparams"), return_numpy=True)


def test_save_is_atomic_a_failed_write_keeps_the_old_file(tmp_path):
    path = str(tmp_path / "m.pdparams")
    framework.save({"w": torch.ones(3)}, path)

    class Boom:
        def __reduce__(self):
            raise RuntimeError("mid-write failure")

    with pytest.raises(RuntimeError, match="mid-write"):
        framework.save({"w": torch.zeros(1 << 16), "x": Boom()}, path)
    assert torch.equal(framework.load(path)["w"], torch.ones(3))
    assert os.listdir(tmp_path) == ["m.pdparams"]   # no tmp left behind


def test_jax_written_pdparams_and_pdopt_load(tmp_path):
    paddle.seed(1)
    net = jnn.Linear(4, 3)
    opt = joptim.Adam(learning_rate=0.1, parameters=net.parameters())
    loss = paddle.mean(net(paddle.to_tensor(
        np.ones((2, 4), np.float32))) ** 2)
    loss.backward()
    opt.step()
    paddle.save(net.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    ids_j = paddle.to_tensor(np.arange(5, dtype=np.int64))
    paddle.save({"ids": ids_j}, str(tmp_path / "i.pd"))
    got = framework.load(str(tmp_path / "m.pdparams"))
    for k, v in net.state_dict().items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v._value))
    gopt = framework.load(str(tmp_path / "m.pdopt"))
    want = opt.state_dict()
    assert set(gopt) == set(want)
    for k, v in want.items():
        if hasattr(v, "_value"):
            np.testing.assert_array_equal(gopt[k].numpy(),
                                          np.asarray(v._value))
    ids = framework.load(str(tmp_path / "i.pd"))["ids"]
    # the integer dtype JAX stored (int32 unless jax_enable_x64)
    assert str(ids.dtype) == f"torch.{np.asarray(ids_j._value).dtype}"
    assert ids.tolist() == [0, 1, 2, 3, 4]


def test_jax_written_bf16_needs_ml_dtypes(tmp_path):
    """The JAX package writes a bf16 array as an ndarray of
    `ml_dtypes.bfloat16`, by name: its file needs `ml_dtypes` to be read
    as numpy reads it. The port reads it bit for bit."""
    arr = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    paddle.save({"w": paddle.to_tensor(arr).astype("bfloat16")},
                str(tmp_path / "b.pd"))
    with open(tmp_path / "b.pd", "rb") as f:
        assert b"ml_dtypes" in f.read()
    got = framework.load(str(tmp_path / "b.pd"))["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(arr).bfloat16())


def test_jax_written_bf16_loads_without_ml_dtypes(tmp_path, monkeypatch):
    """The same file reads bit for bit with `ml_dtypes` not importable:
    the port maps the dtype's name to raw 2-byte storage."""
    arr = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    paddle.save({"w": paddle.to_tensor(arr).astype("bfloat16")},
                str(tmp_path / "b.pd"))
    got = framework.load(str(tmp_path / "b.pd"))["w"]
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # not installed
    again = framework.load(str(tmp_path / "b.pd"))["w"]
    assert again.dtype == torch.bfloat16
    assert torch.equal(again.view(torch.int16), got.view(torch.int16))


# -- CheckpointManager ----------------------------------------------------
def _mgr(tmp_path, **kw):
    kw.setdefault("async_write", False)
    return CheckpointManager(dir=str(tmp_path / "ck"), device="cpu", **kw)


def test_manager_round_trip_and_cursor(tmp_path):
    m = _mgr(tmp_path)
    tree = _tree()
    m.save(tree, epoch=1, step_in_epoch=3, global_step=9)
    d = tmp_path / "ck" / "step_9"
    assert sorted(os.listdir(d)) == ["manifest.json", "state_rank0.pd"]
    meta = json.loads((d / "manifest.json").read_text())
    assert meta["complete"] and meta["step"] == 9 and meta["world_size"] == 1
    r = _mgr(tmp_path)
    _assert_same(r.restore(), tree)
    assert r.cursor == {"epoch": 1, "step_in_epoch": 3, "global_step": 9}
    assert r.global_step == 9
    assert _mgr(tmp_path / "empty").restore() is None


def test_manager_defaults_to_the_card_and_the_edl_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_JOB_ID", "job7")
    assert elastic.default_checkpoint_dir() == str(
        tmp_path / "job7" / "train_state")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CheckpointManager()
    assert CheckpointManager(device="cpu").dir == str(
        tmp_path / "job7" / "train_state")


def test_manager_rotation_keeps_the_newest(tmp_path):
    m = _mgr(tmp_path, max_num=2)
    for g in (4, 8, 12):
        m.save({"g": torch.tensor(g)}, global_step=g)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_12", "step_8"]
    assert _mgr(tmp_path).restore()["g"].item() == 12


@pytest.mark.parametrize("tear", ["truncated", "no_manifest",
                                  "bad_manifest", "missing_rank"])
def test_manager_restore_falls_back_past_a_torn_snapshot(tmp_path, tear):
    m = _mgr(tmp_path, max_num=3)
    for g in (4, 8):
        m.save({"g": torch.full((1000,), float(g))}, global_step=g)
    d = tmp_path / "ck" / "step_8"
    if tear == "truncated":
        data = (d / "state_rank0.pd").read_bytes()
        (d / "state_rank0.pd").write_bytes(data[:len(data) // 2])
    elif tear == "no_manifest":
        os.remove(d / "manifest.json")
    elif tear == "bad_manifest":
        (d / "manifest.json").write_text("{not json")
    else:
        meta = json.loads((d / "manifest.json").read_text())
        (d / "manifest.json").write_text(json.dumps(dict(meta,
                                                         world_size=2)))
    r = _mgr(tmp_path)
    assert r.restore()["g"][0].item() == 4.0
    assert r.cursor["global_step"] == 4


def test_manager_reads_its_own_rank_file(tmp_path):
    m = _mgr(tmp_path)
    m.world_size = 2
    for rank in (1, 0):        # rank 0 writes the manifest last
        m.rank = rank
        m.save({"r": torch.tensor(rank)}, global_step=2)
    r = _mgr(tmp_path)
    r.rank = 1
    assert r.restore()["r"].item() == 1
    r.rank = 0
    assert r.restore()["r"].item() == 0


def test_async_writer_latest_wins(tmp_path):
    m = _mgr(tmp_path, async_write=True, max_num=5)
    dropped = monitor.stat_get("ckpt/dropped")
    m._write_lock.acquire()          # the writer stalls on a slow disk
    try:
        m.save({"g": torch.tensor(1)}, global_step=1)
        deadline = time.monotonic() + 10
        while not m._busy and time.monotonic() < deadline:
            time.sleep(0.01)         # step 1 is with the writer
        assert m._busy
        m.save({"g": torch.tensor(2)}, global_step=2)
        m.save({"g": torch.tensor(3)}, global_step=3)   # drops step 2
        assert monitor.stat_get("ckpt/dropped") == dropped + 1
        assert m.last_captured_step() == 3
    finally:
        m._write_lock.release()
    assert m.flush(10)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1", "step_3"]
    assert _mgr(tmp_path).restore()["g"].item() == 3
    assert m.close()
    assert m._writer is None


def test_capture_is_not_torn_by_the_next_in_place_step(tmp_path):
    """save() copies before it returns: an in-place update after it (the
    next step's optimizer) must not reach the snapshot the writer is
    still to write."""
    m = _mgr(tmp_path, async_write=True)
    w = torch.zeros(4096)
    slots = {"m": torch.zeros(4096)}
    m._write_lock.acquire()
    try:
        m.save({"w": w, "slots": slots}, global_step=1)
        w.add_(1.0)                   # step 2 runs while step 1 is queued
        slots["m"].fill_(7.0)
    finally:
        m._write_lock.release()
    assert m.flush(10)
    state = _mgr(tmp_path).restore()
    assert torch.equal(state["w"], torch.zeros(4096))
    assert torch.equal(state["slots"]["m"], torch.zeros(4096))
    m.close()


def test_host_buffers_are_reused_once_written(tmp_path):
    m = _mgr(tmp_path)
    ptrs = []
    for g in (1, 2, 3):
        m.save({"w": torch.full((64,), float(g))}, global_step=g)
        ptrs.append(m._last.bufs[0].data_ptr())
    # each capture supersedes the one before, whose buffer is written and
    # goes back to the pool: one buffer serves every save
    assert ptrs[1] == ptrs[0] and ptrs[2] == ptrs[0]
    # with the writer busy on one snapshot, a second set serves the rest
    a = _mgr(tmp_path / "a", async_write=True)
    a._write_lock.acquire()
    try:
        a.save({"w": torch.full((64,), 1.0)}, global_step=1)
        deadline = time.monotonic() + 10
        while not a._busy and time.monotonic() < deadline:
            time.sleep(0.01)         # step 1 is with the writer
        assert a._busy
        held = set()
        for g in (2, 3, 4):
            a.save({"w": torch.full((64,), float(g))}, global_step=g)
            held.add(a._pending.bufs[0].data_ptr())
    finally:
        a._write_lock.release()
    a.close()
    assert len(held) == 1
    assert len(a._pool._free[((64,), torch.float32)]) == 2
    assert _mgr(tmp_path).restore()["w"][0].item() == 3.0


def test_emergency_save_provider_and_fallback(tmp_path):
    m = _mgr(tmp_path, async_write=True)
    before = monitor.stat_get("ckpt/emergency_saves")
    m.set_state_provider(lambda: ({"g": torch.tensor(5)},
                                  {"epoch": 0, "step_in_epoch": 5,
                                   "global_step": 5}))
    assert m.emergency_save("test") == 5
    meta = json.loads((tmp_path / "ck" / "step_5" / "manifest.json")
                      .read_text())
    assert meta["reason"] == "test"
    # no provider: the newest capture if it is not on disk yet
    m.set_state_provider(None)
    assert m.emergency_save("test") is None     # nothing newer than 5
    m._write_lock.acquire()
    m.save({"g": torch.tensor(6)}, global_step=6)
    m._write_lock.release()
    m.flush(10)
    assert m.emergency_save("test") is None     # 6 is durable
    assert monitor.stat_get("ckpt/emergency_saves") == before + 1
    m.close()


def test_preemption_handler_install_and_uninstall(tmp_path):
    m = _mgr(tmp_path)
    prev = signal.getsignal(signal.SIGTERM)
    seen = []
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        chained = signal.getsignal(signal.SIGTERM)
        assert m.install_preemption_handler()
        assert signal.getsignal(signal.SIGTERM) == m._on_preempt_signal
        assert m.install_preemption_handler()          # idempotent
        m._preempt_grace_s = 0.2
        m.set_state_provider(lambda: ({"g": torch.tensor(3)},
                                      {"global_step": 3}))
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not m.preempted.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert m.preempted.is_set() and seen == [signal.SIGTERM]
        m._preempt_thread.join(10)   # no boundary save: the provider's
        assert (tmp_path / "ck" / "step_3" / "manifest.json").exists()
        assert m.due(7)              # a preempted manager saves now
        m.uninstall_preemption_handler()
        assert signal.getsignal(signal.SIGTERM) == chained
        m.arm()                      # re-armed: the latch is cleared
        assert not m.preempted.is_set()
        m.close()
        assert signal.getsignal(signal.SIGTERM) == chained
        t = threading.Thread(target=lambda: seen.append(
            m.install_preemption_handler()))
        t.start()
        t.join(10)
        assert seen[-1] is False     # main thread only
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_cadence_and_maybe_save(tmp_path):
    m = _mgr(tmp_path, save_steps=4)
    assert [g for g in range(1, 13) if m.due(g)] == [4, 8, 12]
    calls = []
    assert not m.maybe_save(lambda: calls.append(1), global_step=3)
    assert m.maybe_save(lambda: {"g": torch.tensor(4)}, global_step=4)
    assert calls == [] and m.last_captured_step() == 4
    t = _mgr(tmp_path / "t", save_interval_s=3600)
    assert not t.due(1)
    t._last_save_t -= 7200
    assert t.due(1)


def test_auto_checkpoint_epoch_range_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_JOB_ID", "ac")

    class Obj:
        def __init__(self):
            self.v = torch.zeros(3)

        def state_dict(self):
            return {"v": self.v}

        def set_state_dict(self, sd):
            self.v = sd["v"].clone()

    auto_checkpoint.clear_registry()
    try:
        a = auto_checkpoint.register("a", Obj())
        seen = []
        for epoch in auto_checkpoint.train_epoch_range(5):
            a.v += 1
            seen.append(epoch)
            if epoch == 2:
                break            # killed during epoch 3: epochs 0-1 saved
        assert seen == [0, 1, 2]
        auto_checkpoint.clear_registry()
        b = auto_checkpoint.register("a", Obj())
        rest = []
        for epoch in auto_checkpoint.train_epoch_range(5):
            b.v += 1
            rest.append(epoch)
        assert rest == [2, 3, 4]
        assert b.v.tolist() == [5.0] * 3     # 2 restored, then 3 epochs
        assert auto_checkpoint.load_checkpoint() == 4
        snaps = sorted(os.listdir(tmp_path / "ac" / "default_range"))
        assert snaps == ["epoch_3", "epoch_4"]        # rotated to 2
    finally:
        auto_checkpoint.clear_registry()
    monkeypatch.delenv("PADDLE_CHECKPOINT_DIR")
    assert list(auto_checkpoint.train_epoch_range(3)) == [0, 1, 2]


def test_snapshot_pickle_reads_back_with_plain_pickle_tags(tmp_path):
    """The rank file is a pickle of {"schema", "state"} whose tensors are
    saved tensors: an f32 one in the JAX package's form (its
    `_SavedTensor`, the array under `.array`), a bf16 one too, as an
    `ml_dtypes.bfloat16` array; readable by `framework.load` too."""
    import paddle_tpu.framework as jframework

    m = _mgr(tmp_path)
    h = torch.arange(3.0).to(torch.bfloat16)
    m.save({"w": torch.arange(3.0), "h": h}, global_step=1)
    path = str(tmp_path / "ck" / "step_1" / "state_rank0.pd")
    got = framework.load(path)
    assert got["schema"] == elastic.SCHEMA
    assert torch.equal(got["state"]["w"], torch.arange(3.0))
    assert torch.equal(got["state"]["h"], h)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["state"]["w"], jframework._SavedTensor)
    np.testing.assert_array_equal(raw["state"]["w"].array,
                                  np.arange(3.0, dtype=np.float32))
    assert isinstance(raw["state"]["h"], jframework._SavedTensor)
    np.testing.assert_array_equal(
        raw["state"]["h"].array.view(np.int16),
        h.view(torch.int16).numpy())
