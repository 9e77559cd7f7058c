"""The port's memory plane (`paddle_tpu_torch.monitor.memory` and the
memory half of `paddle_tpu_torch.device`) on the CPU: the live-tensor
census (each storage once, views shared, grouped by shape, dtype and
device), the OOM classification held against the JAX package's on the
same exceptions, the oom_observer's bundle and its release of the
failed call's tensors, and the first-call footprint's CPU form (none).
`tests/test_memory_observability.py` cannot import under this jax, so
the JAX side is `paddle_tpu.monitor.memory` itself."""
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu.monitor import chaos as jchaos
from paddle_tpu.monitor import memory as jmemory

from paddle_tpu_torch import device
from paddle_tpu_torch.core import monitor as cmon
from paddle_tpu_torch.monitor import chaos, flight, memory


def _group(census, shape, dtype):
    return [g for g in census["groups"]
            if g["shape"] == list(shape) and g["dtype"] == dtype
            and g["device"] == "cpu"]


def test_census_counts_each_storage_once():
    c0 = memory.live_array_census(top_k=0)
    base = torch.zeros(123, 7, dtype=torch.float64)
    c1 = memory.live_array_census(top_k=0)
    views = [base[1:], base.t(), base.view(7, 123)]
    c2 = memory.live_array_census(top_k=0)
    other = torch.ones(3, 5, 11, dtype=torch.bfloat16)
    c3 = memory.live_array_census(top_k=0)
    assert c1["total_bytes"] - c0["total_bytes"] == 123 * 7 * 8
    assert c2["total_bytes"] == c1["total_bytes"]     # views are free
    assert c3["total_bytes"] - c2["total_bytes"] == 3 * 5 * 11 * 2
    assert _group(c3, (123, 7), "float64")           # the base's shape
    assert _group(c3, (3, 5, 11), "bfloat16")[0]["bytes"] >= 330
    assert c3["devices"]["cpu"] == c3["total_bytes"]
    assert {"total_bytes", "total_arrays", "group_count", "truncated",
            "groups"} <= set(c3)
    del views, other


def test_census_top_k_truncates_but_totals_cover_all(monkeypatch):
    keep = [torch.zeros(i + 1, 3) for i in range(20)]
    full = memory.live_array_census(top_k=0)
    cut = memory.live_array_census(top_k=2)
    assert len(cut["groups"]) == 2 and cut["truncated"]
    assert cut["total_bytes"] == full["total_bytes"]
    monkeypatch.setenv("PADDLE_MEM_CENSUS_TOP_K", "4")
    assert len(memory.live_array_census()["groups"]) == 4
    assert cut["groups"] == sorted(cut["groups"], key=lambda g: -g["bytes"])
    del keep


def test_cpu_memory_stats_and_device_surface():
    st = memory.memory_stats("cpu")
    assert st["source"] == "census"
    assert st["allocated_bytes"] == st["peak_bytes"] >= 0
    assert device.memory_stats("cpu")["source"] == "census"
    assert device.memory_allocated("cpu") >= 0
    assert device.max_memory_allocated("cpu") >= 0
    assert device.reset_max_memory_allocated("cpu") >= 0
    device.synchronize()
    assert device.cuda_device_count() == (torch.cuda.device_count()
                                          if torch.cuda.is_available() else 0)
    used, peak = memory.sync_gauges()
    assert cmon.stat_get("mem/allocated_bytes") == used
    assert cmon.stat_get("mem/peak_bytes") == peak


def test_step_reading_reads_only_the_card(monkeypatch):
    if not torch.cuda.is_available():
        assert memory.step_reading() == (0, 0)
    monkeypatch.setenv("PADDLE_MEM_STEP", "0")
    assert memory.step_reading() == (0, 0)


def _jax_oom(msg="RESOURCE_EXHAUSTED: Out of memory while trying to "
             "allocate 10 bytes"):
    return jchaos.XlaRuntimeError(msg)


@pytest.mark.parametrize("exc,port,jax", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
     True, False),
    (RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"), True,
     False),
    (RuntimeError("out of range"), False, False),
    (ValueError("CUDA out of memory"), False, False),
    (None, False, False),
])
def test_is_oom_error(exc, port, jax):
    assert memory.is_oom_error(exc) is port
    assert jmemory.is_oom_error(exc) is jax


def test_is_oom_error_takes_the_jax_classes_like_jax():
    for e in (_jax_oom(), _jax_oom("other"),
              jchaos.XlaRuntimeError("RESOURCE_EXHAUSTED")):
        assert memory.is_oom_error(e) == jmemory.is_oom_error(e)


def _fails_with_oom(keep):
    big = torch.ones(256, 1024)     # the failed call's live tensor
    keep.append(weakref.ref(big))
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")


def test_oom_observer_bundles_then_releases(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    keep = []
    with pytest.raises(torch.OutOfMemoryError) as ei:
        with memory.oom_observer():
            _fails_with_oom(keep)
    assert ei.value._paddle_flight_dumped
    del ei
    gc.collect()
    assert keep[0]() is None        # the traceback's frames were cleared
    (name,) = [n for n in os.listdir(tmp_path) if n.startswith("oom_")]
    b = flight.read_dump(str(tmp_path / name))
    census = b["memory"]["census"]
    # the census was taken while the failed call's tensor was live
    assert any(g["shape"] == [256, 1024] and g["dtype"] == "float32"
               for g in census["groups"])
    assert b["exception"]["type"] == "OutOfMemoryError"
    assert [e["kind"] for e in b["flight_tail"]][-2:] == ["oom", "dump"] \
        or "oom" in [e["kind"] for e in b["flight_tail"]]


def test_oom_observer_passes_other_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    with pytest.raises(ValueError):
        with memory.oom_observer():
            raise ValueError("not an oom")
    assert not os.listdir(tmp_path)


def test_auto_oom_observer_gate(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_FLIGHT_AUTOARM", "0")
    with pytest.raises(torch.OutOfMemoryError):
        with memory.auto_oom_observer():
            raise torch.OutOfMemoryError("CUDA out of memory.")
    assert not os.listdir(tmp_path)
    monkeypatch.delenv("PADDLE_FLIGHT_AUTOARM")
    with pytest.raises(torch.OutOfMemoryError):
        with memory.auto_oom_observer():
            raise torch.OutOfMemoryError("CUDA out of memory.")
    assert len(os.listdir(tmp_path)) == 1


def test_fit_leaves_an_oom_bundle(tmp_path, monkeypatch):
    """Model.fit wraps its loop in auto_oom_observer: the chaos
    `dispatch` site's resource_exhausted ends the fit with an "oom"
    bundle (census included) and the exception."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.optimizer import SGD

    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    net = torch.nn.Linear(4, 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 4)
                         .astype(np.float32))
    ds = TensorDataset([x, x[:, :1]])
    m = Model(net).prepare(SGD(0.1, parameters=net.parameters()),
                           lambda o, y: ((o - y) ** 2).mean())
    with chaos.inject("dispatch", "resource_exhausted", after=1):
        with pytest.raises(torch.OutOfMemoryError):
            m.fit(DataLoader(ds, batch_size=4, device="cpu"), verbose=0)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("oom_")
    assert "census" in flight.read_dump(str(tmp_path / name))["memory"]


def test_first_call_footprint_records_nothing_on_the_cpu():
    with memory.first_call_footprint("cpu") as fp:
        torch.ones(10)
    assert fp == {}
    assert memory.record_program_memory("x", footprint=fp) is None
    got = memory.record_program_memory(
        "prog", footprint={"peak_delta_bytes": 5, "total_bytes": 5})
    assert got == {"peak_delta_bytes": 5, "total_bytes": 5}
    assert cmon.stat_get("mem/program/prog/total_bytes") == 5
    report = [{"kind": "train_step", "fn": "A", "memory": {"total_bytes": 1}},
              {"kind": "train_step", "fn": "A", "memory": {"total_bytes": 2}},
              {"kind": "train_step", "fn": "B", "memory": None}]
    assert memory.program_footprints(report) == {
        "train_step:A": {"total_bytes": 1},
        "train_step:A(2)": {"total_bytes": 2}}
    assert set(memory.memory_report()) == {"device", "programs", "census"}
