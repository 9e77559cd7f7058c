"""The port's telemetry hub (`paddle_tpu_torch.monitor`: StepTimer,
prometheus_text, MetricsExporter, telemetry_snapshot) held against the
JAX package's `paddle_tpu.monitor`, and the registry gate: every name
of the JAX monitor planes is in the port or on an explicit waiting
list naming its ROADMAP item; a disarmed import and step leave no
chaos/* or sanitize/* counter and plain threading locks."""
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

import paddle_tpu.monitor as jmon
from paddle_tpu.core import monitor as jcore
from paddle_tpu.monitor import chaos as jchaos
from paddle_tpu.monitor import sanitize as jsanitize
from paddle_tpu.monitor import server as jserver

import paddle_tpu_torch.monitor as mon
from paddle_tpu_torch.core import monitor as core
from paddle_tpu_torch.monitor import chaos, flight, sanitize, server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- prometheus_text ----------------------------------------------------

def _snapshot(hist_cls):
    rng = np.random.RandomState(3)
    hists = {}
    for name in ("step/hist/time_us", "serve/hist/ttft_us", "io/x y"):
        h = hist_cls(name)
        for v in rng.lognormal(8, 2, 200):
            h.observe(float(v))
        h.observe(0.0)
        h.observe(1e30)          # overflow
        hists[name] = h.snapshot()
    stats = {"step/count": 12, "step/time": 5, "step_time": 7,
             "step/hist/time_us_bucket": 1, "mem/peak_bytes": 123456789,
             "step/throughput": 17.25, "flag": True,
             "nan/gauge": float("nan"), "inf/gauge": float("-inf"),
             'odd"name\\x': 3}
    return {"ts": 1792310793.616, "rank": 0, "stats": stats,
            "hists": hists}


def test_prometheus_text_byte_identical_to_jax():
    snap = _snapshot(core.Histogram)
    assert snap["hists"] == _snapshot(jcore.Histogram)["hists"]
    got = mon.prometheus_text(snap)
    assert got == jmon.prometheus_text(snap)
    assert "paddle_tpu_step_hist_time_us_bucket" in got and "+Inf" in got


def test_live_prometheus_text_renders_the_registry():
    core.stat_set("test/monitor/gauge", 41)
    text = mon.prometheus_text()
    assert "paddle_tpu_test_monitor_gauge 41\n" in text
    assert text.endswith("\n")


# -- StepTimer ----------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(timer, clock, steps):
    for dt, bs, loss, lr in steps:
        timer.begin_step()
        clock.t += dt
        timer.end_step(batch_size=bs, loss=loss, lr=lr)


STEPS = [(0.125, 32, 2.5, 1e-4), (0.25, 32, 2.25, 2e-4),
         (0.0625, 16, float("nan"), 3e-4), (0.5, None, None, None),
         (0.03125, 8, 1.75, float("inf"))]


def test_step_timer_matches_jax(monkeypatch):
    """The same steps under an injected clock give the JAX StepTimer's
    step/* stats (the memory and step-attribution gauges aside: their
    inputs are each package's own device and flight ring).

    Each registry starts empty for this test: `reset_all` only zeroes,
    so a `step/...` name another test registered earlier in the same
    process (`test_observability.py` sets `step/time`) would stay in
    one snapshot as a 0 and not in the other."""
    for reg in (jcore.registry, core.registry):
        monkeypatch.setattr(reg, "_stats", {})
        monkeypatch.setattr(reg, "_hists", {})
    jclock = _Clock()
    fake = types.SimpleNamespace(perf_counter=jclock,
                                 time=lambda: 1.0)
    monkeypatch.setattr(jmon, "time", fake)
    monkeypatch.setenv("PADDLE_PERF_STEP", "0")
    monkeypatch.setenv("PADDLE_MEM_STEP", "0")
    jt = jmon.StepTimer()
    _drive(jt, jclock, STEPS)
    pclock = _Clock()
    pt = mon.StepTimer(clock=pclock)
    _drive(pt, pclock, STEPS)

    def step_stats(reg):
        return {k: v for k, v in reg.snapshot().items()
                if k.startswith("step/") and not k.startswith(
                    ("step/attrib/", "step/mem/", "step/device_mem"))}

    assert step_stats(core.registry) == step_stats(jcore.registry)
    assert core.registry.snapshot_histograms()["step/hist/time_us"] == \
        jcore.registry.snapshot_histograms()["step/hist/time_us"]
    assert pt.summary() == jt.summary()


def test_step_attrib_buckets_flight_spans(monkeypatch):
    monkeypatch.setenv("PADDLE_PERF_STEP", "1")
    clock = _Clock()
    t = mon.StepTimer(clock=clock)
    t.begin_step()
    with flight.in_flight("collective", "all_reduce"):
        pass
    flight.record("dispatch_end", name="x", dur_us=1000)
    flight.record("io_fetch", n=1, us=500)
    clock.t += 1.0
    t.end_step()
    comm = core.stat_get("step/attrib/comm_us")
    assert core.stat_get("step/attrib/device_us") == 1000
    assert core.stat_get("step/attrib/io_us") == 500
    assert core.stat_get("step/attrib/host_us") == 10 ** 6 - 1500 - comm


# -- MetricsExporter ----------------------------------------------------

def test_exporter_jsonl_and_prom(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    path = tmp_path / "m_{rank}.jsonl"
    e = mon.MetricsExporter(str(path), interval=60)
    snap = e.flush()
    line = json.loads((tmp_path / "m_3.jsonl").read_text().splitlines()[-1])
    assert line["stats"] == snap["stats"] and line["rank"] == 3
    prom = mon.MetricsExporter(str(tmp_path / "m.prom"), interval=60)
    assert prom.fmt == "prom"
    snap = prom.flush()
    assert (tmp_path / "m.prom").read_text() == mon.prometheus_text(snap)
    with pytest.raises(ValueError):
        mon.MetricsExporter(str(tmp_path / "x"), fmt="csv")


def test_exporter_env_contract(tmp_path, monkeypatch):
    assert mon.start_exporter() is None or os.environ.get(
        "PADDLE_MONITOR_EXPORT_PATH")
    monkeypatch.setenv("PADDLE_MONITOR_EXPORT_PATH",
                       str(tmp_path / "t.jsonl"))
    monkeypatch.setenv("PADDLE_MONITOR_EXPORT_INTERVAL", "0.05")
    e = mon.start_exporter()
    try:
        assert e is mon.get_exporter() and e.interval == 0.05
        assert e.fmt == "jsonl"
    finally:
        mon.stop_exporter()
    assert mon.get_exporter() is None
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) >= 1


def test_exporter_counts_flush_errors(tmp_path):
    bad = tmp_path / "file"
    bad.write_text("x")
    e = mon.MetricsExporter(str(bad / "sub" / "m.jsonl"), interval=60)
    before = core.stat_get("monitor/export/errors")
    e.stop(flush=True)
    assert core.stat_get("monitor/export/errors") == before + 1


def test_telemetry_snapshot_shape():
    snap = mon.telemetry_snapshot()
    assert set(snap) == set(jmon.telemetry_snapshot())
    assert "flight/events" in snap["stats"]
    assert "mem/allocated_bytes" in snap["stats"]


# -- the registry gate --------------------------------------------------

def _covered(names, ported, waiting):
    return sorted(n for n in names if n not in ported and n not in waiting)


def test_registry_gate():
    """Every name of the JAX planes is ported or waits on a named
    ROADMAP item."""
    for waiting in (chaos.WAITING, sanitize.WAITING, mon.WAITING):
        assert all("ROADMAP" in why for why in waiting.values())
    assert _covered(jchaos.SITES, chaos.SITES, chaos.WAITING) == []
    assert _covered(jchaos.FAULTS, chaos.FAULTS, {}) == []
    assert _covered(jchaos.PARAMS, chaos.PARAMS, {}) == []
    assert [p for p, _, _ in server.ROUTES] == \
        [p for p, _, _ in jserver.ROUTES]
    assert _covered(jsanitize.FAMILIES, sanitize.FAMILIES,
                    sanitize.WAITING) == []
    assert _covered(jsanitize.PARAMS, sanitize.PARAMS, {}) == []
    assert _covered(jmon.__all__, mon.__all__, mon.WAITING) == []
    # nothing is both ported and waiting
    assert not set(chaos.SITES) & set(chaos.WAITING)
    assert not set(sanitize.FAMILIES) & set(sanitize.WAITING)
    assert not set(mon.__all__) & set(mon.WAITING)


_DISARMED = r"""
import threading, numpy as np
import paddle_tpu_torch
from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import flight, sanitize, server
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.jit import TrainStepCompiler
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.incubate.checkpoint.elastic import CheckpointManager
m = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                   num_heads=2, ffn_hidden=64, max_seq_len=16), device="cpu")
step = TrainStepCompiler(m, AdamW(1e-3, parameters=m.parameters()))
ids = np.random.RandomState(0).randint(0, 64, (2, 16))
for _ in range(2):
    step(ids, ids)
mgr = CheckpointManager(dir=None, device="cpu")
plain = type(threading.Lock())
bad = sorted(k for k in monitor.registry.snapshot()
             if k.startswith(("chaos/", "sanitize/")))
locks = [flight.recorder._lock, flight._inflight_lock, mgr._write_lock,
         server._server_lock]
print(bad, all(type(l) is plain for l in locks),
      type(mgr._cv) is threading.Condition,
      type(sanitize.lock("x")) is plain)
"""


def test_disarmed_import_and_step_leave_nothing(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_CHAOS", "PADDLE_SANITIZE"))}
    env["PYTHONPATH"] = REPO
    env["PADDLE_CKPT_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _DISARMED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "[] True True True"


def test_env_armed_import_arms_both_planes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_CHAOS="collective:delay:ms=0",
               PADDLE_SANITIZE="locks")
    code = ("from paddle_tpu_torch.monitor import chaos, sanitize, flight\n"
            "print(chaos.active(), sanitize.armed('locks'), "
            "type(flight.recorder._lock).__name__, "
            "[e['kind'] for e in flight.tail()][:2])")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == \
        "True True SanLock ['sanitize_arm', 'chaos_arm']"


def test_vlog_prefix(capsys, monkeypatch):
    monkeypatch.setenv("GLOG_v", "1")
    core.VLOG(1, "hello")
    core.VLOG(2, "hidden")
    err = capsys.readouterr().err
    assert "hello" in err and "hidden" not in err and err.startswith("V1 ")
    assert threading.current_thread() is threading.main_thread()
