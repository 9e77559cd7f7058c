"""The port's flight recorder (`paddle_tpu_torch.monitor.flight`) held
against the JAX package's: a port-written dump bundle reads in the JAX
`python -m paddle_tpu.monitor inspect` (and has the JAX bundle's
sections), a JAX-written bundle reads in the port's `read_dump`; the
Watchdog fires once on a stalled in-flight op and runs the incident
hooks; the excepthooks, dump_on_crash and the SIGUSR1 handler write
their bundles; arming follows PADDLE_FLIGHT_AUTOARM."""
import json
import os
import signal
import sys
import threading
import time

import pytest
import torch

from paddle_tpu.monitor import cli as jcli
from paddle_tpu.monitor import flight as jflight

from paddle_tpu_torch.core import monitor as cmon
from paddle_tpu_torch.monitor import flight


@pytest.fixture(autouse=True)
def _dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    yield tmp_path
    flight.stop_watchdog()


def test_port_bundle_reads_in_jax_inspect(tmp_path, capsys):
    x = torch.ones(4, 4)
    with flight.in_flight("collective", "all_reduce", bytes=64):
        path = flight.write_dump("test", extra={"note": "port"},
                                 full_memory=True)
    del x
    assert jcli.main(["inspect", path, "--stacks"]) == 0
    out = capsys.readouterr().out
    assert "== flight dump: test" in out
    assert "collective/all_reduce" in out
    assert "live arrays:" in out          # the census section rendered
    assert jcli.main(["inspect", path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == jflight.DUMP_SCHEMA == flight.DUMP_SCHEMA
    assert doc["note"] == "port"


def test_bundle_sections_match_jax(tmp_path):
    port = flight.read_dump(flight.write_dump("same"))
    jax_path = jflight.write_dump("same",
                                  path=str(tmp_path / "jax_same.json"))
    with open(jax_path) as f:
        jax = json.load(f)
    assert set(port) == set(jax)
    assert set(port["telemetry"]) == set(jax["telemetry"])
    assert set(port["memory"]) == {"device", "programs"}


def test_jax_bundle_reads_in_port(tmp_path):
    path = jflight.write_dump("jaxside",
                              path=str(tmp_path / "jaxside.json"))
    b = flight.read_dump(path)
    assert b["reason"] == "jaxside" and b["threads"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError):
        flight.read_dump(str(bad))


def test_watchdog_fires_once_on_a_stalled_op(tmp_path):
    hooks = []
    flight.add_incident_hook(hooks.append)
    try:
        wd = flight.Watchdog(timeout_s=0.5, poll_s=60)
        tok = flight.begin("serve_decode", "decode", batch=2)
        assert wd.check() is None                    # not yet stale
        later = time.monotonic() + 1.0
        path = wd.check(now=later)
        assert path and wd.fired == 1 and hooks == ["watchdog"]
        assert wd.check(now=later + 1) is None       # reported once
        b = flight.read_dump(path)
        assert b["reason"] == "watchdog"
        assert [e["kind"] for e in b["stuck"]] == ["serve_decode"]
        me = threading.get_ident()
        assert b["stuck"][0]["tid"] == me
        assert any(t["tid"] == me for t in b["threads"])
        flight.end(tok)
        tok2 = flight.begin("ckpt_write", "step_3")
        assert wd.check(now=time.monotonic() + 2)    # a second op: dumps
        flight.end(tok2)
        assert wd.fired == 2
    finally:
        flight.remove_incident_hook(hooks.append)


def test_watchdog_thread_and_env(monkeypatch):
    monkeypatch.setenv("PADDLE_WATCHDOG_TIMEOUT_S", "0.2")
    wd = flight.start_watchdog()
    assert wd.timeout_s == 0.2 and wd.running()
    assert flight.start_watchdog() is wd
    before = cmon.stat_get("flight/watchdog/fires")
    with flight.in_flight("collective", "stall"):
        deadline = time.monotonic() + 10
        while cmon.stat_get("flight/watchdog/fires") == before \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    assert cmon.stat_get("flight/watchdog/fires") == before + 1
    flight.stop_watchdog()
    assert flight.get_watchdog() is None


def test_incident_hook_errors_are_counted():
    def bad(reason):
        raise RuntimeError(reason)

    flight.add_incident_hook(bad)
    before = cmon.stat_get("flight/incident_hook/errors")
    try:
        flight._run_incident_hooks("x")
    finally:
        flight.remove_incident_hook(bad)
    assert cmon.stat_get("flight/incident_hook/errors") == before + 1


def test_excepthooks_write_crash_and_oom_bundles(tmp_path):
    flight.install_excepthook()
    try:
        assert sys.excepthook is flight._flight_excepthook
        seen = []
        real = flight._orig_excepthook
        flight._orig_excepthook = lambda *a: seen.append(a[0])
        try:
            try:
                raise ValueError("boom")
            except ValueError:
                flight._flight_excepthook(*sys.exc_info())
            try:
                raise torch.OutOfMemoryError("CUDA out of memory. x")
            except torch.OutOfMemoryError:
                flight._flight_excepthook(*sys.exc_info())
        finally:
            flight._orig_excepthook = real
        assert seen == [ValueError, torch.OutOfMemoryError]
        names = sorted(os.listdir(tmp_path))
        assert any(n.startswith("crash_") for n in names)
        oom = [n for n in names if n.startswith("oom_")]
        assert len(oom) == 1
        b = flight.read_dump(str(tmp_path / oom[0]))
        assert b["exception"]["type"] == "OutOfMemoryError"
        assert "census" in b["memory"]
        # a worker thread's death leaves a bundle too
        t = threading.Thread(target=lambda: 1 / 0, name="dies")
        t.start()
        t.join()
        assert len([n for n in os.listdir(tmp_path)
                    if n.startswith("crash_")]) == 2
    finally:
        flight.uninstall_excepthook()
    assert sys.excepthook is not flight._flight_excepthook


def test_dump_on_crash_reraises(tmp_path):
    with pytest.raises(KeyError):
        with flight.dump_on_crash():
            raise KeyError("k")
    assert [n for n in os.listdir(tmp_path) if n.startswith("crash_")]


def test_sigusr1_live_dump(tmp_path):
    if not hasattr(signal, "SIGUSR1"):
        pytest.skip("no SIGUSR1 on this platform")
    chained = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: chained.append(s))
    try:
        assert flight.install_signal_handler()
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 10
        while not [n for n in os.listdir(tmp_path)
                   if n.startswith("sigusr1_")] \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert [n for n in os.listdir(tmp_path)
                if n.startswith("sigusr1_")]
        assert chained == [signal.SIGUSR1]
        flight.uninstall_signal_handler()
        assert signal.getsignal(signal.SIGUSR1) is not \
            flight._signal_handler
    finally:
        flight.uninstall_signal_handler()
        signal.signal(signal.SIGUSR1, prev)


@pytest.mark.parametrize("env,world,armed", [
    (None, "1", False), (None, "2", True), ("0", "2", False),
    ("1", "1", True)])
def test_maybe_auto_arm(env, world, armed, monkeypatch):
    if env is None:
        monkeypatch.delenv("PADDLE_FLIGHT_AUTOARM", raising=False)
    else:
        monkeypatch.setenv("PADDLE_FLIGHT_AUTOARM", env)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", world)
    try:
        wd = flight.maybe_auto_arm("test")
        assert (wd is not None) == armed
        assert (jflight._env_on("PADDLE_FLIGHT_AUTOARM",
                                default=int(world) > 1)) == armed
    finally:
        flight.stop_watchdog()
        flight.uninstall_excepthook()
        flight.uninstall_signal_handler()


def test_inflight_snapshot_and_ring():
    tok = flight.begin("bootstrap", "x", url="tcp://h:1")
    snap = [e for e in flight.inflight_snapshot() if e["kind"] == "bootstrap"]
    assert snap and "age_s" in snap[0] and "_t0m" not in snap[0]
    flight.end(tok)
    ev = flight.tail(1)[0]
    assert ev["kind"] == "bootstrap_end" and ev["dur_us"] >= 0
    st = flight.recorder.stats()
    assert st["events"] >= 2 and st["capacity"] == 4096
