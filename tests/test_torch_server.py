"""The port's debug server (`paddle_tpu_torch.monitor.server`): every
route of the JAX package's ROUTES answers on an ephemeral port,
/metrics is prometheus_text() (byte for byte over one snapshot), the
flight-only /profilez window works and the profiler window answers
501, arming follows PADDLE_MONITOR_SERVE, and flight_chrome equals
the JAX package's on the same events."""
import json
import urllib.error
import urllib.request

import pytest

from paddle_tpu.monitor import server as jserver

import paddle_tpu_torch.monitor as mon
from paddle_tpu_torch.monitor import flight, server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


@pytest.fixture
def srv():
    s = server.serve(port=0, host="127.0.0.1")
    yield s
    server.stop_server()


def test_routes_are_jax_routes():
    assert [p for p, _, _ in server.ROUTES] == \
        [p for p, _, _ in jserver.ROUTES]
    assert [a for _, _, a in server.ROUTES] == \
        [a for _, _, a in jserver.ROUTES]


def test_every_route_answers(srv):
    flight.record("test_event", x=1)
    with flight.in_flight("collective", "all_reduce"):
        pass
    want = {"/metrics": 200, "/metrics?format=json": 200, "/healthz": 200,
            "/statusz": 200, "/flightz?n=5": 200, "/flightz?format=chrome":
            200, "/memz": 200, "/perfz": 200, "/tracez": 200,
            "/profilez?profiler=0&duration_ms=20": 200, "/profilez": 501,
            "/alertz": 200, "/": 200, "/nope": 404}
    for path, code in want.items():
        got, ctype, body = _get(srv.url + path)
        assert got == code, (path, got, body[:200])
        if path.startswith(("/metrics?", "/statusz", "/flightz", "/memz",
                            "/perfz", "/tracez", "/profilez", "/alertz")) \
                or path in ("/", "/nope"):
            json.loads(body)
    _, _, body = _get(srv.url + "/statusz")
    st = json.loads(body)
    assert st["ok"] and st["server"]["port"] == srv.port
    assert st["schema_flight"] == flight.DUMP_SCHEMA
    _, _, body = _get(srv.url + "/flightz?n=5")
    assert len(json.loads(body)["events"]) == 5
    _, _, body = _get(srv.url + "/flightz?format=chrome")
    assert any(e["ph"] == "X" and e["name"] == "collective"
               for e in json.loads(body)["traceEvents"])
    _, _, body = _get(srv.url + "/profilez?profiler=0&duration_ms=20")
    pz = json.loads(body)
    assert pz["schema"] == jserver.PROFILEZ_SCHEMA
    assert [e["kind"] for e in pz["flight"]][0] == "profilez_begin"
    _, _, body = _get(srv.url + "/profilez")
    assert "ROADMAP" in json.loads(body)["error"]
    _, _, body = _get(srv.url + "/memz")
    assert set(json.loads(body)) == {"device", "programs", "census"}
    _, ctype, _ = _get(srv.url + "/healthz")
    assert ctype.startswith("text/plain")


def test_metrics_is_prometheus_text_byte_for_byte():
    snap = mon.telemetry_snapshot()
    s = server.DebugServer(port=0, host="127.0.0.1",
                           snapshot_fn=lambda: snap).start()
    try:
        code, ctype, body = _get(s.url + "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body == mon.prometheus_text(snap)
        _, _, js = _get(s.url + "/metrics?format=json")
        assert json.loads(js)["stats"] == snap["stats"]
    finally:
        s.shutdown()
        s.shutdown()                         # idempotent


def test_live_metrics_page(srv):
    """The process-wide server renders the live registry: after the
    request counter ticks, the page equals a fresh prometheus_text()
    except for the export timestamp line."""
    _get(srv.url + "/healthz")
    _, _, body = _get(srv.url + "/metrics")
    local = mon.prometheus_text()

    def strip(t):
        return [ln for ln in t.splitlines()
                if not ln.startswith(("paddle_tpu_export_timestamp",
                                      "paddle_tpu_monitor_serve_requests"))]

    assert strip(body) == strip(local)


def test_maybe_auto_serve_env(monkeypatch):
    monkeypatch.delenv("PADDLE_MONITOR_SERVE", raising=False)
    assert server.maybe_auto_serve("t") is None
    monkeypatch.setenv("PADDLE_MONITOR_SERVE", "off")
    assert server.maybe_auto_serve("t") is None
    monkeypatch.setenv("PADDLE_MONITOR_SERVE", "0")
    monkeypatch.setenv("PADDLE_MONITOR_SERVE_HOST", "127.0.0.1")
    try:
        s = server.maybe_auto_serve("t")
        assert s is not None and s.running() and s.port > 0
        assert server.maybe_auto_serve("t") is s
        assert server.describe()["running"]
        assert flight.tail(1)[0]["kind"] == "auto_serve"
    finally:
        server.stop_server()
        server.stop_server()
    assert server.get_server() is None
    assert server.describe() == {"running": False}


def test_fit_arms_the_server(monkeypatch):
    import numpy as np
    import torch

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.optimizer import SGD

    monkeypatch.setenv("PADDLE_MONITOR_SERVE", "0")
    monkeypatch.setenv("PADDLE_MONITOR_SERVE_HOST", "127.0.0.1")
    net = torch.nn.Linear(3, 1)
    x = torch.from_numpy(np.ones((4, 3), np.float32))
    m = Model(net).prepare(SGD(0.1, parameters=net.parameters()),
                           lambda o, y: ((o - y) ** 2).mean())
    before = mon.stat_get("step/count")
    try:
        m.fit(DataLoader(TensorDataset([x, x[:, :1]]), batch_size=2,
                         device="cpu"), verbose=0)
        s = server.get_server()
        assert s is not None and s.running()
        _, _, body = _get(s.url + "/metrics?format=json")
        assert json.loads(body)["stats"]["step/count"] == before + 2
    finally:
        server.stop_server()


def test_trace_sources_are_weak(srv):
    class Src:
        def spool(self):
            return {"requests": [1]}

    a = Src()
    server.add_trace_source(a.spool)
    server.add_trace_source(a.spool)
    assert server.trace_spools().count({"requests": [1]}) == 1
    del a
    assert {"requests": [1]} not in server.trace_spools()


def test_flight_chrome_matches_jax():
    events = [{"ts": 1.5, "tid": 7, "kind": "dispatch_end", "name": "x",
               "dur_us": 250},
              {"ts": 2.0, "tid": 7, "kind": "chaos_inject", "site": "s",
               "n": 1, "none": None},
              {"ts": 2.5, "tid": 8, "kind": "ckpt_write_end", "dur_us": 0}]
    assert server.flight_chrome(events, pid=3) == \
        jserver.flight_chrome(events, pid=3)
