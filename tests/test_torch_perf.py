"""The port's perf plane (`paddle_tpu_torch.monitor.perf`) held against
the JAX package's `paddle_tpu.monitor.perf`: roofline_verdict and
perf_report agree on the same stats, histograms and peaks; the peak
table names the H100 and keeps JAX's cpu row; the train step records
no cost (the port has no compiler analysis) and observes every call
after its first into its dispatch histogram."""
import numpy as np
import pytest
import torch

from paddle_tpu.core import monitor as jcore
from paddle_tpu.monitor import perf as jperf

from paddle_tpu_torch.core import monitor as core
from paddle_tpu_torch.monitor import perf

PEAKS = {"device_kind": "x", "matched": "h100", "peak_tflops": 989.0,
         "hbm_gbps": 3350.0, "ici_gbps": 450.0}


@pytest.mark.parametrize("flops,nbytes,comm", [
    (0, 10, 0.0), (10, 0, 0.0), (10 ** 12, 10 ** 9, 0.0),
    (10 ** 9, 10 ** 9, 0.0), (295 * 10 ** 9, 10 ** 9, 0.0),
    (296 * 10 ** 9, 10 ** 9, 0.0), (10 ** 12, 10 ** 9, 0.6),
    (10 ** 12, 10 ** 9, 0.5)])
def test_roofline_verdict_matches_jax(flops, nbytes, comm):
    for pk, hbm in ((989.0, 3350.0), (0.2, 50.0), (197.0, 819.0)):
        assert perf.roofline_verdict(flops, nbytes, pk, hbm, comm) == \
            jperf.roofline_verdict(flops, nbytes, pk, hbm, comm)


def _registry(hist_cls):
    rng = np.random.RandomState(1)
    stats = {"perf/program/train_step:GPT/flops": 7 * 10 ** 12,
             "perf/program/train_step:GPT/bytes_accessed": 9 * 10 ** 10,
             "perf/program/train_step:GPT/transcendentals": 0,
             "perf/program/train_step:GPT@k4/flops": 28 * 10 ** 12,
             "perf/program/train_step:GPT@k4/bytes_accessed": 10 ** 10,
             "perf/program/serve_decode:GPT/flops": 0,
             "comm/all_reduce/wire_bytes": 3 * 10 ** 9,
             "comm/send/wire_bytes": 10 ** 8, "step/count": 3}
    hists = {}
    for name, mu in (("train_step:GPT", 11.0), ("train_step:GPT@k4", 12.0)):
        h = hist_cls(f"jit/hist/{name}/dispatch_us")
        for v in rng.lognormal(mu, 0.2, 50):
            h.observe(float(v))
        hists[f"jit/hist/{name}/dispatch_us"] = h.snapshot()
    return stats, hists


@pytest.mark.parametrize("peaks", [
    PEAKS, dict(PEAKS, matched="cpu", peak_tflops=0.2, hbm_gbps=50.0,
                ici_gbps=10.0)])
def test_perf_report_matches_jax(peaks):
    stats, hists = _registry(core.Histogram)
    jstats, jhists = _registry(jcore.Histogram)
    assert hists == jhists
    got = perf.perf_report(stats, hists, peaks)
    assert got == jperf.perf_report(jstats, jhists, peaks)
    assert got["programs"]["train_step:GPT"]["mfu"] is not None


def test_device_peaks_cpu_row_and_env(monkeypatch):
    got = perf.device_peaks()
    if not torch.cuda.is_available():
        assert got["matched"] == "cpu" and got["device_kind"] == "cpu"
    assert perf.PEAK_TABLE["cpu"] == jperf.PEAK_TABLE["cpu"]
    assert perf.PEAK_TABLE["h100"] == (989.0, 3350.0, 450.0)
    assert set(perf.PEAK_TABLE) == {"h100", "cpu"}
    monkeypatch.setenv("PADDLE_PEAK_TFLOPS", "7.5")
    monkeypatch.setenv("PADDLE_HBM_GBPS", "100")
    p = perf.device_peaks()
    assert p["peak_tflops"] == 7.5 and p["hbm_gbps"] == 100.0


def test_record_program_cost_and_gate(monkeypatch):
    cost = {"flops": 12, "bytes_accessed": 34, "transcendentals": -1}
    assert perf.record_program_cost("p1", cost=cost) == {
        "flops": 12, "bytes_accessed": 34, "transcendentals": 0}
    assert core.stat_get("perf/program/p1/flops") == 12
    assert perf.record_program_cost("p1", cost=None) is None
    monkeypatch.setenv("PADDLE_PERF_PROGRAM", "0")
    assert perf.record_program_cost("p2", cost=cost) is None
    assert "perf/program/p2/flops" not in core.registry.snapshot()
    assert perf.program_costs([{"kind": "train_step", "fn": "A",
                                "cost": {"flops": 1}}]) == {
        "train_step:A": {"flops": 1}}


def _linear_step():
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                              torch.nn.Linear(32, 4))
    opt = SGD(0.1, parameters=net.parameters())
    step = TrainStepCompiler(net, opt, lambda o, y: ((o - y) ** 2).mean())
    return net, step


def test_train_step_cost_ledger_counts_the_first_call():
    """The train step's first call records no cost: no
    `perf/program/<name>/*` gauge and a None "cost" in its
    cache_report entry, beside its memory ledger (None on the CPU)."""
    x, y = torch.randn(8, 16), torch.randn(8, 4)
    _, step = _linear_step()
    step(x, y)
    assert not [k for k in core.registry.snapshot()
                if k.startswith("perf/program/train_step:Sequential/")]
    from paddle_tpu_torch.jit import cache_report

    ent = [e for e in cache_report() if e["kind"] == "train_step"
           and e["fn"] == "Sequential" and e["entries"] == 1]
    assert ent and all(e["cost"] is None and e["memory"] is None
                       for e in ent)


def test_dispatch_histogram_after_the_first_call(monkeypatch):
    x, y = torch.randn(8, 16), torch.randn(8, 4)
    core.hist_get("jit/hist/train_step:Sequential/dispatch_us").reset()
    _, step = _linear_step()
    step(x, y)
    h = core.hist_get("jit/hist/train_step:Sequential/dispatch_us")
    assert h.count == 0                     # the first call is not timed
    step(x, y)
    step(x, y)
    assert h.count == 2
    monkeypatch.setenv("PADDLE_PERF_DISPATCH", "0")
    step(x, y)
    assert h.count == 2
    # no cost, no perf_report entry; a cost recorded by hand joins the
    # histogram as the JAX package's ledger does
    assert "train_step:Sequential" not in perf.perf_report()["programs"]
    perf.record_program_cost("train_step:Sequential", cost={
        "flops": 10 ** 9, "bytes_accessed": 10 ** 6})
    rep = perf.perf_report()["programs"]["train_step:Sequential"]
    assert rep["dispatch"]["count"] == 2 and rep["mfu"] > 0


def test_ledger_gates_and_bit_identity(monkeypatch):
    """With both ledgers off the first call records nothing; on or
    off, the step's results are bit-identical."""
    x, y = torch.randn(8, 16), torch.randn(8, 4)
    net_a, a = _linear_step()
    la = [float(a(x, y)) for _ in range(3)]
    monkeypatch.setenv("PADDLE_PERF_PROGRAM", "0")
    monkeypatch.setenv("PADDLE_MEM_PROGRAM", "0")
    net_b, b = _linear_step()
    lb = [float(b(x, y)) for _ in range(3)]
    assert b._mem_analysis is None
    assert la == lb
    for pa, pb in zip(net_a.parameters(), net_b.parameters()):
        assert torch.equal(pa, pb)
