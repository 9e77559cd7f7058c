"""The monitor planes serving reads, held against the JAX package's.

  * `core.monitor`'s histogram: quantiles, merge, snapshots and
    `delta_since` bit-equal to JAX's on the same observations, under
    the default bucket layout and under the `PADDLE_MONITOR_HIST_*`
    knobs; the StatValue / registry additions.
  * `monitor.alerts`: for one sequence of stat and histogram values at
    the same `now`s, the transitions (rule, fire/resolve, value) equal
    JAX's, for every kind of `default_rules()` (on this file's own
    metric names, so no other test's traffic reaches them) plus
    `burn_rate`, `absence`, `for` and `clear` streaks; `parse_spec`'s
    errors equal JAX's.
  * `monitor.trace`: a request's stage sequence through add, route,
    admit, evict, export, import and failover equals JAX's, timestamps
    and durations aside, and its `trace_id` survives the failover.
  * the `Autoscaler` against JAX's, driven by the same transitions on a
    stand-in router: spawn on fire, drain on resolve, the cooldown, the
    clamps, `maybe_autoscale`'s arming, equal `serve/autoscale/*`
    counters; then on a real port `Router`, a scale-up from a fired
    `ttft_p99` rule and a scale-down mid-flood that keep JAX's tokens.
"""
import time

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu.core import monitor as jmon
from paddle_tpu.inference import serving as jserve
from paddle_tpu.inference.serving import autoscaler as jauto
from paddle_tpu.inference.serving.model_runner import extract_params
from paddle_tpu.monitor import alerts as jalerts
from paddle_tpu.text.models import gpt as jax_gpt

from paddle_tpu_torch.convert import load_reference_params
from paddle_tpu_torch.core import monitor as pmon
from paddle_tpu_torch.inference import serving as pserve
from paddle_tpu_torch.inference.serving import autoscaler as pauto
from paddle_tpu_torch.monitor import alerts as palerts
from paddle_tpu_torch.monitor import trace as ptrace
from paddle_tpu_torch.text.models import gpt as port_gpt

CPU = "cpu"
N_TOKENS = 6
PROMPT_LENS = (3, 9, 5, 12, 7, 4)


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    jalerts.disarm()
    palerts.disarm()


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


def _obs(seed, n):
    rng = np.random.RandomState(seed)
    v = np.exp(rng.randn(n) * 2.5 + 6.0)
    v[:3] = (0.0, -4.0, 1e12)          # underflow and overflow
    return [float(x) for x in v]


@pytest.mark.parametrize("knobs", [None, ("10", "7", "5")])
def test_histogram_bit_equal_to_jax(monkeypatch, knobs):
    if knobs:
        for k, v in zip(("LO", "PER_DECADE", "DECADES"), knobs):
            monkeypatch.setenv(f"PADDLE_MONITOR_HIST_{k}", v)
    jh, ph = jmon.Histogram("a"), pmon.Histogram("a")
    assert (ph.lo, ph.per_decade, ph.decades) == \
        (jh.lo, jh.per_decade, jh.decades)
    for x in _obs(0, 2000):
        jh.observe(x)
        ph.observe(x)
    assert ph.snapshot() == jh.snapshot()
    for q in QS:
        assert ph.quantile(q) == jh.quantile(q)
    snap_j, snap_p = jh.snapshot(), ph.snapshot()
    assert snap_p == snap_j
    for x in _obs(1, 300):
        jh.observe(x)
        ph.observe(x)
    dj, dp = jh.delta_since(snap_j), ph.delta_since(snap_p)
    assert dp == dj and dp["count"] == 300
    for q in QS:
        assert pmon.snapshot_quantile(dp, q, empty=None) == \
            jmon.snapshot_quantile(dj, q, empty=None)
    jo, po = jmon.Histogram("b"), pmon.Histogram("b")
    for x in _obs(2, 500):
        jo.observe(x)
        po.observe(x)
    jh.merge(jo)
    ph.merge(po)
    ph.merge(po.snapshot())
    jh.merge(jo.snapshot())
    assert ph.snapshot() == jh.snapshot()
    for q in QS:
        assert ph.quantile(q) == jh.quantile(q)
    assert ph.delta_since(None) == jh.delta_since(None)
    ph.reset()
    jh.reset()
    assert ph.snapshot() == jh.snapshot()
    assert ph.quantile(0.5, empty=None) is None
    with pytest.raises(ValueError, match="boundaries"):
        ph.merge(pmon.Histogram("c", lo=3.0))


def test_stat_value_and_registry_additions():
    v = pmon.StatValue("x")
    v.increase(5)
    assert v.decrease(2) == 3 and v.maximum(2) == 3 and v.maximum(9) == 9
    v.reset()
    assert v.get() == 0
    pmon.stat_set("slo_t/reg/a", 4)
    pmon.hist_observe("slo_t/reg/h", 12.0)
    hs = pmon.registry.snapshot_histograms()["slo_t/reg/h"]
    assert hs["count"] == 1 and hs["min"] == 12.0
    pmon.stat_reset("slo_t/reg/a")
    assert pmon.stat_get("slo_t/reg/a") == 0


# ---------------------------------------------------------------------------
# the alert engine
# ---------------------------------------------------------------------------

# every kind of default_rules(), with the defaults' params, on metric
# names of this file's own; plus burn_rate, absence and a clear streak
SPEC = ";".join([
    "slo_t/ttft_us:quantile:name=ttft_p99:q=0.99:gt=500000",
    "slo_t/itl_us:quantile:name=itl_p50:q=0.5:gt=100000:min_n=3",
    "slo_t/shed:rate:name=shed_rate:gt=1:window=20",
    "slo_t/queue_depth:threshold:name=queue_depth:gt=64:clear=3",
    "slo_t/kv_free:fraction:name=kv_free_frac:of=slo_t/kv_used:lt=0.1",
    "slo_t/replica/*/healthy:threshold:name=replica_unhealthy:lt=1:for=3",
    "slo_t/errors:burn_rate:name=burn:total=slo_t/requests:window=10:"
    "long=60:budget=0.1:factor=2",
    "slo_t/never:absence:name=missing",
])


def _tick_values(t):
    """Stats and histogram observations fed at tick t (same on both
    sides)."""
    stats = {
        "slo_t/shed": t * 30 if 4 <= t <= 7 else (210 if t > 7 else 0),
        "slo_t/queue_depth": 100 if t in (2, 3) else 5,
        "slo_t/kv_free": 2 if 5 <= t <= 8 else 30,
        "slo_t/kv_used": 38 if 5 <= t <= 8 else 10,
        "slo_t/replica/0/healthy": 1,
        "slo_t/replica/1/healthy": 0 if 3 <= t <= 9 else 1,
        "slo_t/errors": 0 if t < 6 else (t - 5) * 20,
        "slo_t/requests": t * 50,
    }
    rng = np.random.RandomState(t)
    ttft = list(np.exp(rng.randn(20) + (14.0 if 6 <= t <= 8 else 10.0)))
    itl = list(np.exp(rng.randn(4) + (12.0 if t == 10 else 8.0)))
    return stats, {"slo_t/ttft_us": ttft, "slo_t/itl_us": itl}


def _drive(alerts, mon, ticks=16):
    rules = alerts.configure(spec=SPEC, start=False)
    out = []
    for t in range(ticks):
        stats, hists = _tick_values(t)
        for k, v in stats.items():
            mon.stat_set(k, v)
        for k, vs in hists.items():
            for x in vs:
                mon.hist_observe(k, float(x))
        now = 1000.0 + 5.0 * t
        out.append([(r.name, ev, v) for r, ev, v in
                    alerts.evaluate_once(now=now)])
    desc = [r.describe() for r in rules]
    alerts.disarm()
    return out, desc


def test_alert_transitions_equal_jax():
    want, jdesc = _drive(jalerts, jmon)
    got, pdesc = _drive(palerts, pmon)
    assert got == want
    assert pdesc == jdesc
    fired = {name for tick in want for name, ev, _ in tick if ev == "fire"}
    resolved = {name for tick in want for name, ev, _ in tick
                if ev == "resolve"}
    assert fired == {"ttft_p99", "itl_p50", "shed_rate", "queue_depth",
                     "kv_free_frac", "replica_unhealthy", "burn",
                     "missing"}
    assert resolved >= {"ttft_p99", "queue_depth", "kv_free_frac",
                        "replica_unhealthy", "shed_rate"}


def test_default_rules_and_listeners_equal_jax():
    assert [r.describe() for r in palerts.default_rules()] == \
        [r.describe() for r in jalerts.default_rules()]
    assert [r.describe() for r in palerts.parse_spec("serving")] == \
        [r.describe() for r in jalerts.parse_spec("serving")]
    seen = []
    fn = palerts.add_listener(lambda r, ev, v: seen.append((r.name, ev)))
    bad = palerts.add_listener(lambda r, ev, v: 1 / 0)
    try:
        palerts.configure(spec="slo_t/l:threshold:gt=1:name=lst",
                          start=False)
        pmon.stat_set("slo_t/l", 5)
        before = pmon.stat_get("alerts/listener_errors")
        palerts.evaluate_once(now=1.0)
        assert seen == [("lst", "fire")]
        assert pmon.stat_get("alerts/listener_errors") == before + 1
        assert palerts.describe()["rules"][0]["state"] == "firing"
    finally:
        palerts.remove_listener(fn)
        palerts.remove_listener(bad)
    ev = palerts.AlertEvaluator(interval_s=0.05).start()
    assert ev.running()
    ev.stop()
    assert not ev.running()


@pytest.mark.parametrize("bad", [
    "m",
    "m:nosuchkind:gt=1",
    "m:threshold",
    "m:threshold:gt=1:lt=2",
    "m:threshold:bogus=1",
    "m:threshold:gt",
    "m:threshold:gt=oops",
    "m:quantile:q=1.5:gt=1",
    "m:burn_rate:gt=1:total=t",
    "m:burn_rate",
    "m:fraction:lt=0.1",
    "m/*:quantile:gt=1",
    "m:threshold:gt=1:name=ba d",
])
def test_parse_spec_errors_equal_jax(bad):
    with pytest.raises(ValueError) as je:
        jalerts.parse_spec(bad)
    with pytest.raises(ValueError) as pe:
        palerts.parse_spec(bad)
    assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# serving: model, traces, autoscaler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twins():
    paddle.seed(0)
    kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              ffn_hidden=128, max_seq_len=64, dropout=0.0,
              initializer_range=0.35)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(
        use_flash_attention=False, **kw))
    jm.eval()
    pm = port_gpt.GPTForCausalLM(port_gpt.GPTConfig(**kw), device=CPU)
    params, _ = extract_params(jm)
    load_reference_params(pm, jax.tree_util.tree_map(np.asarray, params))
    return jm, pm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, n)) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def want(twins, prompts):
    jeng = jserve.LLMEngine(twins[0], max_batch=4, block_size=8,
                            num_blocks=32)
    return jeng.generate(prompts, sampling=jserve.SamplingParams(
        max_new_tokens=N_TOKENS))


def _stages(trace):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur_us")}
            for ev in trace]


def _trace_story(serve, model, prompts, kw):
    """add -> route -> exported (failover of replica 0 with the request
    still queued) -> import -> failover -> admit -> prefill -> decode
    ... -> evict -> admit -> prefill (replayed) -> ... -> finished.
    Returns (stage events, trace_id at submit, trace_id at the end)."""
    router = serve.Router(model, replicas=2, max_batch=2, block_size=8,
                          num_blocks=32, heartbeat_timeout_s=60.0, **kw)
    try:
        for rep in router._replicas:
            rep.engine.step = lambda: time.sleep(0.001) or {}
        s = serve.SamplingParams(max_new_tokens=N_TOKENS)
        rid = router.submit(prompts[1], s, req_id="tr")
        tid = router.get_request(rid).trace_id
        assert router._records[rid].replica == 0
        with router._lock:
            router._failover(router._replicas[0], "crash: test")
        eng = router._replicas[1].engine
        del eng.step
        with router._replicas[1].step_lock:
            eng.step()
            eng.step()
            eng.scheduler.evict(eng.get_request(rid))
        router.wait([rid], timeout_s=60)
        req = router.get_request(rid)
        return _stages(req.trace), tid, req.trace_id, list(req.output_ids)
    finally:
        router.shutdown()


def test_trace_stages_through_failover_equal_jax(twins, prompts, want):
    jm, pm = twins
    jst, jtid, jtid2, jout = _trace_story(jserve, jm, prompts, {})
    pst, ptid, ptid2, pout = _trace_story(pserve, pm, prompts,
                                          {"device": CPU})
    assert pst == jst
    assert pout == jout == want[1]
    assert ptid is not None and ptid == ptid2
    stages = [e["stage"] for e in pst]
    for st in ("add", "route", "exported", "import", "failover", "admit",
               "prefill", "decode", "evict", "finished"):
        assert st in stages, st
    assert stages.index("exported") < stages.index("import") < \
        stages.index("failover") < stages.index("evict")
    spool = ptrace.export_requests([], extra=None)
    assert spool["schema"] == "paddle_tpu.trace/1"
    chrome = ptrace.to_chrome([{"rank": 0, "requests": [
        {"req_id": "tr", "trace_id": ptid, "events": [
            {"ts": 1.0, "stage": "add"}, {"ts": 1.5, "stage": "admit"}]}]}])
    spans = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert spans[0]["name"] == "add" and spans[0]["dur"] == 0.5e6


class _StandIn:
    """A router stand-in with only what the Autoscaler touches."""

    def __init__(self, n):
        self._replicas = [None] * n
        self.live = n
        self.calls = []

    def _live(self):
        return [None] * self.live

    def spawn_replica(self):
        self.live += 1
        self._replicas.append(None)
        self.calls.append("spawn")
        return len(self._replicas) - 1

    def retire_replica(self, idx=None):
        if self.live <= 1:
            raise RuntimeError("refusing to retire the last healthy "
                               "replica")
        self.live -= 1
        self.calls.append("retire")
        return self.live


_AUTO_KEYS = ("serve/autoscale/spawns", "serve/autoscale/drains",
              "serve/autoscale/suppressed")


def _scale_story(auto, alerts, mon):
    """The same transitions on one side: returns the actions, the
    describe() dicts and the serve/autoscale/* deltas."""
    before = {k: mon.stat_get(k) for k in _AUTO_KEYS}
    r = _StandIn(1)
    sc = auto.Autoscaler(r, rule="ttft_p99", min_replicas=1,
                         max_replicas=3, cooldown_s=10.0).attach()
    acts = [sc.scale_up(now=100.0),      # spawn -> 2
            sc.scale_up(now=105.0),      # inside the cooldown
            sc.scale_up(now=111.0),      # spawn -> 3
            sc.scale_up(now=125.0),      # at max_replicas
            sc.scale_down(now=119.0),    # inside the cooldown
            sc.scale_down(now=140.0),    # drain -> 2
            sc.scale_down(now=151.0),    # drain -> 1
            sc.scale_down(now=170.0)]    # at min_replicas
    # the listener path: a fired ttft_p99 rule spawns, resolve drains
    alerts.configure(spec="slo_t/auto:threshold:gt=1:name=ttft_p99:clear=1",
                     start=False)
    sc.cooldown_s = 0.0
    mon.stat_set("slo_t/auto", 5)
    alerts.evaluate_once(now=1.0)
    live_after_fire = r.live
    mon.stat_set("slo_t/auto", 0)
    alerts.evaluate_once(now=2.0)
    live_after_resolve = r.live
    desc = sc.describe()
    sc.detach()
    assert not sc.attached()
    alerts.disarm()
    deltas = {k: mon.stat_get(k) - before[k] for k in _AUTO_KEYS}
    return (acts, r.calls, live_after_fire, live_after_resolve, desc,
            deltas, mon.stat_get("serve/autoscale/replicas"))


def test_autoscaler_equals_jax():
    want = _scale_story(jauto, jalerts, jmon)
    got = _scale_story(pauto, palerts, pmon)
    assert got == want
    acts, calls, fired, resolved = got[:4]
    assert acts == [1, None, 2, None, None, 2, 1, None]
    assert (fired, resolved) == (2, 1)
    assert got[5] == {"serve/autoscale/spawns": 3,
                      "serve/autoscale/drains": 3,
                      "serve/autoscale/suppressed": 2}


def test_maybe_autoscale_arming_equals_jax(monkeypatch):
    for env in ({}, {"PADDLE_SERVE_AUTOSCALE": "0"},
                {"PADDLE_SERVE_AUTOSCALE": "1"},
                {"PADDLE_SERVE_AUTOSCALE": "itl_p99",
                 "PADDLE_SERVE_AUTOSCALE_MIN": "2",
                 "PADDLE_SERVE_AUTOSCALE_MAX": "6",
                 "PADDLE_SERVE_AUTOSCALE_COOLDOWN_S": "1.5"}):
        for k in ("PADDLE_SERVE_AUTOSCALE", "PADDLE_SERVE_AUTOSCALE_MIN",
                  "PADDLE_SERVE_AUTOSCALE_MAX",
                  "PADDLE_SERVE_AUTOSCALE_COOLDOWN_S"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        js, ps = (jauto.maybe_autoscale(_StandIn(1)),
                  pauto.maybe_autoscale(_StandIn(1)))
        assert (js is None) == (ps is None)
        if ps is not None:
            assert ps.describe() == js.describe()
            assert ps.attached()
            js.detach()
            ps.detach()


def test_scale_up_on_ttft_and_scale_down_mid_flood(twins, prompts, want):
    """On a real router: a `ttft_p99` rule with `gt` 1 us fires on the
    first flood's TTFTs and the Autoscaler spawns replica 1; a retire
    mid-flood then replays the newest replica's requests with JAX's
    tokens, no leaks."""
    router = pserve.Router(twins[1], replicas=1, max_batch=4,
                           block_size=8, num_blocks=32, device=CPU,
                           heartbeat_timeout_s=60.0)
    scaler = None
    try:
        before = pmon.stat_get("serve/autoscale/spawns")
        rule = palerts.AlertRule("serve/hist/ttft_us", "quantile",
                                 q=0.99, gt=1.0, name="ttft_p99")
        pmon.hist_get("serve/hist/ttft_us").reset()   # earlier traffic
        palerts.configure(rules=[rule], start=False)
        assert palerts.evaluate_once() == []           # no data yet
        scaler = pserve.Autoscaler(router, rule="ttft_p99",
                                   min_replicas=1, max_replicas=2,
                                   cooldown_s=0.0).attach()
        assert router.generate(prompts, sampling=pserve.SamplingParams(
            max_new_tokens=N_TOKENS), timeout_s=60) == want
        evs = palerts.evaluate_once()
        assert [(r.name, ev) for r, ev, _ in evs] == [("ttft_p99", "fire")]
        assert len(router._live()) == 2
        assert pmon.stat_get("serve/autoscale/spawns") == before + 1
        ids = [router.submit(p, pserve.SamplingParams(
            max_new_tokens=N_TOKENS)) for p in prompts]
        assert scaler.scale_down() == 1
        router.wait(ids, timeout_s=60)
        assert [router.get_request(i).output_ids for i in ids] == want
        assert router.check_drained() == {}
    finally:
        if scaler is not None:
            scaler.detach()
        palerts.disarm()
        router.shutdown()
