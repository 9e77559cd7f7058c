"""Serving resilience in the port, held against the JAX package.

Mirrors `tests/test_serving_resilience.py` ring by ring on its model
(vocab 128, hidden 64, 2 layers, 4 heads, max_seq_len 64,
initializer_range 0.35), whose weights the port takes through
`convert.load_reference_params`, and its prompts (lengths 3, 9, 5, 12,
7, 4 from RandomState(3)):

  * the SLO ring: deadlines, load shedding, the eviction victim order;
  * the lifecycle: drain / export / import, fencing, resume,
    `generate(timeout_s=)`, the incident export;
  * the router: clean runs, routing, the spec config, crash and wedge
    failover mid-flood, the last-replica backstop, shed and retry,
    orphans, the env knobs, `abort` under a held step lock;
  * `PagedKVCache.reset_pools` and `defrag`.

Greedy tokens must equal the JAX engine's exactly. Seeded temperature
sampling is held to the port's own fault-free engine (the port does not
reproduce JAX's PRNG). Faults are injected from outside the package: a
test wraps a replica engine's `_decode_batch` (a crash) or
`_dispatch_decode` (a wedge inside the dispatch), where the JAX tests
arm their `serve_decode` chaos site. Every wait has a timeout and every
router is shut down in `finally`.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserve
from paddle_tpu.inference.serving.model_runner import extract_params
from paddle_tpu.text.models import gpt as jax_gpt

from paddle_tpu_torch.convert import load_reference_params
from paddle_tpu_torch.core import monitor as cmon
from paddle_tpu_torch.inference.serving import (EngineOverloaded,
                                                EngineTimeout, LLMEngine,
                                                PagedKVCache, Router,
                                                SamplingParams, Scheduler)
from paddle_tpu_torch.inference.serving.scheduler import (ABORTED, EXPIRED,
                                                          EXPORTED, FINISHED,
                                                          Request, WAITING)
from paddle_tpu_torch.monitor import flight
from paddle_tpu_torch.text.models import gpt as port_gpt

CPU = "cpu"
N_TOKENS = 6
PROMPT_LENS = (3, 9, 5, 12, 7, 4)
ENG = dict(max_batch=4, block_size=8, num_blocks=32, device=CPU)
WAIT_S = 60


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
def model(twins):
    return twins[1]


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, n)) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def want(twins, prompts):
    """The JAX engine's fault-free greedy tokens, which the port's
    single engine also gives."""
    jm, pm = twins
    jeng = jserve.LLMEngine(jm, max_batch=4, block_size=8, num_blocks=32)
    ref = jeng.generate(prompts, sampling=jserve.SamplingParams(
        max_new_tokens=N_TOKENS))
    eng = LLMEngine(pm, **ENG)
    assert eng.generate(prompts, sampling=sp()) == ref
    assert eng.check_drained() == {}
    return ref


def sp(**kw):
    kw.setdefault("max_new_tokens", N_TOKENS)
    return SamplingParams(**kw)


def jsp(**kw):
    kw.setdefault("max_new_tokens", N_TOKENS)
    return jserve.SamplingParams(**kw)


def assert_no_leaks(obj):
    assert obj.check_drained() == {}
    engines = ([r.engine for r in obj._replicas]
               if isinstance(obj, Router) else [obj])
    for eng in engines:
        live = {r.req_id for r in eng._requests.values() if not r.finished}
        owned = {o for o in eng.cache.allocator.owners()
                 if eng.cache.allocator.owned(o)}
        assert owned <= live, owned - live


def crash_after(engines, n):
    """Wrap `_decode_batch` of each engine so that the (n+1)-th call,
    counted over all of them, raises: the worker thread that makes it
    dies, as under JAX's `chaos.inject("serve_decode", "raise",
    after=n, times=1)`. Returns the list the crash appends to."""
    lock, calls, fired = threading.Lock(), [0], []
    for eng in engines:
        real = eng._decode_batch

        def wrapped(emitted, _real=real, _eng=eng):
            with lock:
                calls[0] += 1
                boom = calls[0] == n + 1
            if boom:
                fired.append(_eng)
                raise RuntimeError("injected decode fault")
            return _real(emitted)

        eng._decode_batch = wrapped
    return fired


def stall_after(engines, n, secs):
    """Wrap `_dispatch_decode` so that the (n+1)-th dispatch, counted
    over all engines, sleeps `secs` inside the dispatch before running
    it: a wedge."""
    lock, calls, fired = threading.Lock(), [0], []
    for eng in engines:
        real = eng._dispatch_decode

        def wrapped(arrays, _real=real, _eng=eng):
            with lock:
                calls[0] += 1
                stall = calls[0] == n + 1
            if stall:
                fired.append(_eng)
                time.sleep(secs)
            return _real(arrays)

        eng._dispatch_decode = wrapped
    return fired


def run(eng, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while eng.has_unfinished():
        assert time.monotonic() < deadline, "engine did not drain"
        eng.step()


# ---------------------------------------------------------------------------
# the SLO ring
# ---------------------------------------------------------------------------

def test_expiry_racing_admission(twins, prompts):
    """Expired between add and the next admission pass: EXPIRED before
    it takes a block, on both sides, with the same empty output."""
    jm, pm = twins
    out = []
    for eng, s in ((jserve.LLMEngine(jm, max_batch=2, block_size=8,
                                     num_blocks=32), jsp),
                   (LLMEngine(pm, max_batch=2, block_size=8,
                              num_blocks=32, device=CPU), sp)):
        rid = eng.add_request(prompts[0], s(deadline_s=0.005))
        time.sleep(0.02)
        eng.step()
        req = eng.get_request(rid)
        out.append((req.state, list(req.output_ids)))
    assert out[0] == out[1] == (EXPIRED, [])
    before = cmon.stat_get("serve/deadline_aborts")
    eng = LLMEngine(pm, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    eng.add_request(prompts[0], sp(deadline_s=0.005))
    time.sleep(0.02)
    eng.step()
    assert cmon.stat_get("serve/deadline_aborts") == before + 1
    assert_no_leaks(eng)


def test_expiry_behind_full_batch_and_running_never_killed(model, prompts,
                                                           want):
    eng = LLMEngine(model, max_batch=1, block_size=8, num_blocks=32,
                    device=CPU)
    slow = eng.add_request(prompts[0], sp())
    doomed = eng.add_request(prompts[1], sp(deadline_s=0.01))
    live = eng.add_request(prompts[2], sp())
    time.sleep(0.03)
    run(eng)
    assert eng.get_request(doomed).state == EXPIRED
    assert eng.get_request(slow).output_ids == want[0]
    assert eng.get_request(live).output_ids == want[2]
    assert_no_leaks(eng)
    # running past its deadline still finishes
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    rid = eng.add_request(prompts[0], sp(deadline_s=0.05))
    eng.step()
    time.sleep(0.08)
    run(eng)
    assert eng.get_request(rid).state == FINISHED
    assert eng.get_request(rid).output_ids == want[0]


def test_queue_bound_sheds_and_sweeps_corpses(model, prompts, want):
    eng = LLMEngine(model, max_batch=1, block_size=8, num_blocks=32,
                    max_queue=2, device=CPU)
    eng.add_request(prompts[0], sp())
    eng.step()
    eng.add_request(prompts[1], sp())
    eng.add_request(prompts[2], sp())
    before = cmon.stat_get("serve/shed")
    with pytest.raises(EngineOverloaded, match="load shed"):
        eng.add_request(prompts[3], sp())
    assert cmon.stat_get("serve/shed") == before + 1
    run(eng)
    assert_no_leaks(eng)
    # a queue full of expired entries sweeps them instead of shedding
    eng = LLMEngine(model, max_batch=1, block_size=8, num_blocks=32,
                    max_queue=2, device=CPU)
    eng.add_request(prompts[0], sp())
    eng.step()
    d1 = eng.add_request(prompts[1], sp(deadline_s=0.005))
    d2 = eng.add_request(prompts[2], sp(deadline_s=0.005))
    time.sleep(0.02)
    live = eng.add_request(prompts[3], sp())
    assert eng.get_request(d1).state == EXPIRED
    assert eng.get_request(d2).state == EXPIRED
    run(eng)
    assert eng.get_request(live).output_ids == want[3]
    assert_no_leaks(eng)


def test_env_max_queue(monkeypatch):
    from paddle_tpu_torch.inference.serving import env_max_queue

    for val in ("7", "bogus", "-3"):
        monkeypatch.setenv("PADDLE_SERVE_MAX_QUEUE", val)
        assert env_max_queue() == jserve.env_max_queue()
    monkeypatch.setenv("PADDLE_SERVE_MAX_QUEUE", "4")
    eng_sched = Scheduler(PagedKVCache(2, 4, 16, block_size=4,
                                       num_blocks=64, device=CPU), 4, 64)
    assert eng_sched.max_queue == 4


# the running set of the victim-order test: (priority, deadline_s),
# admitted in this order
VICTIMS = [(0, None), (5, None), (-1, 50.0), (-1, 5.0), (0, 20.0),
           (0, 2.0), (5, 1.0), (-1, None)]


def _victim_order(sched_cls, req_cls, params_cls, pick=None):
    cache_cls = (PagedKVCache if sched_cls is Scheduler
                 else jserve.PagedKVCache)
    kw = dict(device=CPU) if cache_cls is PagedKVCache else {}
    cache = cache_cls(2, 4, 16, block_size=4, num_blocks=64, **kw)
    s = sched_cls(cache, max_batch=len(VICTIMS), max_seq_len=64)
    reqs = []
    for i, (prio, dl) in enumerate(VICTIMS):
        r = req_cls([1] * 4, params_cls(max_new_tokens=4, priority=prio,
                                        deadline_s=dl), req_id=f"v{i}")
        s.add(r)
        reqs.append(r)
    s.schedule()
    assert len(s.running) == len(VICTIMS)
    order = []
    while s.running:
        v = (pick or s._pick_victim)()
        order.append(v.req_id)
        s.evict(v)
    return order


def test_victim_order_equals_jax():
    """For one running set, the victims in turn (lowest priority, then
    the latest deadline, then the youngest) equal JAX's."""
    want = _victim_order(jserve.Scheduler, jserve.Request,
                         jserve.SamplingParams)
    got = _victim_order(Scheduler, Request, SamplingParams)
    assert got == want
    assert want[:3] == ["v7", "v2", "v3"]


def test_negative_control_reversed_deadline_tiebreak():
    """The gate can fail: a pick with the deadline tiebreak reversed
    (earliest deadline loses) differs from JAX's order."""
    import math

    want = _victim_order(jserve.Scheduler, jserve.Request,
                         jserve.SamplingParams)
    holder = {}

    class Reversed(Scheduler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            holder["s"] = self

    def pick():
        s = holder["s"]
        cands = list(s.running.values())
        return max(cands, key=lambda r: (
            -r.priority,
            -(r.deadline if r.deadline is not None else math.inf),
            s._admitted_at.get(r.req_id, -1)))

    got = _victim_order(Reversed, Request, SamplingParams,
                        pick=lambda: pick())
    assert got != want


# ---------------------------------------------------------------------------
# the lifecycle
# ---------------------------------------------------------------------------

def _norm_export(e):
    """An export dict without what differs by construction: trace
    timestamps and durations, the trace id (minted per process) and the
    sampling object's class."""
    out = dict(e)
    out["sampling"] = {k: v for k, v in vars(e["sampling"]).items()}
    out["trace_id"] = e["trace_id"] is not None
    out["trace"] = [{k: v for k, v in ev.items() if k not in ("ts",
                                                              "dur_us")}
                    for ev in e.get("trace", [])]
    return out


def test_drain_completes_running_exports_waiting(twins, prompts, want):
    """drain(): the RUNNING requests finish, the WAITING ones export; the
    export dicts equal JAX's (trace timestamps aside), and imports on a
    second engine continue token-identically."""
    jm, pm = twins
    sides = []
    for eng, s in ((jserve.LLMEngine(jm, max_batch=2, block_size=8,
                                     num_blocks=32), jsp),
                   (LLMEngine(pm, max_batch=2, block_size=8,
                              num_blocks=32, device=CPU), sp)):
        ids = [eng.add_request(p, s(), req_id=f"d{i}")
               for i, p in enumerate(prompts[:4])]
        eng.step()
        exports = eng.drain()
        sides.append((eng, ids, exports))
    (jeng, _, jexp), (eng, ids, exports) = sides
    assert [_norm_export(e) for e in exports] == \
        [_norm_export(e) for e in jexp]
    assert [e["req_id"] for e in exports] == ids[2:]
    assert_no_leaks(eng)
    for i in ids[:2]:
        assert eng.get_request(i).output_ids == want[int(i[1:])]
    with pytest.raises(EngineOverloaded, match="draining"):
        eng.add_request(prompts[0], sp())
    eng2 = LLMEngine(pm, max_batch=2, block_size=8, num_blocks=32,
                     device=CPU)
    for e in exports:
        eng2.import_request(e)
    run(eng2)
    assert [eng2.get_request(i).output_ids for i in ids[2:]] == want[2:4]
    assert_no_leaks(eng2)


def test_drain_timeout_exports_running_then_resume(model, prompts, want):
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    ids = [eng.add_request(p, sp()) for p in prompts[:2]]
    eng.step()
    exports = eng.drain(timeout_s=0)
    assert [e["req_id"] for e in exports] == ids
    assert all(len(e["output_ids"]) >= 1 for e in exports)
    assert_no_leaks(eng)
    eng2 = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                     device=CPU)
    for e in exports:
        eng2.import_request(e)
    run(eng2)
    assert [eng2.get_request(i).output_ids for i in ids] == want[:2]
    # resume re-opens admission
    eng.resume()
    assert eng.generate(prompts[:2], sampling=sp()) == want[:2]
    assert_no_leaks(eng)


def test_fenced_mid_drain_returns_emergency_exports(model, prompts, want):
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    ids = [eng.add_request(p, sp()) for p in prompts[:2]]
    eng.step()
    eng._incident_export("watchdog")
    exports = eng.drain(timeout_s=1)
    assert [e["req_id"] for e in exports] == ids
    assert eng.emergency_exports is None
    assert_no_leaks(eng)
    eng2 = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                     device=CPU)
    for e in exports:
        eng2.import_request(e)
    run(eng2)
    assert [eng2.get_request(i).output_ids for i in ids] == want[:2]
    with pytest.raises(RuntimeError, match="fenced"):
        eng.resume()


def test_fenced_engine_refuses_intake(model, prompts):
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    rid = eng.add_request(prompts[0], sp())
    eng.step()
    exports = eng.export_requests(fence=True)
    assert [e["req_id"] for e in exports] == [rid]
    assert eng.get_request(rid).state == EXPORTED
    with pytest.raises(EngineOverloaded, match="fenced"):
        eng.add_request(prompts[1], sp())
    with pytest.raises(EngineOverloaded, match="fenced"):
        eng.import_request(exports[0], force=True)
    assert eng.step() == {}
    assert_no_leaks(eng)


def test_negative_control_import_without_force_sheds(model, prompts):
    """A failover that imports WITHOUT force onto a draining survivor is
    shed; with force it lands."""
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    eng.add_request(prompts[0], sp(), req_id="x")
    exports = eng.export_requests(fence=True)
    survivor = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                         device=CPU)
    survivor.drain()
    with pytest.raises(EngineOverloaded, match="draining"):
        survivor.import_request(exports[0])
    survivor.import_request(exports[0], force=True)
    assert survivor.get_request("x").state == WAITING


def test_import_keeps_deadline_and_evictions(model, prompts):
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    rid = eng.add_request(prompts[0], sp(deadline_s=30.0))
    eng.step()
    req = eng.get_request(rid)
    req.evictions = 2
    exports = eng.export_requests()
    eng2 = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                     device=CPU)
    eng2.import_request(exports[0])
    r2 = eng2.get_request(rid)
    assert r2.deadline == req.deadline and r2.evictions == 2
    assert r2.output_ids == req.output_ids
    assert r2.trace_id == req.trace_id
    for st in (EXPIRED, EXPORTED, ABORTED):
        r = Request([1, 2], sp())
        r.state = st
        assert r.finished


def test_generate_timeout(model, prompts, want):
    eng = LLMEngine(model, max_batch=1, block_size=8, num_blocks=32,
                    device=CPU)
    with pytest.raises(EngineTimeout) as ei:
        eng.generate(prompts[:3], sampling=sp(max_new_tokens=48),
                     timeout_s=1e-4)
    state = ei.value.engine_state
    assert state["running"] + state["waiting"] >= 1
    assert {"heartbeat_age_s", "free_blocks", "draining",
            "fenced"} <= set(state)
    for r in list(eng._requests.values()):
        if not r.finished:
            eng.abort_request(r.req_id)
    assert_no_leaks(eng)
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU)
    assert eng.generate(prompts[:2], sampling=sp(),
                        timeout_s=WAIT_S) == want[:2]


def test_incident_export_replays_token_exact(model, prompts, want):
    eng = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                    device=CPU).arm_incident_export()
    idle = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                     device=CPU).arm_incident_export()
    try:
        ids = [eng.add_request(p, sp()) for p in prompts[:2]]
        eng.step()
        flight._run_incident_hooks("watchdog")
        assert eng.fenced and eng.step() == {}
        assert not idle.fenced and idle.emergency_exports is None
        exports = eng.emergency_exports
        assert [e["req_id"] for e in exports] == ids
        assert_no_leaks(eng)
        eng2 = LLMEngine(model, max_batch=2, block_size=8, num_blocks=32,
                         device=CPU)
        for e in exports:
            eng2.import_request(e)
        run(eng2)
        assert [eng2.get_request(i).output_ids for i in ids] == want[:2]
    finally:
        eng.disarm_incident_export()
        idle.disarm_incident_export()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def test_router_clean_two_replicas(model, prompts, want):
    router = Router(model, replicas=2, heartbeat_timeout_s=60.0, **ENG)
    try:
        assert router.generate(prompts, sampling=sp(),
                               timeout_s=WAIT_S) == want
        assert_no_leaks(router)
        assert all(router.replica_healthy(i) for i in range(2))
        assert all(r.engine.device == torch.device("cpu")
                   for r in router._replicas)
    finally:
        router.shutdown()


def _routes(router, prompts, s):
    """The replica of each submit with the workers held off the engines
    (step a no-op), so the choice reads queued demand only."""
    for rep in router._replicas:
        rep.engine.step = lambda: time.sleep(0.001) or {}
    ids = [router.submit(p, s()) for p in prompts]
    routes = [router._records[i].replica for i in ids]
    for rep in router._replicas:
        del rep.engine.step
    return ids, routes


def test_router_routing_equals_jax(twins, prompts, want):
    """Least-loaded by load_score, lowest index on ties: the replica of
    each submit equals the JAX Router's for the same sequence."""
    jm, pm = twins
    seq = [prompts[i] for i in (3, 0, 1, 2, 5, 4)]
    jr = jserve.Router(jm, replicas=2, max_batch=4, block_size=8,
                       num_blocks=32, heartbeat_timeout_s=60.0)
    try:
        jids, jroutes = _routes(jr, seq, jsp)
        jr.wait(jids, timeout_s=120)
    finally:
        jr.shutdown()
    router = Router(pm, replicas=2, heartbeat_timeout_s=60.0, **ENG)
    try:
        ids, routes = _routes(router, seq, sp)
        assert routes == jroutes
        assert len(set(routes)) == 2
        router.wait(ids, timeout_s=WAIT_S)
        assert [router.get_request(i).output_ids for i in ids] == \
            [want[i] for i in (3, 0, 1, 2, 5, 4)]
        assert_no_leaks(router)
    finally:
        router.shutdown()


def test_router_negotiates_spec_config(model, prompts, want):
    router = Router(model, replicas=2, heartbeat_timeout_s=60.0,
                    spec_k=4, prefix_cache=True, **ENG)
    try:
        s = router.state_summary()
        assert s["spec_k"] == 4 and s["prefix_cache"] is True
        assert {e["spec_k"] for e in s["engines"]} == {4}
        assert cmon.stat_get("serve/spec/fleet_k") == 4
        assert router.generate(prompts, sampling=sp(),
                               timeout_s=WAIT_S) == want
        assert_no_leaks(router)
    finally:
        router.shutdown()


def test_router_crash_mid_flood(model, prompts, want):
    """The acceptance gate: a replica's worker dies after 3 decode
    dispatches over the fleet; every request completes with JAX's
    fault-free tokens, no leaks on either replica, gauges [0, 1], and
    the survivor keeps serving."""
    router = Router(model, replicas=2, heartbeat_timeout_s=60.0, **ENG)
    try:
        before = cmon.stat_get("serve/failovers")
        fired = crash_after([r.engine for r in router._replicas], 3)
        outs = router.generate(prompts, sampling=sp(), timeout_s=WAIT_S)
        assert len(fired) == 1
        assert outs == want
        assert cmon.stat_get("serve/failovers") == before + 1
        assert_no_leaks(router)
        assert sorted(cmon.stat_get(f"serve/replica/{i}/healthy")
                      for i in range(2)) == [0, 1]
        assert router.generate(prompts[:2], sampling=sp(),
                               timeout_s=WAIT_S) == want[:2]
    finally:
        router.shutdown()


def test_negative_control_replay_drops_an_export(model, prompts, want):
    """A `_replay` that drops one export fails the gate: the dropped
    request stays EXPORTED on the dead replica (it never finishes) and
    the tokens differ from JAX's."""
    router = Router(model, replicas=2, heartbeat_timeout_s=60.0, **ENG)
    real = router._replay

    def lossy(exports, rep, reason):
        return real(exports[1:], rep, reason)

    router._replay = lossy
    try:
        fired = crash_after([r.engine for r in router._replicas], 3)
        ids = [router.submit(p, sp()) for p in prompts]
        router.wait(ids, timeout_s=WAIT_S)
        assert len(fired) == 1
        states = [router.get_request(i).state for i in ids]
        assert states.count(EXPORTED) == 1
        assert not all(st == FINISHED for st in states)
        assert [router.get_request(i).output_ids for i in ids] != want
    finally:
        router.shutdown()


def test_router_seeded_sampling_survives_failover(model, prompts):
    sampling = sp(temperature=0.8, top_k=20, seed=11)
    ref = LLMEngine(model, **ENG).generate(prompts[:4], sampling=sampling)
    router = Router(model, replicas=2, heartbeat_timeout_s=60.0,
                    max_batch=2, block_size=8, num_blocks=32, device=CPU)
    try:
        fired = crash_after([r.engine for r in router._replicas], 2)
        outs = router.generate(prompts[:4], sampling=sampling,
                               timeout_s=WAIT_S)
        assert len(fired) == 1
        assert outs == ref
        assert_no_leaks(router)
    finally:
        router.shutdown()


def test_router_wedge_failover_via_heartbeat(model, prompts, want):
    """A replica asleep inside a dispatch stops its heartbeat: after
    0.5 s the router fails it over; the zombie's late wake-up emits
    nothing into the replayed requests."""
    router = Router(model, replicas=2, heartbeat_timeout_s=0.5,
                    max_batch=2, block_size=8, num_blocks=32, device=CPU)
    try:
        assert router.generate(prompts, sampling=sp(),
                               timeout_s=WAIT_S) == want
        before = cmon.stat_get("serve/failovers")
        fired = stall_after([r.engine for r in router._replicas], 2, 2.0)
        outs = router.generate(prompts, sampling=sp(), timeout_s=WAIT_S)
        assert len(fired) == 1 and outs == want
        assert cmon.stat_get("serve/failovers") == before + 1
        zombie = fired[0]
        assert zombie.fenced
        time.sleep(2.2)              # let the zombie wake
        assert all(len(r.output_ids) <= N_TOKENS
                   for r in zombie._requests.values())
        assert_no_leaks(router)
    finally:
        router.shutdown()


def test_heartbeat_never_retires_last_replica(model, prompts, want):
    router = Router(model, replicas=1, heartbeat_timeout_s=0.2,
                    max_batch=2, block_size=8, num_blocks=32, device=CPU)
    try:
        before = cmon.stat_get("serve/failovers")
        stall_after([router._replicas[0].engine], 1, 1.0)
        outs = router.generate(prompts[:2], sampling=sp(),
                               timeout_s=WAIT_S)
        assert outs == want[:2]
        assert cmon.stat_get("serve/failovers") == before
        assert router.replica_healthy(0)
        assert_no_leaks(router)
    finally:
        router.shutdown()


def test_shed_then_retry_on_drained_router(model, prompts, want):
    router = Router(model, replicas=2, heartbeat_timeout_s=60.0,
                    max_batch=2, block_size=8, num_blocks=32, device=CPU)
    try:
        rid = router.submit(prompts[0], sp())
        t0 = time.monotonic()
        while not router.get_request(rid).output_ids \
                and time.monotonic() - t0 < WAIT_S:
            time.sleep(0.005)
        assert router.drain(timeout_s=WAIT_S) == []
        assert router.get_request(rid).output_ids == want[0]
        before = cmon.stat_get("serve/shed")
        with pytest.raises(EngineOverloaded) as ei:
            router.submit(prompts[1], sp())
        assert cmon.stat_get("serve/shed") == before + 2
        assert ei.value.engine_state["healthy"] == 2
        router.resume()
        assert router.generate(prompts[:2], sampling=sp(),
                               timeout_s=WAIT_S) == want[:2]
        assert router.check_drained() == {}
    finally:
        router.shutdown()


def test_all_replicas_dead_retains_orphans(model, prompts):
    router = Router(model, replicas=1, heartbeat_timeout_s=60.0,
                    max_batch=2, block_size=8, num_blocks=32, device=CPU)
    try:
        crash_after([router._replicas[0].engine], 1)
        ids = [router.submit(p, sp(max_new_tokens=24))
               for p in prompts[:2]]
        with pytest.raises(RuntimeError, match="no healthy"):
            router.wait(ids, timeout_s=WAIT_S)
        assert {e["req_id"] for e in router.orphan_exports} == set(ids)
        assert_no_leaks(router)
    finally:
        router.shutdown()


def test_router_env_knobs(monkeypatch):
    from paddle_tpu_torch.inference.serving import (env_heartbeat_s,
                                                    env_replicas)

    for rep, hb in (("3", "2.5"), ("junk", "junk"), ("0", "0.01")):
        monkeypatch.setenv("PADDLE_SERVE_REPLICAS", rep)
        monkeypatch.setenv("PADDLE_SERVE_HEARTBEAT_S", hb)
        assert env_replicas() == jserve.env_replicas()
        assert env_heartbeat_s() == jserve.env_heartbeat_s()


def test_router_abort_backs_off_while_step_lock_held(model, prompts):
    router = Router(model, replicas=1, heartbeat_timeout_s=60.0,
                    max_batch=2, block_size=8, num_blocks=32, device=CPU)
    try:
        rid = router.submit(prompts[0], sp(max_new_tokens=48))
        rep = router._replicas[0]
        assert rep.step_lock.acquire(timeout=10)
        try:
            with pytest.raises(EngineOverloaded, match="busy"):
                router.abort(rid)
        finally:
            rep.step_lock.release()
        deadline = time.monotonic() + WAIT_S
        while not router.get_request(rid).finished:
            try:
                router.abort(rid)
            except EngineOverloaded:
                assert time.monotonic() < deadline
                time.sleep(0.02)
        assert_no_leaks(router)
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# reset_pools and defrag
# ---------------------------------------------------------------------------

def _alloc_script(alloc):
    """One alloc / share / release sequence, the same on both sides."""
    alloc.alloc("r1", 3)
    alloc.alloc("r2", 2)
    alloc.alloc("r3", 4)
    alloc.release("r1")
    alloc.alloc("r4", 2)
    alloc.share("r5", alloc.owned("r3")[0])
    alloc.register_hash(alloc.owned("r3")[0], b"h0")
    alloc.release("r2")


def test_defrag_equals_jax_permutation():
    import jax.numpy as jnp

    geo = (2, 2, 4)
    rng = np.random.RandomState(0)
    k = rng.randn(2, 16, 4, 2, 4).astype(np.float32)
    v = rng.randn(2, 16, 4, 2, 4).astype(np.float32)
    jc = jserve.PagedKVCache(*geo, block_size=4, num_blocks=16)
    pc = PagedKVCache(*geo, block_size=4, num_blocks=16, device=CPU)
    jc.k, jc.v = jnp.asarray(k), jnp.asarray(v)
    pc.k, pc.v = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    _alloc_script(jc.allocator)
    _alloc_script(pc.allocator)
    assert pc.defrag() == jc.defrag() > 0
    np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(pc.v.numpy(), np.asarray(jc.v))
    ja, pa = jc.allocator, pc.allocator
    assert pa._owned == ja._owned and pa._refcnt == ja._refcnt
    assert pa._by_hash == ja._by_hash and list(pa._free) == list(ja._free)
    assert pc.defrag() == 0
    pc.reset_pools()
    assert not pc.k.any() and pa.lookup_hash(b"h0") is None


def test_defrag_and_reset_keep_tokens(model, prompts, want):
    """A defrag between decode steps keeps every table pointing at its
    K/V: the tokens equal the run without one. A reset mid-flight with
    every running request evicted re-prefills to the same tokens."""
    eng = LLMEngine(model, max_batch=3, block_size=8, num_blocks=32,
                    device=CPU)
    ids = [eng.add_request(p, sp()) for p in prompts]
    eng.step()
    eng.abort_request(ids[0])
    eng.add_request(prompts[0], sp(), req_id="again")
    eng.step()
    tables = {r: eng.cache.allocator.owned(r)
              for r in eng.cache.allocator.owners()}
    assert eng.cache.defrag() > 0
    assert {r: len(b) for r, b in tables.items()} == {
        r: len(eng.cache.allocator.owned(r)) for r in tables}
    eng.step()
    for req in list(eng.scheduler.running.values()):
        eng.scheduler.evict(req)
    eng.cache.reset_pools()
    run(eng)
    got = [eng.get_request(i).output_ids for i in ids[1:]]
    assert got == want[1:]
    assert eng.get_request("again").output_ids == want[0]
    assert_no_leaks(eng)


def test_launch_counts_from_many_threads():
    """Several replicas' workers launch kernels at once: `count` takes a
    lock, so 8 threads x 10,000 counts read 80,000."""
    from paddle_tpu_torch.incubate.nn import kernels

    saved = kernels.launches()
    kernels.reset_launches()
    try:
        barrier = threading.Barrier(8)

        def hammer():
            barrier.wait()
            for _ in range(10_000):
                kernels.count("paged_attention")

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert kernels.launches()["paged_attention"] == 80_000
    finally:
        kernels.reset_launches()
        for name, n in saved.items():
            for _ in range(n):
                kernels.count(name)
