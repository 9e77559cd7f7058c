"""The port's chaos plane (`paddle_tpu_torch.monitor.chaos`) held against
the JAX package's `paddle_tpu.monitor.chaos`: the same spec parses to
the same rules, and the same spec with the same sequence of `hit()`
calls triggers the same calls, decision for decision (p, after, every,
times, the default seed at ranks 0 and 1); then each ported injection
site fires with the JAX package's outcome."""
import errno
import os

import numpy as np
import pytest
import torch

from paddle_tpu.core import monitor as jax_cmon
from paddle_tpu.monitor import chaos as jchaos

from paddle_tpu_torch.core import monitor as cmon
from paddle_tpu_torch.monitor import chaos, flight, memory

SPECS = [
    "collective:delay:ms=0:p=0.3:seed=7",
    "collective:delay:ms=0:p=0.5",
    "ckpt_write:delay:ms=0:after=3:every=2",
    "io_fetch:delay:ms=0:every=3:times=4",
    "serve_decode:delay:ms=0:p=0.25:after=2:every=2:times=5",
    "dispatch:delay:ms=0:p=0.7;dispatch:delay:ms=0:p=0.2:seed=3",
]


@pytest.fixture(autouse=True)
def _disarmed():
    chaos.disarm()
    jchaos.disarm()
    yield
    chaos.disarm()
    jchaos.disarm()


def _sequence(mod, stats, site, spec, n):
    """Per-call cumulative trigger counts of every rule of `spec`."""
    rules = mod.configure(spec)
    out = []
    for _ in range(n):
        mod.hit(site)
        out.append(tuple(r.triggers for r in rules))
    keys = sorted({f"chaos/{r.site}/{r.fault}/triggered" for r in rules})
    return out, [stats.stat_get(k) for k in keys]


@pytest.mark.parametrize("rank", ["0", "1"])
@pytest.mark.parametrize("spec", SPECS)
def test_decision_sequence_matches_jax(spec, rank, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", rank)
    site = spec.split(":", 1)[0]
    jax_cmon.registry.reset_all()
    cmon.registry.reset_all()
    want, want_ctr = _sequence(jchaos, jax_cmon, site, spec, 200)
    got, got_ctr = _sequence(chaos, cmon, site, spec, 200)
    assert got == want
    assert got_ctr == want_ctr
    assert any(t for row in got for t in row)  # the spec does fire


@pytest.mark.parametrize("rank", ["0", "1"])
def test_default_seed_matches_jax(rank, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", rank)
    for site, fault in (("collective", "delay"), ("ckpt_write", "torn"),
                        ("serve_spec_verify", "corrupt")):
        assert chaos.Rule(site, fault).seed == jchaos.Rule(site,
                                                           fault).seed


@pytest.mark.parametrize("spec", [
    "collective:stall:secs=2:p=0.5:seed=9",
    "ckpt_write:enospc:after=3;io_fetch:raise:exc=OSError:msg=boom",
    "serve_decode:hang:times=2",
    "serve_route:raise:exc=ConnectionError",
    "comm_compress:bitflip:every=4",
    "serve_admit:delay:ms=250:every=2:times=3",
])
def test_parse_spec_matches_jax(spec):
    got = [r.describe() for r in chaos.parse_spec(spec)]
    want = [r.describe() for r in jchaos.parse_spec(spec)]
    assert got == want


@pytest.mark.parametrize("spec", [
    "nosuch:raise", "collective:nosuch", "collective:raise:bogus=1",
    "collective", "collective:raise:p=2", "collective:torn",
    "collective:raise:exc=KeyError", "collective:raise:times=x",
])
def test_bad_specs_refused_like_jax(spec):
    with pytest.raises(ValueError):
        jchaos.parse_spec(spec)
    with pytest.raises(ValueError):
        chaos.parse_spec(spec)


def test_waiting_sites_are_named_and_refused():
    for site in chaos.WAITING:
        assert site in jchaos.SITES
        with pytest.raises(ValueError, match="not ported"):
            chaos.parse_spec(f"{site}:raise")


def test_raising_faults_match_jax():
    for fault, jtype, ptype in (("raise", jchaos.ChaosInjected,
                                 chaos.ChaosInjected),
                                ("enospc", OSError, OSError),
                                ("bad_sample", jchaos.ChaosBadSample,
                                 chaos.ChaosBadSample),
                                ("crash", jchaos.ChaosInjected,
                                 chaos.ChaosInjected)):
        with jchaos.inject("collective", fault):
            with pytest.raises(jtype) as je:
                jchaos.hit("collective")
        with chaos.inject("collective", fault):
            with pytest.raises(ptype) as pe:
                chaos.hit("collective")
        assert str(pe.value) == str(je.value)
        assert getattr(pe.value, "_paddle_chaos_fault", False) == \
            getattr(je.value, "_paddle_chaos_fault", False)
        if fault == "enospc":
            assert pe.value.errno == je.value.errno == errno.ENOSPC


def test_resource_exhausted_is_torch_oom_with_jax_message():
    """The port's form: torch.OutOfMemoryError carrying the JAX
    package's RESOURCE_EXHAUSTED message; both packages' is_oom_error
    classify their own."""
    from paddle_tpu.monitor import memory as jmemory

    with jchaos.inject("dispatch", "resource_exhausted"):
        with pytest.raises(jchaos.XlaRuntimeError) as je:
            jchaos.hit("dispatch")
    with chaos.inject("dispatch", "resource_exhausted"):
        with pytest.raises(torch.OutOfMemoryError) as pe:
            chaos.hit("dispatch")
    assert str(pe.value) == str(je.value)
    assert jmemory.is_oom_error(je.value)
    assert memory.is_oom_error(pe.value)
    assert memory.is_oom_error(je.value)


def test_arming_counters_and_events():
    before = cmon.stat_get("chaos/collective/delay/armed")
    chaos.configure("collective:delay:ms=0;io_fetch:delay:ms=0")
    assert chaos.active() and cmon.stat_get("chaos/armed") == 2
    assert cmon.stat_get("chaos/collective/delay/armed") == before + 1
    assert flight.tail(1)[0]["kind"] == "chaos_arm"
    chaos.hit("collective", op="x")
    ev = flight.tail(1)[0]
    assert ev["kind"] == "chaos_inject" and ev["site"] == "collective" \
        and ev["n"] == 1 and ev["op"] == "x"
    chaos.disarm()
    assert not chaos.active() and cmon.stat_get("chaos/armed") == 0
    assert chaos.hit("collective") is None


def test_inject_composes_and_unwinds():
    chaos.configure("collective:delay:ms=0")
    with chaos.inject("io_fetch", "delay", ms=0) as rule:
        assert len(chaos.rules()) == 2
        chaos.hit("io_fetch")
        assert rule.calls == 1 and rule.triggers == 1
    assert [r.site for r in chaos.rules()] == ["collective"]
    assert chaos.active()


# -- the ported sites ---------------------------------------------------

def _tiny_gpt():
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    return GPTForCausalLM(GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
        ffn_hidden=64, max_seq_len=32, dropout=0.0), device="cpu",
        generator=torch.Generator().manual_seed(0))


def _engine(model, max_batch=2, **kw):
    from paddle_tpu_torch.inference.serving import LLMEngine

    return LLMEngine(model, max_batch=max_batch, block_size=8,
                     num_blocks=32, device="cpu", **kw)


def test_ckpt_write_torn_falls_back(tmp_path):
    from paddle_tpu_torch.incubate.checkpoint.elastic import (
        CheckpointManager)

    mgr = CheckpointManager(dir=str(tmp_path), async_write=False,
                            device="cpu")
    a, b = torch.arange(6.0), torch.arange(6.0) * 2
    with chaos.inject("ckpt_write", "torn", after=1, times=1) as rule:
        mgr.save({"w": a}, global_step=1)
        mgr.save({"w": b}, global_step=2)      # torn: half a file
    assert rule.triggers == 1
    assert os.path.exists(tmp_path / "step_2" / "state_rank0.pd")
    assert not os.path.exists(tmp_path / "step_2" / "manifest.json")
    kinds = [e["kind"] for e in flight.tail(20)]
    assert "chaos_inject" in kinds and "ckpt_error" in kinds
    got = CheckpointManager(dir=str(tmp_path), device="cpu")
    state = got.restore()
    assert got.cursor["global_step"] == 1
    assert torch.equal(state["w"], a)


def test_ckpt_write_enospc_counts_an_error(tmp_path):
    from paddle_tpu_torch.incubate.checkpoint.elastic import (
        CheckpointManager)

    mgr = CheckpointManager(dir=str(tmp_path), async_write=False,
                            device="cpu")
    before = cmon.stat_get("ckpt/errors")
    with chaos.inject("ckpt_write", "enospc"):
        mgr.save({"w": torch.ones(3)}, global_step=1)
    assert cmon.stat_get("ckpt/errors") == before + 1
    err = [e for e in flight.tail(20) if e["kind"] == "ckpt_error"][-1]
    assert "No space left" in err["error"] or "no space" in err["error"]


def test_dispatch_resource_exhausted_raises_torch_oom():
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD

    net = torch.nn.Linear(4, 1)
    step = TrainStepCompiler(net, SGD(0.1, parameters=net.parameters()),
                             lambda o, y: ((o - y) ** 2).mean())
    x, y = torch.ones(2, 4), torch.zeros(2, 1)
    with chaos.inject("dispatch", "resource_exhausted", times=1):
        with pytest.raises(torch.OutOfMemoryError):
            step(x, y)
        step(x, y)
    assert step._step == 1


def test_serve_admit_fault_leaves_queue_intact():
    from paddle_tpu_torch.inference.serving import SamplingParams

    eng = _engine(_tiny_gpt())
    eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=3))
    with chaos.inject("serve_admit", "raise", times=1) as rule:
        with pytest.raises(chaos.ChaosInjected):
            eng.step()
        assert rule.triggers == 1
        assert eng.cache.allocator.used_blocks == 0
        while eng.has_unfinished():
            eng.step()
    assert eng.check_drained() == {}


def test_serve_admit_delay_sheds_under_the_deadline():
    """A slow client (delay at admission) past the queue deadline is
    shed, as in the JAX scheduler: the same deadline, the same shed."""
    from paddle_tpu.inference.serving import SamplingParams as JSampling
    from paddle_tpu_torch.inference.serving import SamplingParams

    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import LLMEngine as JEngine
    from paddle_tpu.text.models import gpt as jgpt

    def run(make, sp, mod):
        eng = make()
        with mod.inject("serve_admit", "delay", ms=30, times=1):
            a = eng.add_request([1, 2, 3], sp)
            b = eng.add_request([4, 5], sp)
            while eng.has_unfinished():
                eng.step()
        return [eng.get_request(i).state for i in (a, b)]

    os.environ["PADDLE_SERVE_DEADLINE_S"] = "0.01"
    try:
        paddle.seed(0)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            ffn_hidden=64, max_seq_len=32, dropout=0.0))
        want = run(lambda: JEngine(jm, max_batch=1, block_size=8,
                                   num_blocks=32),
                   JSampling(max_new_tokens=2), jchaos)
        got = run(lambda: _engine(_tiny_gpt(), max_batch=1),
                  SamplingParams(max_new_tokens=2), chaos)
    finally:
        os.environ.pop("PADDLE_SERVE_DEADLINE_S")
    assert [str(s) for s in got] == [str(s) for s in want]


def test_serve_decode_resource_exhausted_evicts_then_escalates():
    from paddle_tpu_torch.inference.serving import SamplingParams

    model = _tiny_gpt()
    sp = SamplingParams(max_new_tokens=6)
    want = _engine(model).generate([[4, 5, 6], [7, 8]], sampling=sp)
    eng = _engine(model)
    ids = [eng.add_request(p, sp) for p in ([4, 5, 6], [7, 8])]
    before = cmon.stat_get("serve/oom_evictions")
    with chaos.inject("serve_decode", "resource_exhausted", after=1,
                      times=1):
        while eng.has_unfinished():
            eng.step()
    assert cmon.stat_get("serve/oom_evictions") == before + 1
    assert [eng.get_request(i).output_ids for i in ids] == want
    eng = _engine(model)
    eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=8))
    with chaos.inject("serve_decode", "resource_exhausted"):
        with pytest.raises(torch.OutOfMemoryError):
            for _ in range(50):
                eng.step()
    assert eng.check_drained() == {}


def test_serve_spec_verify_corrupt_accepts_nothing_same_tokens():
    from paddle_tpu_torch.inference.serving import SamplingParams

    model = _tiny_gpt()
    sp = SamplingParams(max_new_tokens=6)
    prompts = [[4, 5, 6], [7, 8]]
    want = _engine(model).generate(prompts, sampling=sp)
    eng = _engine(model, spec_k=4, draft_layers=2)
    acc = cmon.stat_get("serve/spec/accepted")
    with chaos.inject("serve_spec_verify", "corrupt") as rule:
        got = eng.generate(prompts, sampling=sp)
    assert got == want
    assert rule.triggers > 0
    assert cmon.stat_get("serve/spec/accepted") == acc


def test_watchdog_incident_fences_only_the_stuck_engine(tmp_path,
                                                       monkeypatch):
    """A watchdog fire hands the hooks its stuck entries: the engine
    whose decode is stalled fences and exports, an armed engine with
    live work on another thread keeps serving."""
    import threading

    from paddle_tpu_torch.inference.serving import SamplingParams

    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    model = _tiny_gpt()
    sp = SamplingParams(max_new_tokens=4)
    stuck = _engine(model).arm_incident_export()
    busy = _engine(model).arm_incident_export()
    wd = flight.Watchdog(timeout_s=0.3, poll_s=0.05)
    try:
        stuck.add_request([4, 5, 6], sp)
        busy.add_request([7, 8], sp)
        busy.step()
        with chaos.inject("serve_decode", "stall", secs=1.5, after=1,
                          times=1):
            stuck.step()                     # prefill
            t = threading.Thread(target=stuck.step)   # the stalled decode
            t.start()
            wd.start()
            t.join(10)
        assert wd.fired == 1
        assert stuck.fenced and len(stuck.emergency_exports) == 1
        assert not busy.fenced and busy.emergency_exports is None
        assert busy.step() != {}
    finally:
        wd.stop()
        stuck.disarm_incident_export()
        busy.disarm_incident_export()


def test_router_stall_fails_over_through_the_default_incident_export(
        tmp_path, monkeypatch):
    """The Router's default (incident_export=True) under a stalled
    decode: the watchdog fences the stalled replica alone, one
    failover replays its requests on the survivor, and the tokens are
    a single engine's."""
    from paddle_tpu_torch.inference.serving import Router, SamplingParams

    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    model = _tiny_gpt()
    sp = SamplingParams(max_new_tokens=16)
    prompts = [[4, 5, 6], [7, 8], [9, 10, 11, 12], [13], [14, 15],
               [16, 17, 18], [19], [20, 21]]
    want = _engine(model, max_batch=8).generate(prompts, sampling=sp)
    before = cmon.stat_get("serve/failovers")
    flight.start_watchdog(timeout_s=0.3, poll_s=0.05)
    # the heartbeat stays out of it: only the incident export fails over
    r = Router(model, replicas=2, max_batch=2, block_size=8,
               num_blocks=32, device="cpu", heartbeat_timeout_s=60)
    try:
        # every decode takes 20 ms, so the survivor still has live work
        # when the watchdog fires
        with chaos.inject("serve_decode", "delay", ms=20), \
                chaos.inject("serve_decode", "stall", secs=1.5, after=2,
                             times=1):
            ids = [r.submit(p, sampling=sp) for p in prompts]
            r.wait(ids, timeout_s=60)
        got = [list(r.get_request(i).output_ids) for i in ids]
        dead = [rep for rep in r._replicas if rep.dead]
    finally:
        flight.stop_watchdog()
        r.shutdown()
    assert got == want
    assert cmon.stat_get("serve/failovers") == before + 1
    assert len(dead) == 1 and r.orphan_exports == []
    fo = [e for e in flight.tail() if e["kind"] == "serve_failover"]
    assert fo[-1]["reason"] == "incident_export"


def test_serve_drain_and_route_raise_before_touching_anything():
    from paddle_tpu_torch.inference.serving import Router, SamplingParams

    eng = _engine(_tiny_gpt())
    eng.add_request([1, 2], SamplingParams(max_new_tokens=2))
    with chaos.inject("serve_drain", "raise"):
        with pytest.raises(chaos.ChaosInjected):
            eng.drain()
    assert not eng.scheduler.draining
    r = Router(_tiny_gpt(), replicas=1, max_batch=2, block_size=8,
               num_blocks=32, device="cpu")
    try:
        with chaos.inject("serve_route", "raise", times=1):
            with pytest.raises(chaos.ChaosInjected):
                r.submit([1, 2], SamplingParams(max_new_tokens=2))
        rid = r.submit([1, 2], SamplingParams(max_new_tokens=2))
        r.wait([rid], timeout_s=60)
        with chaos.inject("serve_drain", "raise"):
            with pytest.raises(chaos.ChaosInjected):
                r.drain()
    finally:
        r.shutdown()


def test_collective_raise_leaves_no_inflight_entry():
    from paddle_tpu_torch.distributed import collective

    with chaos.inject("collective", "raise"):
        with pytest.raises(chaos.ChaosInjected):
            collective.all_reduce(torch.ones(3))
    assert not [e for e in flight.inflight_snapshot()
                if e["kind"] == "collective"]
    kinds = [e["kind"] for e in flight.tail(5)]
    assert "collective_begin" in kinds and "collective_end" in kinds


def test_comm_compress_bitflip_per_call():
    """The port's form: the flip lands on each armed CALL (the JAX
    package bakes it into one built program), so times=1 corrupts one
    call's block 0 and the next call is clean."""
    from paddle_tpu_torch.distributed import compress as C
    from paddle_tpu_torch.distributed.compress import allreduce as AR

    cfg = C.parse_spec("int8:block=128")
    x = torch.from_numpy(np.random.RandomState(0).randn(512)
                         .astype(np.float32))
    clean, _ = AR.all_reduce_flat(x, cfg=cfg)
    with chaos.inject("comm_compress", "bitflip", times=1) as rule:
        bad, _ = AR.all_reduce_flat(x, cfg=cfg)
        again, _ = AR.all_reduce_flat(x, cfg=cfg)
    assert rule.triggers == 1
    assert not torch.equal(bad[:128], clean[:128])
    assert torch.equal(bad[128:], clean[128:])
    assert torch.equal(again, clean)
    AR.account(cfg, 2048, 512, block=128)
    ev = flight.tail(1)[0]
    assert ev["kind"] == "comm_compress" and ev["compress"] == cfg.spec()


def test_io_fetch_raise_reaches_the_loop():
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    ds = TensorDataset([torch.arange(8.0)])
    loader = DataLoader(ds, batch_size=4, device="cpu")
    before = cmon.stat_get("io/batches")
    assert len(list(loader)) == 2
    assert cmon.stat_get("io/batches") == before + 2
    with chaos.inject("io_fetch", "raise", after=5, times=1):
        with pytest.raises(chaos.ChaosInjected):
            list(loader)


def test_concurrent_hits_claim_exactly_times():
    """Many threads racing one rule: the claim is atomic, so a times=N
    rule fires exactly N times however the threads interleave."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with chaos.inject("io_fetch", "delay", ms=0, times=25) as rule:
            def work():
                for _ in range(200):
                    chaos.hit("io_fetch")

            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
        assert rule.calls == 16 * 200 and rule.triggers == 25
    finally:
        sys.setswitchinterval(old)
