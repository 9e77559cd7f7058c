"""The port's runtime sanitizer (`paddle_tpu_torch.monitor.sanitize`)
held against the JAX package's: specs parse the same; the same lock
sequences give the same PTA060 cycles and the same PTA061 and PTA063
findings; the same KV-block misuse sequences give the same PTA070,
PTA071 and PTA074 findings; the donation family's PTA043 check at the
checkpoint capture; disarmed, `lock()` and `condition()` are plain
threading primitives and nothing is counted."""
import re
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.core import monitor as jcore
from paddle_tpu.inference.serving.kv_cache import BlockAllocator as JAlloc
from paddle_tpu.monitor import sanitize as jsan

from paddle_tpu_torch.core import monitor as core
from paddle_tpu_torch.inference.serving.kv_cache import BlockAllocator
from paddle_tpu_torch.monitor import sanitize as san


@pytest.fixture(autouse=True)
def _clean():
    for mod in (san, jsan):
        mod.disarm()
        mod.clear_findings()
        with mod._edge_lock:
            mod._edges.clear()
    yield
    for mod in (san, jsan):
        mod.disarm()
        mod.clear_findings()
        with mod._edge_lock:
            mod._edges.clear()


def _found(mod):
    return [(f.code, f.message) for f in mod.findings()]


@pytest.mark.parametrize("spec", [
    "locks", "locks:hold_ms=250", "serving,numerics:sample=4",
    "donation;locks:hold_ms=5", "numerics:sample=3:absmax=100",
    "serving; locks"])
def test_parse_spec_matches_jax(spec):
    assert san.parse_spec(spec) == jsan.parse_spec(spec)


@pytest.mark.parametrize("spec", ["bogus", "locks:x=1", "locks:hold_ms",
                                  "locks:hold_ms=abc"])
def test_bad_specs_refused_like_jax(spec):
    with pytest.raises(ValueError):
        jsan.parse_spec(spec)
    with pytest.raises(ValueError):
        san.parse_spec(spec)


def test_waiting_families_refused_by_name():
    for fam in san.WAITING:
        assert fam in jsan.FAMILIES
        with pytest.raises(ValueError, match="not ported"):
            san.parse_spec(fam)
    assert set(san.parse_spec("all")) == set(san.FAMILIES)


def test_disarmed_is_plain_and_counter_clean():
    assert type(san.lock("x")) is type(threading.Lock())
    assert type(san.condition("x")) is threading.Condition
    assert not san.armed() and san.families() == []
    assert not [k for k in core.registry.snapshot()
                if k.startswith("sanitize/armed")] or \
        core.stat_get("sanitize/armed") == 0


def _cycle_names(report):
    return sorted(tuple(re.findall(r"'(\w+)'->'(\w+)'", f.message))
                  for f in report.findings)


def _order_run(mod, orders):
    mod.configure("locks")
    locks = {n: mod.lock(n) for n in "ABCD"}
    for order in orders:
        def run(order=order):
            held = []
            for n in order:
                locks[n].acquire()
                held.append(locks[n])
            for lk in reversed(held):
                lk.release()

        t = threading.Thread(target=run)
        t.start()
        t.join()
    return mod.check_lock_order()


@pytest.mark.parametrize("orders", [
    ["AB", "BA"], ["AB", "BC", "CA"], ["AB", "AC", "BC"],
    ["ABC", "CB", "DA", "AD"]])
def test_lock_order_cycles_match_jax(orders):
    got = _order_run(san, orders)
    want = _order_run(jsan, orders)
    assert got.codes() == want.codes()
    assert _cycle_names(got) == _cycle_names(want)
    assert sorted(san.lock_order_edges()) == sorted(jsan.lock_order_edges())
    assert [c for c, _ in _found(san)] == [c for c, _ in _found(jsan)]


def test_long_hold_matches_jax():
    for mod in (san, jsan):
        mod.configure("locks:hold_ms=5")
        lk = mod.lock("slow")
        for _ in range(2):
            with lk:
                time.sleep(0.02)
    got, want = _found(san), _found(jsan)
    assert [c for c, _ in got] == [c for c, _ in want] == ["PTA061"]
    strip = re.compile(r"held \d+ ms|acquired at .*\)")
    assert [strip.sub("", m) for _, m in got] == \
        [strip.sub("", m) for _, m in want]
    assert core.stat_get("sanitize/locks/long_holds") >= 2


def test_thread_census_matches_jax():
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="leaky-worker")
    t.start()
    try:
        for mod in (san, jsan):
            mod.configure("locks")
        got = san.thread_census()
        want = jsan.thread_census()
    finally:
        stop.set()
        t.join()
    assert [(f.code, f.message) for f in got.findings] == \
        [(f.code, f.message) for f in want.findings]
    assert "leaky-worker" in got.findings[0].message
    assert _found(san) == _found(jsan)


def _kv_misuse(cls):
    a = cls(16)
    out = []
    blocks = a.alloc("r1", 3)
    for fn in (lambda: a.free_one("r2", blocks[0]),       # foreign free
               lambda: a.free_one("r1", 99)):             # not owned
        try:
            fn()
        except ValueError as e:
            out.append(str(e))
    a.share("r2", blocks[1])
    try:
        a.check_cow(blocks[1])                            # shared write
    except ValueError as e:
        out.append(str(e))
    out.append(sorted(a.audit_leaks(live_owners=["r2"]).items()))
    a._refcnt[blocks[1]] = 1                              # a lost ref
    a.release("r1")                                       # reclaims it
    out.append(a.free_blocks)
    return out


def test_kv_misuse_findings_match_jax():
    san.configure("serving")
    jsan.configure("serving")
    assert _kv_misuse(BlockAllocator) == _kv_misuse(JAlloc)
    got = _found(san)
    assert got == _found(jsan)
    assert sorted({c for c, _ in got}) == ["PTA070", "PTA071", "PTA074"]
    assert core.stat_get("analysis/PTA074/findings") >= 2


def test_kv_misuse_disarmed_reports_nothing():
    before = dict(core.registry.snapshot())
    out = _kv_misuse(BlockAllocator)
    assert out == _kv_misuse(JAlloc)
    assert _found(san) == []
    after = core.registry.snapshot()
    assert {k: v for k, v in after.items() if k.startswith("analysis/")} \
        == {k: v for k, v in before.items() if k.startswith("analysis/")}


def test_engine_check_drained_reports_pta070():
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    san.configure("serving")
    m = GPTForCausalLM(GPTConfig(vocab_size=32, hidden_size=16,
                                 num_layers=1, num_heads=2, ffn_hidden=32,
                                 max_seq_len=16), device="cpu")
    eng = LLMEngine(m, max_batch=2, block_size=4, num_blocks=16,
                    device="cpu")
    eng.generate([[1, 2, 3]], sampling=SamplingParams(max_new_tokens=2))
    assert eng.check_drained() == {}
    eng.cache.allocator.alloc("ghost", 1)
    assert list(eng.check_drained()) == ["ghost"]
    assert [c for c, _ in _found(san)] == ["PTA070"]


def test_verify_owned_numpy_like_jax():
    san.configure("donation")
    jsan.configure("donation")
    base = np.arange(12, dtype=np.float32)
    view = base[2:]
    got = san.verify_owned(view, site="s", what="w")
    want = jsan.verify_owned(view, site="s", what="w")
    assert got.flags["OWNDATA"] and np.array_equal(got, want)
    assert san.verify_owned(base) is base
    assert [c for c, _ in _found(san)] == [c for c, _ in _found(jsan)] \
        == ["PTA043"]


def test_verify_owned_torch_views():
    san.configure("donation")
    buf = torch.arange(10.0)
    assert san.verify_owned(buf) is buf
    for view in (buf[3:], buf.view(2, 5), buf[::2]):
        out = san.verify_owned(view, site=f"s{id(view)}")
        assert out._base is None and torch.equal(out, view)
        assert out.untyped_storage().data_ptr() != \
            buf.untyped_storage().data_ptr()
    tree = san.verify_host_tree({"a": [buf[1:], np.arange(3)[1:]]},
                                site="t")
    assert tree["a"][0]._base is None and tree["a"][1].flags["OWNDATA"]
    assert core.stat_get("sanitize/donation/unowned_snapshots") >= 4


def test_checkpoint_capture_is_owned_under_donation(tmp_path):
    """The pooled capture hands the writer whole buffers: armed, the
    PTA043 check finds nothing, and a view slipped into a state is
    caught and copied."""
    from paddle_tpu_torch.incubate.checkpoint.elastic import (
        CheckpointManager)

    san.configure("donation")
    mgr = CheckpointManager(dir=str(tmp_path), async_write=False,
                            device="cpu")
    w = torch.arange(8.0)
    mgr.save({"w": w, "m": {"v": torch.ones(3)}}, global_step=1)
    assert _found(san) == []
    tree, _ = mgr._capture({"w": w})
    assert tree["w"]._base is None
    state = CheckpointManager(dir=str(tmp_path), device="cpu").restore()
    assert torch.equal(state["w"], w)


def test_locks_family_instruments_checkpoint_and_flight(tmp_path):
    from paddle_tpu_torch.incubate.checkpoint.elastic import (
        CheckpointManager)

    san.configure("locks")
    mgr = CheckpointManager(dir=str(tmp_path), device="cpu")
    assert isinstance(mgr._write_lock, san.SanLock)
    assert isinstance(mgr._cv._lock, san.SanLock)
    mgr.save({"w": torch.ones(2)}, global_step=1)
    assert mgr.flush(30)
    mgr.close()
    assert san.check_lock_order().codes() == []
