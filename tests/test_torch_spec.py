"""The port's speculative decoding and prefix caching held against the
JAX package's.

Same numpy inputs, the same weights (carried across with
`load_reference_params`), through both packages on the CPU:

  * the multi-query paged attention: the port's plain version and its
    wrapper (which takes the plain version for CPU tensors) against the
    JAX Pallas kernel in interpret mode and the JAX dense reference, f32
    within 2e-6 (the existing paged test's limit: summation order only),
    bf16 within 1e-2 (the JAX reference rounds normalised probabilities
    to bf16, the port un-normalised ones, as the kernels do); slot t
    against the single-query plain version at context + t;
  * the model runner: `draft_params`, `verify_step` and
    `prefill_tail_step`, tokens exactly and both pools within 1e-5;
  * the cache: `prefix_hashes` byte for byte, and a scripted
    probe / admit / register / evict sequence with the same tables,
    refcounts and `serve/prefix/*` deltas;
  * the engine end to end: `tests/test_serving.py`'s speculative and
    prefix-cache suite (greedy identity at k 2, 4, 8; temperature
    identity; corrupted drafts; disarmed paths; tail-only prefill; the
    everything-on eviction stress), plus sequences that run into
    max_seq_len and a draft equal to the target.

Temperature identity is held port k=4 against port k=1: the port's
draws come from torch.Generators, not JAX's PRNG.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.core import monitor as jax_mon
from paddle_tpu.incubate.nn.pallas import paged_attention as jax_pa
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.inference.serving import kv_cache as jax_kv
from paddle_tpu.inference.serving import model_runner as jax_mr
from paddle_tpu.text.models import gpt as jax_gpt

from paddle_tpu_torch.convert import load_reference_params
from paddle_tpu_torch.core import monitor as cmon
from paddle_tpu_torch.incubate.nn.kernels import paged_attention as pa
from paddle_tpu_torch.inference.serving import (LLMEngine, PagedKVCache,
                                                SamplingParams)
from paddle_tpu_torch.inference.serving import kv_cache as port_kv
from paddle_tpu_torch.inference.serving import model_runner as mr
from paddle_tpu_torch.text.models import gpt as port_gpt

CPU = "cpu"


def _twin_models(vocab=128, hidden=64, layers=2, heads=4, seq=64,
                 init=0.35):
    """test_serving.py's tiny_model recipe (a WIDE initializer, so
    greedy decodes are varied), and its weights in the port."""
    import paddle_tpu as paddle

    paddle.seed(0)
    kw = dict(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
              num_heads=heads, ffn_hidden=2 * hidden, max_seq_len=seq,
              dropout=0.0, initializer_range=init)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(
        use_flash_attention=False, **kw))
    jm.eval()
    pm = port_gpt.GPTForCausalLM(port_gpt.GPTConfig(**kw), device=CPU)
    params, _ = jax_mr.extract_params(jm)
    load_reference_params(pm, jax.tree_util.tree_map(np.asarray, params))
    return jm, pm


# ---------------------------------------------------------------------------
# multi-query paged attention
# ---------------------------------------------------------------------------

def _multi_inputs(t, b=4, h=4, d=32, bs=8, n=24, maxb=5, seed=0):
    """q [B, T, H, D], pools, and tables of maxb real columns plus the
    speculative path's NULL column. Contexts: 1, a block edge + 1, one
    whose deepest slot ends at the table's last real column, and an odd
    one."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kp = rng.randn(n, bs, h, d).astype(np.float32)
    vp = rng.randn(n, bs, h, d).astype(np.float32)
    bt = rng.randint(1, n, (b, maxb)).astype(np.int32)
    bt = np.concatenate([bt, np.zeros((b, 1), np.int32)], axis=1)
    lens = np.array([1, bs + 1, maxb * bs - t + 1, 17], np.int32)
    return q, kp, vp, bt, lens


def _jax_multi(q, kp, vp, bt, lens, dtype, scale):
    args = (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(bt), jnp.asarray(lens))
    kern = jax_pa.paged_attention_multi(*args, sm_scale=scale,
                                        interpret=True)
    ref = jax_pa.paged_attention_multi_reference(*args, sm_scale=scale)
    return np.asarray(kern, np.float32), np.asarray(ref, np.float32)


def _port(fn, q, kp, vp, bt, lens, dtype, scale):
    return fn(torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
              torch.from_numpy(vp).to(dtype), torch.from_numpy(bt),
              torch.from_numpy(lens), sm_scale=scale)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("fn", ["paged_attention_multi",
                                "paged_attention_multi_reference"])
def test_multi_matches_jax_f32(t, fn):
    q, kp, vp, bt, lens = _multi_inputs(t)
    jk, jr = _jax_multi(q, kp, vp, bt, lens, jnp.float32, 0.2)
    out = _port(getattr(pa, fn), q, kp, vp, bt, lens, torch.float32, 0.2)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), jk, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), jr, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("t", [2, 8])
def test_multi_matches_jax_bf16(t):
    q, kp, vp, bt, lens = _multi_inputs(t, seed=1)
    jk, jr = _jax_multi(q, kp, vp, bt, lens, jnp.bfloat16, 0.2)
    out = _port(pa.paged_attention_multi, q, kp, vp, bt, lens,
                torch.bfloat16, 0.2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), jr, rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(out.float().numpy(), jk, rtol=1e-2,
                               atol=1e-2 * np.abs(jk).max())


def test_multi_more_than_eight_slots_raise_in_both_packages():
    q, kp, vp, bt, lens = _multi_inputs(9)
    with pytest.raises(ValueError, match="T=9"):
        jax_pa.paged_attention_multi(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(bt),
                                     jnp.asarray(lens), interpret=True)
    with pytest.raises(ValueError, match="T=9"):
        _port(pa.paged_attention_multi, q, kp, vp, bt, lens, torch.float32,
              1.0)
    # the plain version takes any T: the tail prefill's windows
    out = _port(pa.paged_attention_multi_reference, q, kp, vp, bt, lens,
                torch.float32, 1.0)
    assert out.shape == q.shape


@pytest.mark.parametrize("t", [2, 8])
def test_multi_slot_t_is_the_decode_at_context_plus_t(t):
    q, kp, vp, bt, lens = _multi_inputs(t, seed=2)
    out = _port(pa.paged_attention_multi, q, kp, vp, bt, lens,
                torch.float32, 0.3)
    for s in range(t):
        one = _port(pa.paged_attention_reference, np.ascontiguousarray(
            q[:, s]), kp, vp, bt, lens + s, torch.float32, 0.3)
        torch.testing.assert_close(out[:, s], one, rtol=2e-6, atol=2e-6)


def test_multi_positions_past_the_deepest_slot_never_matter():
    """Poisoning every pool position at or past each sequence's
    ctx0 + T - 1 (and every block outside the tables) leaves the output
    bit-identical."""
    t = 4
    q, kp, vp, bt, lens = _multi_inputs(t, seed=3)
    out = _port(pa.paged_attention_multi, q, kp, vp, bt, lens,
                torch.float32, 0.3)
    live = np.zeros(kp.shape[:2], bool)
    for b in range(len(lens)):
        for pos in range(lens[b] + t - 1):
            live[bt[b, pos // 8], pos % 8] = True
    pk = np.where(live[:, :, None, None], kp, 1e9).astype(np.float32)
    pv = np.where(live[:, :, None, None], vp, -1e9).astype(np.float32)
    out2 = _port(pa.paged_attention_multi, q, pk, pv, bt, lens,
                 torch.float32, 0.3)
    assert torch.equal(out, out2)


# ---------------------------------------------------------------------------
# model runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twins():
    return _twin_models()


def _params(twins):
    jm, pm = twins
    jp, cfg = jax_mr.extract_params(jm)
    tp, _ = mr.extract_params(pm)
    return jp, tp, cfg


def test_draft_params_match_jax(twins):
    jp, tp, _ = _params(twins)
    jd = jax_mr.draft_params(jp, 1)
    td = mr.draft_params(tp, 1)
    assert sorted(jd) == sorted(td)
    for name in ("wte", "wpe", "lnf_w", "lnf_b"):
        assert td[name] is tp[name]            # shared, not copied
    for name, arr in jd["blocks"].items():
        assert td["blocks"][name].shape == arr.shape
        np.testing.assert_array_equal(td["blocks"][name].numpy(),
                                      np.asarray(arr))
    for bad in (0, 3):
        with pytest.raises(ValueError):
            jax_mr.draft_params(jp, bad)
        with pytest.raises(ValueError):
            mr.draft_params(tp, bad)


def _pools(cfg, n=24, bs=8, seed=4):
    rng = np.random.RandomState(seed)
    d = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, n, bs, cfg.num_heads, d)
    return (0.5 * rng.randn(*shape)).astype(np.float32), \
        (0.5 * rng.randn(*shape)).astype(np.float32)


def test_verify_step_matches_jax(twins):
    jp, tp, cfg = _params(twins)
    kp, vp = _pools(cfg)
    rng = np.random.RandomState(5)
    b, t, bs, maxb = 4, 4, 8, 5
    tables = np.stack([rng.permutation(np.arange(1, 24))[:maxb]
                       for _ in range(b)]).astype(np.int32)
    wide = np.concatenate([tables, np.zeros((b, 1), np.int32)], axis=1)
    start = np.array([0, 7, 20, 33], np.int32)
    lens = start + 1
    ids = rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int32)
    temp = np.zeros((b,), np.float32)
    topk = np.zeros((b,), np.int32)
    seeds = np.zeros((b, t), np.uint32)
    kw = dict(n_head=cfg.num_heads, eps=cfg.layer_norm_eps, block_size=bs)
    want = {}
    for use in (False, True):
        want[use] = jax_mr.verify_step(
            jp, jnp.asarray(ids), jnp.asarray(start), jnp.asarray(kp),
            jnp.asarray(vp), jnp.asarray(wide), jnp.asarray(lens),
            jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(seeds),
            use_kernel=use, interpret=use, **kw)
    for use in (False, True):
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        toks = mr.verify_step(
            tp, torch.from_numpy(ids), torch.from_numpy(start), tk, tv,
            torch.from_numpy(wide), torch.from_numpy(lens), temp, topk,
            seeds.astype(np.int64), use_kernel=use, **kw)
        for jt, jk, jv in want.values():
            np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=1e-5, atol=1e-5)


def test_prefill_tail_step_matches_jax(twins):
    jp, tp, cfg = _params(twins)
    kp, vp = _pools(cfg, seed=6)
    rng = np.random.RandomState(7)
    bs, maxb = 8, 8
    table = rng.permutation(np.arange(1, 24))[:maxb].astype(np.int32)
    start, total = 16, 29                   # 2 cached blocks, 13-token tail
    t_pad = 32 - start
    ids = np.zeros((1, t_pad), np.int32)
    ids[0, :total - start] = rng.randint(1, cfg.vocab_size, total - start)
    kw = dict(n_head=cfg.num_heads, eps=cfg.layer_norm_eps, block_size=bs)
    jt, jk, jv = jax_mr.prefill_tail_step(
        jp, jnp.asarray(ids), np.int32(start), np.int32(total),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        np.float32(0.0), np.int32(0), np.uint32(0), **kw)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tok = mr.prefill_tail_step(tp, torch.from_numpy(ids), start, total, tk,
                               tv, torch.from_numpy(table), 0.0, 0, 0, **kw)
    assert int(tok) == int(jt)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    # the cached prefix's blocks were read, never written
    for blk in table[:start // bs]:
        np.testing.assert_array_equal(tk[:, blk].numpy(), kp[:, blk])


# ---------------------------------------------------------------------------
# prefix cache bookkeeping
# ---------------------------------------------------------------------------

def test_prefix_hashes_byte_equal():
    rng = np.random.RandomState(8)
    for n, bs in ((0, 8), (7, 8), (40, 8), (33, 16)):
        toks = list(rng.randint(0, 50000, n))
        assert port_kv.prefix_hashes(toks, bs) \
            == jax_kv.prefix_hashes(toks, bs)
    toks = list(rng.randint(0, 50000, 40))
    assert port_kv.prefix_hashes(toks, 8, 3) \
        == jax_kv.prefix_hashes(toks, 8, 3)
    # a repeated chunk hashes differently at each depth (the chain)
    rep = [5] * 16
    a, b = port_kv.prefix_hashes(rep, 8)
    assert a != b


def _prefix_state(cache, owners):
    a = cache.allocator
    return ({o: a.owned(o) for o in owners},
            {o: [a.refcount(b) for b in a.owned(o)] for o in owners},
            a.free_blocks)


def _prefix_deltas(mon, fn):
    names = ("serve/prefix/hits", "serve/prefix/blocks_shared")
    before = {n: mon.stat_get(n) for n in names}
    out = fn()
    return out, {n: mon.stat_get(n) - before[n] for n in names}


def test_prefix_admission_sequence_matches_jax():
    """probe / admit / register / evict, scripted, on both caches."""
    rng = np.random.RandomState(9)
    prefix = list(rng.randint(1, 100, 16))
    a_toks = prefix + list(rng.randint(1, 100, 5))
    b_toks = prefix + list(rng.randint(1, 100, 9))
    c_toks = prefix[:8] + list(rng.randint(1, 100, 3))
    jc = jax_kv.PagedKVCache(1, 1, 8, block_size=8, num_blocks=12,
                             prefix_cache=True)
    pc = PagedKVCache(1, 1, 8, block_size=8, num_blocks=12, device=CPU,
                      prefix_cache=True)
    script = [
        ("probe", "a", a_toks), ("admit", "a", a_toks),
        ("register", "a", a_toks), ("probe", "b", b_toks),
        ("admit", "b", b_toks), ("register", "b", b_toks),
        ("probe", "c", c_toks), ("admit", "c", c_toks),
        ("release", "a", None), ("probe", "d", b_toks),
        ("admit", "d", b_toks), ("release", "b", None),
        ("release", "c", None), ("release", "d", None),
        ("probe", "e", a_toks),
    ]
    owners = ("a", "b", "c", "d")
    for op, owner, toks in script:
        outs = []
        for cache, mon in ((jc, jax_mon), (pc, cmon)):
            if op == "release":
                fn = lambda: cache.allocator.release(owner)  # noqa: E731
            else:
                fn = (lambda f=getattr(cache, {
                    "probe": "probe_prefix", "admit": "admit",
                    "register": "register_prefix"}[op]):
                      f(owner, toks) if op != "probe" else f(toks))
            out, deltas = _prefix_deltas(mon, fn)
            outs.append((out, deltas, _prefix_state(cache, owners)))
        assert outs[0] == outs[1], (op, owner)
    assert pc.allocator.used_blocks == 0
    # b shared a's two prefix blocks; a's release left them live for b
    assert pc.probe_prefix(a_toks) == (0, [])


# ---------------------------------------------------------------------------
# the engine end to end
# ---------------------------------------------------------------------------

def _counter_deltas(prefixes, fn):
    """(fn(), {counter: delta}) for stats under the given prefixes;
    registry.snapshot() never creates a stat, so zero-delta checks
    cannot satisfy themselves."""
    before = {k: v for k, v in cmon.registry.snapshot().items()
              if k.startswith(prefixes)}
    out = fn()
    after = {k: v for k, v in cmon.registry.snapshot().items()
             if k.startswith(prefixes)}
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


class _Rig:
    """Shared twins, prompts and engines (tests/test_serving.py's
    _SpecRig: max_batch 4, block_size 8, 64 blocks). Engines drain
    completely between tests, so reusing one is safe."""

    def __init__(self, twins):
        self.jm, self.pm = twins
        rng = np.random.RandomState(1)
        self.prompts = [list(rng.randint(1, 128, n))
                        for n in (1, 3, 8, 9, 13, 16, 14, 5)]
        prng = np.random.RandomState(6)
        self.prefix = list(prng.randint(1, 128, 16))  # 2 full blocks
        self.pfx_prompts = [self.prefix + list(prng.randint(1, 128, n))
                            for n in (5, 9)]
        self.sp = SamplingParams(max_new_tokens=8)
        self._engines = {}
        self._want = {}

    def engine(self, key, **kw):
        if key not in self._engines:
            self._engines[key] = LLMEngine(
                self.pm, max_batch=4, block_size=8,
                num_blocks=kw.pop("num_blocks", 64), device=CPU, **kw)
        return self._engines[key]

    def want(self, which="mixed"):
        if which not in self._want:
            prompts = (self.prompts if which == "mixed"
                       else self.pfx_prompts)
            self._want[which] = self.engine("base").generate(
                prompts, sampling=self.sp)
            assert self.engine("base").check_drained() == {}
        return self._want[which]

    def jax_want(self, prompts, n):
        return JaxEngine(self.jm, max_batch=4, block_size=8,
                         num_blocks=64).generate(
            prompts, sampling=JaxSampling(max_new_tokens=n))


@pytest.fixture(scope="module")
def rig(twins):
    return _Rig(twins)


@pytest.fixture(scope="module")
def jax_base(rig):
    """The JAX k=1 engine's tokens on the mixed prompts."""
    return rig.jax_want(rig.prompts, 8)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_greedy_token_identity(rig, jax_base, k):
    """Greedy spec decoding at k is token-identical to the port's k=1
    engine and to the JAX k=1 engine, over 8 concurrent mixed-length
    requests."""
    want = rig.want()
    assert want == jax_base
    hist0 = cmon.hist_get("serve/hist/accept_len").count
    eng = rig.engine(f"k{k}", spec_k=k)
    got, deltas = _counter_deltas(
        ("serve/spec/",), lambda: eng.generate(rig.prompts, sampling=rig.sp))
    assert got == want, f"spec_k={k} diverged from k=1"
    assert eng.check_drained() == {}
    assert eng.cache.allocator.used_blocks == 0
    assert deltas.get("serve/spec/proposed", 0) > 0
    assert 0 < deltas.get("serve/spec/accepted", 0) \
        <= deltas["serve/spec/proposed"]
    assert eng.state_summary()["spec_k"] == k
    assert cmon.stat_get("serve/spec/k") == k
    assert eng.cache.k_draft.shape[0] == 1          # half of 2 layers
    assert cmon.hist_get("serve/hist/accept_len").count > hist0


def test_temperature_identity(rig):
    """Every verify slot is sampled with the k=1 engine's
    position-keyed seed, so spec == k=1 at any temperature."""
    def run(eng):
        rids = [eng.add_request(
            p, SamplingParams(max_new_tokens=6, temperature=0.9, top_k=20,
                              seed=7 + i))
            for i, p in enumerate(rig.prompts)]
        while eng.has_unfinished():
            eng.step()
        outs = [list(eng.get_request(r).output_ids) for r in rids]
        assert eng.check_drained() == {}
        return outs

    assert run(rig.engine("k4", spec_k=4)) == run(rig.engine("base"))


def test_corrupted_drafts_degrade_not_diverge(rig, monkeypatch):
    """Every proposal shifted by one: verification rejects them, the
    tokens stay the k=1 engine's, and acceptance collapses."""
    eng = rig.engine("k4", spec_k=4)
    real = eng._draft_propose
    vocab = rig.pm.config.vocab_size

    def corrupt(*args):
        return {slot: [(d + 1) % vocab for d in ds]
                for slot, ds in real(*args).items()}

    monkeypatch.setattr(eng, "_draft_propose", corrupt)
    got, deltas = _counter_deltas(
        ("serve/spec/",), lambda: eng.generate(rig.prompts, sampling=rig.sp))
    assert got == rig.want()
    assert deltas["serve/spec/proposed"] > 0
    assert deltas.get("serve/spec/accepted", 0) \
        <= deltas["serve/spec/proposed"] * 0.2
    assert eng.check_drained() == {}


def test_disarmed_paths_move_no_spec_or_prefix_counter(rig):
    eng = rig.engine("base")
    assert eng.cache.k_draft is None and eng.cache.v_draft is None
    assert eng._draft_params is None
    _, deltas = _counter_deltas(
        ("serve/spec/", "serve/prefix/"),
        lambda: eng.generate(rig.prompts[:4], sampling=rig.sp))
    assert deltas == {}
    s = eng.state_summary()
    assert s["spec_k"] == 1 and s["prefix_cache"] is False


def test_shared_prefix_prefills_tail_only(rig, monkeypatch):
    """Two requests sharing a 2-block prefix: the second maps the
    published blocks copy-on-write and prefills only its tail, whose
    writes all land in unshared blocks; tokens equal the cache-off
    engine's and the JAX engine's."""
    eng = rig.engine("prefix", prefix_cache=True)
    real = eng._prefill
    checked = []

    def guarded(req):
        a = eng.cache.allocator
        private = a.owned(req.req_id)[req.cached_tokens // 8:]
        for blk in private:
            a.check_cow(blk)
        checked.append((req.cached_tokens, len(private)))
        shared = a.owned(req.req_id)[:req.cached_tokens // 8]
        assert all(a.refcount(blk) == 2 for blk in shared)
        return real(req)

    monkeypatch.setattr(eng, "_prefill", guarded)
    got, deltas = _counter_deltas(
        ("serve/prefix/",),
        lambda: eng.generate(rig.pfx_prompts, sampling=rig.sp))
    assert got == rig.want("pfx")
    assert got == rig.jax_want(rig.pfx_prompts, 8)
    assert checked == [(0, 3), (16, 2)]
    assert deltas["serve/prefix/hits"] == 1
    assert deltas["serve/prefix/blocks_shared"] == 2
    assert deltas["serve/prefix/prefill_tokens_saved"] == 16
    assert eng.check_drained() == {}
    assert eng.cache.allocator.used_blocks == 0


def test_eviction_replay_spec_prefix_zero_leaks(rig):
    """spec_k=4 + prefix caching on a pool too small for the working
    set: evicting a request that maps shared blocks releases only its
    references, a mid-round preemption replays token-exactly, and the
    drained pool is empty."""
    rng = np.random.RandomState(7)
    prefix = list(rng.randint(1, 128, 16))
    prompts = [prefix + list(rng.randint(1, 128, n))
               for n in (3, 7, 11, 5, 9, 2)]
    want = rig.engine("base").generate(prompts, sampling=rig.sp)
    evict0 = cmon.stat_get("serve/evictions")
    tight = rig.engine("tight", num_blocks=11, spec_k=4, prefix_cache=True)
    got = tight.generate(prompts, sampling=rig.sp)
    assert got == want
    assert cmon.stat_get("serve/evictions") > evict0
    assert tight.check_drained() == {}
    assert tight.cache.allocator.used_blocks == 0
    s = tight.state_summary()
    assert s["spec_k"] == 4 and s["prefix_cache"] is True


@pytest.mark.parametrize("k", [2, 4])
def test_sequences_into_max_seq_len(rig, k):
    """Prompts of 50 and 55 tokens at max_seq_len 64: verify slots run
    past the last position (their wpe row and table column clamp, their
    K/V goes to the NULL block) and are never emitted; the tokens equal
    the port's k=1 engine's and the JAX k=1 engine's."""
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(1, 128, n)) for n in (50, 55, 9)]
    sp = SamplingParams(max_new_tokens=20)
    want = rig.engine("base").generate(prompts, sampling=sp)
    assert [len(o) for o in want] == [14, 9, 20]
    assert want == rig.jax_want(prompts, 20)
    eng = rig.engine(f"k{k}", spec_k=k)
    assert eng.generate(prompts, sampling=sp) == want
    assert eng.check_drained() == {}
    assert bool(torch.isfinite(eng.cache.k).all())
    assert bool(torch.isfinite(eng.cache.k_draft).all())


def test_draft_equal_to_target_accepts_what_jax_accepts(rig):
    """draft_layers = depth: the draft is the target, so every proposal
    is accepted and the realign step runs every round. The JAX engine
    accepts all 48 of its 48 proposals on this input (measured on it
    with spec_k=4, draft_layers=2); the port must too."""
    eng = rig.engine("same", spec_k=4, draft_layers=2)
    assert eng.draft_layers == 2
    got, deltas = _counter_deltas(
        ("serve/spec/",), lambda: eng.generate(rig.prompts, sampling=rig.sp))
    assert got == rig.want()
    jeng = JaxEngine(rig.jm, max_batch=4, block_size=8, num_blocks=64,
                     spec_k=4, draft_layers=2)
    names = ("serve/spec/proposed", "serve/spec/accepted")
    before = {n: jax_mon.stat_get(n) for n in names}
    jeng.generate(rig.prompts, sampling=JaxSampling(max_new_tokens=8))
    jd = {n: jax_mon.stat_get(n) - before[n] for n in names}
    assert deltas["serve/spec/accepted"] == jd["serve/spec/accepted"] == 48
    assert deltas["serve/spec/proposed"] == jd["serve/spec/proposed"] == 48


def test_out_of_memory_round_evicts_and_replays(rig, monkeypatch):
    """A speculative round whose verify dispatch runs out of device
    memory evicts a victim and retries the round; the evicted request
    re-prefills (its draft pools too) and the tokens equal k=1's."""
    prompts = rig.prompts[:4]
    want = rig.engine("base").generate(prompts, sampling=rig.sp)
    eng = LLMEngine(rig.pm, max_batch=4, block_size=8, num_blocks=64,
                    device=CPU, spec_k=4)
    real = eng._dispatch_verify
    faults = iter([False, True, False, True])

    def flaky(*args):
        if next(faults, False):
            raise torch.cuda.OutOfMemoryError("injected")
        return real(*args)

    monkeypatch.setattr(eng, "_dispatch_verify", flaky)
    before = cmon.stat_get("serve/oom_evictions")
    assert eng.generate(prompts, sampling=rig.sp) == want
    assert cmon.stat_get("serve/oom_evictions") == before + 2
    assert eng.check_drained() == {}

    def always(*args):
        raise torch.cuda.OutOfMemoryError("injected")

    monkeypatch.setattr(eng, "_dispatch_verify", always)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.generate(prompts, sampling=rig.sp)
