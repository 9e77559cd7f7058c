"""LLMEngine — the generation front end, the port of
`paddle_tpu/inference/serving/engine.py`.

A GPTForCausalLM plus a paged KV cache, a continuous-batching
scheduler, and two forward passes — a per-request prefill and ONE
fixed-shape decode dispatch covering all `max_batch` slots — that
together serve many concurrent mixed-length requests:

    engine = LLMEngine(model)
    engine.add_request([1, 2, 3], SamplingParams(max_new_tokens=8),
                       on_token=stream_cb)          # streaming
    outs = engine.generate([[1, 2, 3], [7, 8]])     # run-to-drain

Per engine `step()`: admit + prefill whatever the scheduler lets in,
grow block tables across block boundaries (evicting under pool
pressure), then ONE decode dispatch for the whole batch — inactive
slots ride along pointed at the NULL block. Stop conditions
(eos / stop ids / max_new_tokens / max_seq_len) apply on the host to
the returned tokens; finished requests free their blocks before the
next admission pass.

The engine runs where the model's weights are: on the CUDA card by
default (`device=None`; raises without one), on the CPU only when the
caller passes device="cpu". On the card, LayerNorm and decode attention
are the hand-written kernels (`incubate.nn.kernels`);
`use_kernel=False` makes the forward passes call their plain PyTorch
versions instead, which is what the kernel comparisons use.

Speculative decoding (`spec_k` > 1, at most 8): a DRAFT model — the
target's first `draft_layers` blocks (default half the depth) sharing
its embeddings and head (`model_runner.draft_params`) — proposes k-1
tokens with k batched decode dispatches against its own twin pools,
then ONE `verify_step` dispatch runs the target over all k slots
(pending token + proposals) through the multi-query paged-attention
kernel. The engine emits the longest prefix of proposals that AGREE
with the target's own position-seeded choices, plus the first
disagreeing target token: every emitted token is the target's choice
for its position, so the stream equals k=1 at any temperature, and a
bad draft only costs speed (1..k tokens per round). Speculative
dispatches take block tables one guaranteed-NULL column wider, so a
near-`max_seq_len` slot's overflow writes land in the null block.
`serve/spec/{k,proposed,accepted}` and `serve/hist/accept_len` price
it.

Prefix caching (`prefix_cache=True`): full immutable prompt blocks are
content-hashed after prefill; a later request whose context chains
onto published blocks admits with them mapped copy-on-write and
prefills ONLY the uncached tail (`prefill_tail_step`), counted in
`serve/prefix/{hits,blocks_shared,prefill_tokens_saved}`. Both features
are off by default, and then the k=1 decode and prefill are exactly
the paths without them.

Failure path: a decode dispatch that runs out of device memory
(`torch.cuda.OutOfMemoryError`) evicts a victim and retries with the
smaller batch (a speculative round retries whole); after
max(3, max_batch) consecutive failures it re-raises. The pools are
updated in place and survive a failed dispatch: a retry rewrites the
same positions.

Lifecycle:

  * `drain(timeout_s)` stops admission (new intake sheds with
    `EngineOverloaded`), runs RUNNING requests to completion, then
    EXPORTS what is left (prompt + generated-so-far + sampling) for
    token-exact re-admission elsewhere (`import_request`); `resume()`
    re-opens admission.
  * `export_requests(fence=)` retires every live request to the
    terminal EXPORTED state and, by default, FENCES the engine: a
    fenced engine refuses intake and its `step()` no-ops, so a zombie
    thread waking from a wedge cannot double-serve what replays
    elsewhere.
  * `arm_incident_export()` registers a flight incident hook
    (`monitor.flight`): on an incident the engine fences and exports
    its live requests into `emergency_exports`. A watchdog fire does
    so only to the engine whose own prefill or decode dispatch is among
    the stuck entries (by the thread running it), so a Router's healthy
    replicas keep serving; the JAX hook fences every armed engine with
    live work.
  * `load_score()` (free blocks net of queued demand) and `heartbeat`
    (stamped at every completed prefill and decode dispatch) are the
    router's routing and health signals; `state_summary()` is attached
    to every shed or timeout.
  * `export_traces()` / `dump_traces(path)`: the per-request trace
    spool (`monitor.trace`).

The constructor takes the JAX package's parameters in its order; a
`None` reads the `PADDLE_SERVE_*` knob as the JAX engine does.
`donate=True` is accepted and `False` raises: the pools are always
updated in place, which is what donation buys.

Telemetry: `serve/{requests,tokens,prefills,prefill_us,
decode_dispatches,decode_us,evictions,oom_evictions,queue_depth,
drains,kv_blocks/*}` counters and the `serve/hist/{ttft_us,itl_us,
queue_wait_us,e2e_us,accept_len}` histograms, `serve/spec/*` and
`serve/prefix/*` (`paddle_tpu_torch.core.monitor`), and the
`serve_prefill` / `serve_decode` / `serve_drain` flight spans. A
speculative round counts as one `serve/decode_dispatches` (its verify
dispatch; its k draft dispatches come with it).

Chaos sites (JAX :696-731, 886-933, 1120-1124): `serve_decode` inside
the decode span (a `resource_exhausted` there takes the out-of-memory
eviction path, classified by `monitor.memory.is_oom_error`),
`serve_spec_verify` between the draft proposals and the verify
dispatch (`corrupt` shifts every proposal by one token id, so
verification rejects them and each round emits one token, the
target's own), and `serve_drain` at drain entry. The engine registers
its `export_traces` with the debug server's /tracez.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time

import numpy as np
import torch

from ...core import monitor as _cmon
from ...device import resolve_device
from ...incubate.nn.kernels.paged_attention import (MAX_QUERY_SLOTS,
                                                    paged_decode_supported)
from ...monitor import chaos as _chaos
from ...monitor import flight as _flight
from ...monitor import memory as _memory
from ...monitor import trace as _trace
from . import model_runner as _mr
from .kv_cache import (NULL_BLOCK, PagedKVCache, env_max_batch,
                       env_prefix_cache, env_spec_draft, env_spec_k)
from .scheduler import (EXPORTED, FINISHED, EngineOverloaded, Request,
                        Scheduler)

__all__ = ["LLMEngine", "EngineTimeout"]


class EngineTimeout(TimeoutError):
    """`generate(timeout_s=)` ran out of budget with work still live.
    Carries the engine's state summary in `.engine_state`."""

    def __init__(self, msg, engine_state=None):
        super().__init__(msg)
        self.engine_state = engine_state or {}


class LLMEngine:
    """Continuous-batching generation engine over one causal LM."""

    def __init__(self, model, max_batch=None, block_size=None,
                 num_blocks=None, pool_bytes=None, dtype=None,
                 static_batching=False, use_kernel=None, donate=True,
                 max_queue=None, spec_k=None, draft_layers=None,
                 prefix_cache=None, *, device=None):
        # the pools are always updated in place, which is what the JAX
        # package's buffer donation buys
        if not donate:
            raise NotImplementedError(
                "LLMEngine: donate=False is not ported (the port updates "
                "its KV pools in place)")
        self.device = resolve_device(device)
        self.params, self.config = _mr.extract_params(model)
        if self.params["wte"].device != self.device:
            raise ValueError(
                f"model weights live on {self.params['wte'].device}, "
                f"engine device is {self.device}: build the model on "
                "the engine's device")
        cfg = self.config
        self.max_batch = int(max_batch or env_max_batch())
        self.max_seq_len = int(cfg.max_seq_len)
        head_dim = cfg.hidden_size // cfg.num_heads
        # speculative width: 1 = off (the verify kernel unrolls its
        # query slots, so k is capped at MAX_QUERY_SLOTS)
        self.spec_k = max(1, min(MAX_QUERY_SLOTS, int(
            spec_k if spec_k is not None else env_spec_k())))
        self.draft_layers = 0
        if self.spec_k > 1:
            n_draft = int(draft_layers if draft_layers is not None
                          else env_spec_draft())
            if n_draft <= 0:             # default: half the depth
                n_draft = max(1, cfg.num_layers // 2)
            self.draft_layers = min(n_draft, cfg.num_layers)
        self.prefix_cache = bool(prefix_cache if prefix_cache is not None
                                 else env_prefix_cache())
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, head_dim,
            block_size=block_size, num_blocks=num_blocks,
            pool_bytes=pool_bytes, dtype=dtype,
            draft_layers=self.draft_layers,
            prefix_cache=self.prefix_cache, device=self.device)
        self.block_size = self.cache.block_size
        # None: the kernels, as on the JAX side where they are available
        self.use_kernel = True if use_kernel is None else bool(use_kernel)
        if self.use_kernel and self.device.type == "cuda" \
                and not paged_decode_supported(head_dim, self.block_size):
            raise ValueError(
                f"the paged-attention kernel takes head_dim 64/128 and "
                f"block_size % 8 == 0; got head_dim {head_dim}, "
                f"block_size {self.block_size} (use_kernel=False runs "
                "the plain version)")
        # fixed table width: enough slots for a max-length sequence
        self.max_blocks_per_seq = math.ceil(
            self.max_seq_len / self.block_size)
        self.scheduler = Scheduler(self.cache, self.max_batch,
                                   self.max_seq_len,
                                   static_batching=static_batching,
                                   max_queue=max_queue,
                                   spec_tokens=self.spec_k)
        self._draft_params = None
        if self.spec_k > 1:
            self._draft_params = _mr.draft_params(self.params,
                                                  self.draft_layers)
            _cmon.stat_set("serve/spec/k", self.spec_k)
        self._requests = {}          # req_id -> Request (all states)
        self._oom_streak = 0         # consecutive OOM'd dispatches
        # finished requests kept for result retrieval, bounded
        self._keep_finished = 256
        # stamped at every completed dispatch: the router's health
        # signal (a wedged dispatch stops the clock)
        self.heartbeat = time.monotonic()
        # fenced: this engine's requests were exported elsewhere, and a
        # zombie thread waking from a wedge must not keep serving
        self._fenced = False
        # the emergency drain-and-export's landing zone (incident hook)
        self.emergency_exports = None
        self._incident_armed = False
        # the thread inside this engine's prefill / decode span, if any
        self._dispatch_tid = None
        # /tracez reads this engine's spool (registered weakly)
        from ...monitor import server as _mserver

        _mserver.add_trace_source(self.export_traces)

    def _fwd_kwargs(self):
        cfg = self.config
        return dict(n_head=cfg.num_heads, eps=cfg.layer_norm_eps,
                    block_size=self.block_size, use_kernel=self.use_kernel)

    def _to_device(self, array):
        return torch.from_numpy(array).to(self.device)

    # -- request intake ----------------------------------------------
    def add_request(self, prompt_ids, sampling=None, on_token=None,
                    req_id=None):
        """Queue one request; returns its id. `on_token(req_id, token)`
        streams every generated token as its dispatch completes. A
        fenced engine refuses intake (its step() no-ops)."""
        self._check_fenced()
        req = Request(prompt_ids, sampling=sampling, on_token=on_token,
                      req_id=req_id)
        self.scheduler.add(req)
        self._requests[req.req_id] = req
        self._prune_finished()
        _cmon.stat_add("serve/requests", 1)
        return req.req_id

    def _prune_finished(self):
        """Cap retained finished requests at `_keep_finished`, oldest
        dropped first; their blocks were released when they finished."""
        done = [rid for rid, r in self._requests.items() if r.finished]
        for rid in done[:max(0, len(done) - self._keep_finished)]:
            del self._requests[rid]

    def release_request(self, req_id):
        """Drop a finished request's retained record (results
        consumed). Live requests must be aborted first."""
        req = self._requests.get(req_id)
        if req is not None and req.finished:
            del self._requests[req_id]

    def abort_request(self, req_id):
        req = self._requests.get(req_id)
        if req is not None and not req.finished:
            self.scheduler.abort(req)

    def get_request(self, req_id):
        return self._requests[req_id]

    def has_unfinished(self):
        return self.scheduler.has_work()

    # -- the engine loop ---------------------------------------------
    def step(self):
        """One engine iteration: admissions (each prefilled, its first
        token emitted) + one decode dispatch for the running batch.
        Returns {req_id: token} emitted this step. A fenced engine
        no-ops: its tokens would double-serve requests replaying
        elsewhere."""
        if self._fenced:
            return {}
        emitted = {}

        def _on_admit(req):
            # prefill AS each request admits
            self._emit(req, self._prefill(req), emitted)

        admitted = self.scheduler.schedule(on_admit=_on_admit)
        if not admitted and not self.scheduler.running \
                and self.scheduler.waiting:
            # an idle engine that can't admit its queue head never
            # makes progress: a pool below one request must be LOUD
            head = self.scheduler.waiting[0]
            need = self.cache.blocks_for_tokens(head.context_len) \
                + self.scheduler._lookahead
            if need > self.cache.num_blocks - 1:
                raise RuntimeError(
                    f"KV pool too small: {head.req_id} needs {need} "
                    f"block(s) but the pool has only "
                    f"{self.cache.num_blocks - 1} usable — raise "
                    "pool_bytes or num_blocks")
        if self.scheduler.running:
            self._decode_batch(emitted)
        return emitted

    def generate(self, prompts, sampling=None, timeout_s=None):
        """Submit `prompts` (lists of token ids) and run the engine to
        drain; returns each prompt's generated ids, in order.
        `timeout_s` bounds the whole drain (judged between dispatches)
        and raises EngineTimeout with `state_summary()` attached. A
        request that EXPIRES (deadline_s) returns its partial output
        (empty if never admitted); one exported by an incident hook
        mid-generate raises EngineTimeout."""
        ids = [self.add_request(p, sampling=sampling) for p in prompts]
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while self.has_unfinished() and not self._fenced:
            self.step()
            if deadline is not None and self.has_unfinished() \
                    and time.monotonic() > deadline:
                raise EngineTimeout(
                    f"generate() exceeded timeout_s={timeout_s} "
                    f"with {len(self.scheduler.running)} running / "
                    f"{len(self.scheduler.waiting)} waiting",
                    engine_state=self.state_summary())
        exported = [i for i in ids
                    if self._requests[i].state == EXPORTED]
        if exported:
            raise EngineTimeout(
                f"engine fenced mid-generate: {len(exported)} "
                "request(s) were emergency-exported (see "
                "emergency_exports) — replay them on a healthy engine",
                engine_state=self.state_summary())
        outs = [self._requests[i].output_ids for i in ids]
        for i in ids:                # results consumed: release
            self.release_request(i)
        return outs

    # -- prefill -----------------------------------------------------
    def _prefill(self, req):
        """Causal forward over the (re)admitted request's context —
        prompt plus any generation an eviction preserved — writing its
        K/V and sampling the next token. On a prefix-cache hit the
        leading `req.cached_tokens` (a block multiple, below the context
        length) already sit in shared blocks and only the tail runs
        (`prefill_tail_step`): its writes land in the request's private
        blocks alone, since admission caps sharing below the full
        context. Then the request's full blocks are published for later
        sharers, and with speculation on the draft prefills its twin
        pools through the same table."""
        ctx = req.prompt_ids + req.output_ids
        plen = len(ctx)
        cached = req.cached_tokens
        padded = self.cache.blocks_for_tokens(plen) * self.block_size
        ids = np.zeros((1, padded - cached), np.int32)
        ids[0, :plen - cached] = ctx[cached:]
        table = self.cache.block_table(req.req_id,
                                       self.max_blocks_per_seq)
        s = req.sampling
        t0 = time.perf_counter()
        ids_t, table_t = self._to_device(ids), self._to_device(table)
        kw = self._fwd_kwargs()

        def run(params, k_pool, v_pool, *sampling):
            if cached:
                return _mr.prefill_tail_step(params, ids_t, cached, plen,
                                             k_pool, v_pool, table_t,
                                             *sampling, **kw)
            return _mr.prefill_step(params, ids_t, plen, k_pool, v_pool,
                                    table_t, *sampling, **kw)

        with self._dispatch_span("serve_prefill", req.req_id, tokens=plen):
            tok = int(run(self.params, self.cache.k, self.cache.v,
                          s.temperature, s.top_k,
                          _mr.seed_for(s.seed, plen)))  # waits
            if self._draft_params is not None:
                run(self._draft_params, self.cache.k_draft,
                    self.cache.v_draft, 0.0, 0, 0)
                req._spec_gap = False
        dur_us = int((time.perf_counter() - t0) * 1e6)
        _cmon.stat_add("serve/prefill_us", dur_us)
        _cmon.stat_add("serve/prefills", 1)
        if cached:
            _cmon.stat_add("serve/prefix/prefill_tokens_saved", cached)
        if _trace._armed:
            # replayed > 0: an eviction recompute or a failover/drain
            # replay (the preserved output_ids re-prefill)
            if cached:
                _trace.note(req, "prefill", tokens=plen - cached,
                            cached=cached, dur_us=dur_us,
                            replayed=len(req.output_ids))
            else:
                _trace.note(req, "prefill", tokens=plen, dur_us=dur_us,
                            replayed=len(req.output_ids))
        self.cache.register_prefix(req.req_id, ctx)
        self.heartbeat = time.monotonic()
        return tok

    # -- decode ------------------------------------------------------
    def _batch_arrays(self):
        """Fixed-shape [max_batch] dispatch inputs (numpy, int32 like
        the JAX engine's); inactive slots decode garbage against the
        NULL block with context length 1 and are dropped on the host."""
        b = self.max_batch
        ids = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        tables = np.full((b, self.max_blocks_per_seq), NULL_BLOCK,
                         np.int32)
        lens = np.ones((b,), np.int32)
        temp = np.zeros((b,), np.float32)
        topk = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.int64)
        for slot, req in self.scheduler.running.items():
            ctx = req.prompt_ids + req.output_ids
            ids[slot] = ctx[-1]
            pos[slot] = len(ctx) - 1
            tables[slot] = self.cache.block_table(
                req.req_id, self.max_blocks_per_seq)
            lens[slot] = len(ctx)
            s = req.sampling
            temp[slot] = s.temperature
            topk[slot] = s.top_k
            seeds[slot] = _mr.seed_for(s.seed, len(ctx))
        return ids, pos, tables, lens, temp, topk, seeds

    def _dispatch_decode(self, arrays):
        ids, pos, tables, lens, temp, topk, seeds = arrays
        toks = _mr.decode_step(
            self.params, self._to_device(ids), self._to_device(pos),
            self.cache.k, self.cache.v, self._to_device(tables),
            self._to_device(lens), temp, topk, seeds,
            **self._fwd_kwargs())
        return toks.cpu().numpy()    # waits for the device

    def _decode_batch(self, emitted):
        """Grow tables, run one decode dispatch (or, with spec_k > 1, one
        speculative round), apply stop conditions. An out-of-memory
        dispatch evicts a victim and retries with the smaller batch; a
        persistent one re-raises after max(3, max_batch) consecutive
        failed dispatches."""
        k = self.spec_k
        # re-check membership per request: growing A can evict B later
        # in the snapshot. A round lands up to k tokens, capped so a
        # sequence near max_seq_len never asks for blocks past the
        # table's width
        for req in list(self.scheduler.running.values()):
            self.scheduler.ensure_capacity(req, new_tokens=min(
                k, max(1, self.max_seq_len - req.context_len)))
        if not self.scheduler.running:
            return
        arrays = self._batch_arrays()
        running = dict(self.scheduler.running)
        t0 = time.perf_counter()
        try:
            with self._dispatch_span(
                    "serve_decode", "spec_decode" if k > 1 else "decode",
                    batch=len(running)):
                if _chaos._armed:
                    _chaos.hit("serve_decode", batch=len(running))
                if k > 1:
                    rows = self._spec_round(running, arrays)
                else:
                    toks = self._dispatch_decode(arrays)
                    rows = {slot: [int(toks[slot])] for slot in running}
        except Exception as e:
            if not _memory.is_oom_error(e):
                raise
            self._oom_streak += 1
            if self._oom_streak > max(3, self.max_batch):
                raise
            victim = self.scheduler._pick_victim()
            if victim is None:
                raise
            _cmon.stat_add("serve/oom_evictions", 1)
            self.scheduler.evict(victim)
            return self._decode_batch(emitted)
        self._oom_streak = 0
        self.heartbeat = time.monotonic()
        _cmon.stat_add("serve/decode_us",
                       int((time.perf_counter() - t0) * 1e6))
        _cmon.stat_add("serve/decode_dispatches", 1)
        for slot, req in running.items():
            if self.scheduler.running.get(slot) is not req:
                # exported (or aborted) while the dispatch ran: a fenced
                # engine's late wake-up emits nothing
                continue
            for tok in rows[slot]:
                self._emit(req, tok, emitted)
                if req.finished:
                    break

    # -- speculative decode (spec_k > 1) -----------------------------
    def _wide_tables(self, tables):
        """Speculative dispatch tables carry ONE extra guaranteed-NULL
        column: a near-`max_seq_len` slot whose position overflows the
        real table width clamps into the null block instead of writing
        into an at-cap sequence's own last block."""
        wide = np.full((tables.shape[0], self.max_blocks_per_seq + 1),
                       NULL_BLOCK, np.int32)
        wide[:, :-1] = tables
        return wide

    def _draft_propose(self, running, wide, arrays):
        """k batched draft decode dispatches -> k-1 proposed tokens per
        running request ({slot: [tokens]}); `arrays` are the round's
        `_batch_arrays()`.

        Step 0 is the REALIGN step: a request whose previous round
        accepted every proposal has one context position whose draft
        K/V was never written (the verify dispatch writes only the
        target's). Re-feeding ctx[-2] at its own position writes it;
        requests without the gap re-feed ctx[-1] (step 1 writes the
        same value again), keeping the dispatch one fixed shape. Steps
        1..k-1 feed the pending token, then each proposal, every write
        landing in the request's private tail; position-keyed seeds
        make the proposals the same on every replay."""
        b = self.max_batch
        r_ids = np.zeros((b,), np.int32)
        r_pos = np.zeros((b,), np.int32)
        r_lens = np.ones((b,), np.int32)
        for slot, req in running.items():
            ctx = req.prompt_ids + req.output_ids
            back = 2 if req._spec_gap else 1
            r_ids[slot] = ctx[-back]
            r_pos[slot] = len(ctx) - back
            r_lens[slot] = len(ctx) - back + 1
        kw = self._fwd_kwargs()
        _mr.decode_logits(
            self._draft_params, self._to_device(r_ids),
            self._to_device(r_pos), self.cache.k_draft, self.cache.v_draft,
            wide, self._to_device(r_lens), **kw)
        drafts = {slot: [] for slot in running}
        ids, pos, _, lens, temp, topk, seeds = (a.copy() for a in arrays)
        for _ in range(self.spec_k - 1):
            toks = _mr.decode_step(
                self._draft_params, self._to_device(ids),
                self._to_device(pos), self.cache.k_draft,
                self.cache.v_draft, wide, self._to_device(lens), temp,
                topk, seeds, **kw)
            toks = toks.cpu().numpy()      # waits for the device
            for slot, req in running.items():
                d = int(toks[slot])
                drafts[slot].append(d)
                ids[slot] = d
                pos[slot] += 1
                lens[slot] += 1
                seeds[slot] = _mr.seed_for(req.sampling.seed,
                                           int(lens[slot]))
        return drafts

    def _dispatch_verify(self, running, drafts, wide, arrays):
        """ONE target dispatch over all k slots: slot 0 the pending
        token, slots 1.. the draft proposals. Returns [B, k] target
        choices, each sampled with the position-keyed seed the k=1
        engine would use."""
        _, pos, _, lens, temp, topk, _ = arrays
        b, k = self.max_batch, self.spec_k
        v_ids = np.zeros((b, k), np.int32)
        v_seeds = np.zeros((b, k), np.int64)
        for slot, req in running.items():
            ctx = req.prompt_ids + req.output_ids
            v_ids[slot, 0] = ctx[-1]
            v_ids[slot, 1:1 + len(drafts[slot])] = drafts[slot]
            for t in range(k):
                v_seeds[slot, t] = _mr.seed_for(req.sampling.seed,
                                                len(ctx) + t)
        toks = _mr.verify_step(
            self.params, self._to_device(v_ids), self._to_device(pos),
            self.cache.k, self.cache.v, wide, self._to_device(lens), temp,
            topk, v_seeds, **self._fwd_kwargs())
        return toks.cpu().numpy()    # waits for the device

    def _spec_round(self, running, arrays):
        """One speculative round: k draft dispatches propose, one verify
        dispatch checks every proposal. Returns {slot: tokens to emit}:
        the longest agreeing prefix of the proposals plus the first
        corrected token — 1..k tokens, all the target's own
        position-seeded choices."""
        wide = self._to_device(self._wide_tables(arrays[2]))
        drafts = self._draft_propose(running, wide, arrays)
        if _chaos._armed:
            rule = _chaos.hit("serve_spec_verify", batch=len(running),
                              k=self.spec_k)
            if rule is not None:
                # forced draft divergence: verification must reject
                # every corrupted proposal and still emit the target's
                # own token — >= 1 token a round, never a wrong one
                vocab = self.config.vocab_size
                drafts = {slot: [(d + 1) % vocab for d in ds]
                          for slot, ds in drafts.items()}
        toks = self._dispatch_verify(running, drafts, wide, arrays)
        rows = {}
        for slot, req in running.items():
            ds, row = drafts[slot], toks[slot]
            m = 0
            while m < len(ds) and ds[m] == int(row[m]):
                m += 1
            _cmon.stat_add("serve/spec/proposed", len(ds))
            _cmon.stat_add("serve/spec/accepted", m)
            _cmon.hist_observe("serve/hist/accept_len", m + 1)
            # every proposal accepted: one draft K/V position was never
            # written; the next round's realign step writes it
            req._spec_gap = (m == len(ds))
            rows[slot] = [int(t) for t in row[:m + 1]]
        return rows

    # -- token emission / stop conditions ----------------------------
    def _emit(self, req, token, emitted):
        now = time.perf_counter()
        req.output_ids.append(token)
        req.token_times.append(now)
        emitted[req.req_id] = token
        _cmon.stat_add("serve/tokens", 1)
        if len(req.token_times) == 1:
            _cmon.hist_observe("serve/hist/ttft_us",
                               (now - req.arrival_perf) * 1e6)
        else:
            _cmon.hist_observe("serve/hist/itl_us",
                               (now - req.token_times[-2]) * 1e6)
        if _trace._armed:
            _trace.note(req, "decode", n=len(req.output_ids))
        if req.on_token is not None:
            try:
                req.on_token(req.req_id, token)
            except Exception:
                # a client callback must not kill the batch it rides in
                _cmon.stat_add("serve/callback_errors", 1)
        s = req.sampling
        if (req.stop_hit(token)
                or len(req.output_ids) >= s.max_new_tokens
                or req.context_len >= self.max_seq_len):
            self.scheduler.finish(req, state=FINISHED)

    # -- lifecycle: drain / export / failover -------------------------
    @property
    def fenced(self):
        return self._fenced

    def _check_fenced(self):
        if self._fenced:
            raise EngineOverloaded(
                "engine is fenced (its requests were exported after a "
                "wedge/failover) and will never serve again — route to "
                "another replica or build a fresh LLMEngine",
                engine_state=self.state_summary())

    def heartbeat_age(self, now=None):
        """Seconds since the last completed dispatch — the router's
        wedge signal (meaningful only while the engine has work)."""
        return (time.monotonic() if now is None else now) \
            - self.heartbeat

    def load_score(self):
        """Free KV blocks net of queued demand (prompt blocks plus one
        decode lookahead per waiting request): the router's least-loaded
        signal. list() snapshots the deque, so a concurrent admission
        pass cannot break the read."""
        lookahead = self.scheduler._lookahead
        pending = sum(
            self.cache.blocks_for_tokens(r.context_len) + lookahead
            for r in list(self.scheduler.waiting))
        return self.cache.allocator.free_blocks - pending

    def _export(self, req):
        """One request's replayable snapshot: the remaining tokens are a
        pure function of prompt + generated-so-far + sampling (seeds
        keyed by position), so another engine continues it exactly."""
        return {
            "req_id": req.req_id,
            "prompt_ids": list(req.prompt_ids),
            "output_ids": list(req.output_ids),
            "sampling": req.sampling,
            "deadline": req.deadline,
            "evictions": req.evictions,
            "trace_id": req.trace_id,
        }

    def export_requests(self, fence=True):
        """Snapshot and retire every live request (terminal EXPORTED;
        its blocks release now) and, by default, fence the engine.
        RUNNING requests export first in admission order, then the
        waiting queue in FIFO order. The exports must be imported
        somewhere (`import_request`) or the requests are dropped."""
        if fence:
            self._fenced = True
        sched = self.scheduler
        running = sorted(
            sched.running.values(),
            key=lambda r: sched._admitted_at.get(r.req_id, -1))
        exports = []
        for req in running + list(sched.waiting):
            req.on_token = None     # a zombie's emits must not stream
            exp = self._export(req)
            sched.finish(req, state=EXPORTED)
            # after finish: the export carries its own "exported" event
            exp["trace"] = list(req.trace)
            exports.append(exp)
        return exports

    def import_request(self, export, on_token=None, force=False):
        """Re-admit an exported request: its output_ids ride into the
        re-prefill as an eviction's do, so generation continues where
        the exporting engine stopped. `force=True` (router failover)
        bypasses the drain gate and the shed bound. A fenced engine
        refuses even a forced import."""
        self._check_fenced()
        req = Request(export["prompt_ids"], sampling=export["sampling"],
                      on_token=on_token, req_id=export["req_id"],
                      trace_id=export.get("trace_id"))
        req.output_ids = list(export["output_ids"])
        req.deadline = export.get("deadline")
        req.evictions = int(export.get("evictions", 0))
        if export.get("trace"):
            # continue the exporting engine's timeline
            req.trace = list(export["trace"])
        if _trace._armed:
            _trace.note(req, "import", replayed=len(req.output_ids),
                        forced=bool(force))
        self.scheduler.add(req, force=force)
        self._requests[req.req_id] = req
        return req.req_id

    def drain(self, timeout_s=None):
        """Stop admitting (new intake sheds with EngineOverloaded), run
        RUNNING requests to completion, then export what is left: the
        requests still running after `timeout_s` and the whole waiting
        queue. Returns the exports ([] when everything completed). The
        engine stays draining until `resume()`."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with _flight.in_flight("serve_drain", "drain",
                               running=len(self.scheduler.running),
                               waiting=len(self.scheduler.waiting)):
            if _chaos._armed:
                _chaos.hit("serve_drain",
                           running=len(self.scheduler.running))
            self.scheduler.draining = True
            while self.scheduler.running and not self._fenced:
                if deadline is not None and time.monotonic() > deadline:
                    break
                self.step()
            exports = self.export_requests(fence=False)
            if self.emergency_exports:
                # fenced mid-drain by the incident hook, which already
                # exported the in-flight work: return it too
                exports = list(self.emergency_exports) + exports
                self.emergency_exports = None
        _cmon.stat_add("serve/drains", 1)
        _flight.record("serve_drain_done", exported=len(exports))
        return exports

    def resume(self):
        """Re-open admission after a drain. A fenced engine cannot
        resume: build a fresh one."""
        if self._fenced:
            raise RuntimeError(
                "cannot resume a fenced engine — its requests were "
                "exported after a wedge/failover; create a fresh "
                "LLMEngine")
        self.scheduler.draining = False

    # -- emergency drain-and-export ----------------------------------
    def arm_incident_export(self):
        """Register `_incident_export` as a flight incident hook: on an
        incident, fence this engine and export its live requests into
        `emergency_exports` for a router or operator to replay."""
        if not self._incident_armed:
            _flight.add_incident_hook(self._incident_export)
            self._incident_armed = True
        return self

    def disarm_incident_export(self):
        if self._incident_armed:
            _flight.remove_incident_hook(self._incident_export)
            self._incident_armed = False

    @contextlib.contextmanager
    def _dispatch_span(self, kind, name, **data):
        """A dispatch's flight span, noting the thread that runs it: a
        watchdog's stuck entry names that thread."""
        self._dispatch_tid = threading.get_ident()
        try:
            with _flight.in_flight(kind, name, **data):
                yield
        finally:
            self._dispatch_tid = None

    def _incident_export(self, reason):
        """The hook's body: an engine with live work fences and exports;
        an idle one is untouched. Under a watchdog fire (`reason`
        carries its stuck entries) only the engine whose own dispatch
        is stuck does. No dispatch runs here."""
        if self._fenced or not self.scheduler.has_work():
            return
        stuck = getattr(reason, "stuck", None)
        if stuck is not None and not any(
                e.get("kind") in ("serve_prefill", "serve_decode")
                and e.get("tid") == self._dispatch_tid for e in stuck):
            return
        self.emergency_exports = self.export_requests(fence=True)
        _cmon.stat_add("serve/drains", 1)
        _flight.record("serve_drain_done",
                       exported=len(self.emergency_exports),
                       emergency=True, reason=str(reason))

    # -- trace spool -------------------------------------------------
    def export_traces(self):
        """Trace spool (schema "paddle_tpu.trace/1") over every
        retained request's timeline; live requests show their story so
        far."""
        return _trace.export_requests(self._requests.values())

    def dump_traces(self, path):
        """Write export_traces() as JSON; returns the path."""
        import json

        with open(path, "w") as f:
            json.dump(self.export_traces(), f, default=str)
        return path

    # -- accounting --------------------------------------------------
    def state_summary(self):
        """Host-side snapshot of where serving stands."""
        sched = self.scheduler
        return {
            "waiting": len(sched.waiting),
            "running": len(sched.running),
            "draining": sched.draining,
            "fenced": self._fenced,
            "queue_depth": len(sched.waiting),
            "free_blocks": self.cache.allocator.free_blocks,
            "used_blocks": self.cache.allocator.used_blocks,
            "oom_streak": self._oom_streak,
            "heartbeat_age_s": round(self.heartbeat_age(), 3),
            "spec_k": self.spec_k,
            "prefix_cache": self.prefix_cache,
        }

    def check_drained(self):
        """Zero-leak audit: blocks still owned by requests that are no
        longer live ({} when clean)."""
        live = [r.req_id for r in self._requests.values()
                if not r.finished]
        return self.cache.allocator.audit_leaks(live)
