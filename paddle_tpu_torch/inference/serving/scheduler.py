"""Continuous-batching scheduler (admit / evict / preempt between
decode dispatches), the port of
`paddle_tpu/inference/serving/scheduler.py`.

The decode step is ONE fixed-shape dispatch over `max_batch` slots, and
the scheduler's job is keeping its slots full — requests join and leave
BETWEEN dispatches, never inside one:

  * FIFO admission: `add()` queues, `schedule()` admits while a batch
    slot AND the KV pool's admission check (prompt blocks not already
    cached, plus a decode lookahead of ceil(k / block_size) blocks for
    a speculative width k) both say yes. With prefix caching the cache
    maps the request's cached prefix blocks copy-on-write
    (`PagedKVCache.admit`) and `Request.cached_tokens` tells the
    engine how much of the context to skip.
  * Block growth: a running request crossing a block boundary asks
    `ensure_capacity()` for its next block(s) before the dispatch that
    writes into them (up to k tokens ahead under speculation).
  * Preemption: when the pool can't grow a running request (or the
    dispatch runs out of memory), the YOUNGEST running request is
    evicted: its blocks free immediately, its prompt + generated-so-far
    re-queues at the FRONT, and a later admission re-prefills it.
    Sampling seeds are keyed by position, so the replay is token-exact.
    Eviction drops only the request's own references: a block it shares
    with another request stays live for that one.

The JAX scheduler's SLO ring (deadlines, priorities, queue bound and
load shedding) and its static-batching twin are not ported yet.

Counters: `serve/evictions`, `serve/queue_depth` (gauge), and the
queue-wait / e2e histograms.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque

from ...core import monitor as _cmon

__all__ = ["SamplingParams", "Request", "Scheduler", "WAITING",
           "RUNNING", "FINISHED", "ABORTED"]

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
ABORTED = "aborted"

_TERMINAL = (FINISHED, ABORTED)


def _int_like(v):
    """True for ints and integer numpy scalars; False for bools,
    floats and strings."""
    if isinstance(v, bool):
        return False
    if isinstance(v, int):
        return True
    return (hasattr(v, "dtype")
            and getattr(v.dtype, "kind", "") in ("i", "u")
            and getattr(v, "ndim", 1) == 0)


class SamplingParams:
    """Per-request generation controls. Every field is validated here,
    at intake, not inside a dispatch."""

    def __init__(self, max_new_tokens=16, temperature=0.0, top_k=0,
                 eos_token_id=None, stop_token_ids=(), seed=0):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if not _int_like(top_k):
            raise ValueError(
                f"top_k must be an int, got {type(top_k).__name__} "
                f"({top_k!r})")
        if top_k < 0:
            raise ValueError(
                f"top_k must be >= 0 (0 = no filtering), got {top_k}")
        if not _int_like(seed):
            raise ValueError(
                f"seed must be an int, got {type(seed).__name__} "
                f"({seed!r})")
        if eos_token_id is not None and not _int_like(eos_token_id):
            raise ValueError(
                f"eos_token_id must be an int or None, got "
                f"{type(eos_token_id).__name__} ({eos_token_id!r})")
        stop_token_ids = tuple(stop_token_ids)
        for t in stop_token_ids:
            if not _int_like(t):
                raise ValueError(
                    f"stop_token_ids must be ints, got "
                    f"{type(t).__name__} ({t!r})")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.stop_token_ids = tuple(int(t) for t in stop_token_ids)
        self.seed = int(seed)

    def __repr__(self):
        return (f"SamplingParams(max_new_tokens="
                f"{self.max_new_tokens}, temperature="
                f"{self.temperature}, top_k={self.top_k})")


class Request:
    """One generation request moving through the engine."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, sampling=None, on_token=None,
                 req_id=None):
        self.req_id = (f"req-{next(Request._ids)}"
                       if req_id is None else str(req_id))
        self.prompt_ids = [int(t) for t in prompt_ids]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.sampling = sampling or SamplingParams()
        self.on_token = on_token
        self.state = WAITING
        self.output_ids = []
        self.slot = None           # decode batch slot while RUNNING
        self.evictions = 0
        # tokens covered by shared prefix blocks at the LAST admission:
        # the engine's prefill skips them (tail-only prefill)
        self.cached_tokens = 0
        # speculative-decode realign flag: True after a round accepted
        # every proposal (one draft-KV position is then unwritten; the
        # next round's realign step writes it)
        self._spec_gap = False
        self.token_times = []      # perf_counter per emitted token
        # arrival on the token_times clock: TTFT, queue wait, e2e
        self.arrival_perf = time.perf_counter()
        self._queue_waited = False  # first-admission wait observed

    @property
    def context_len(self):
        """Tokens whose K/V must be live for the next decode."""
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def finished(self):
        return self.state in _TERMINAL

    def stop_hit(self, token):
        s = self.sampling
        return token == s.eos_token_id or token in s.stop_token_ids

    def __repr__(self):
        return (f"<Request {self.req_id} {self.state} "
                f"prompt={len(self.prompt_ids)} "
                f"out={len(self.output_ids)}>")


class Scheduler:
    """Admission/eviction policy over one PagedKVCache + a fixed
    decode batch width."""

    def __init__(self, cache, max_batch, max_seq_len, spec_tokens=1):
        self.cache = cache
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        # speculative width: one verify dispatch can append up to
        # `spec_tokens` tokens, so admission's decode lookahead and
        # ensure_capacity's growth both cover k, or the verify dispatch
        # right after an admission evicts what was just admitted
        self.spec_tokens = max(1, int(spec_tokens))
        self._lookahead = max(          # decode lookahead, in blocks
            1, math.ceil(self.spec_tokens / cache.block_size))
        self.waiting = deque()
        self.running = {}          # slot -> Request
        self._admit_seq = itertools.count()
        self._admitted_at = {}     # req_id -> admission ordinal

    # -- queue -------------------------------------------------------
    def add(self, request):
        """Queue a request (FIFO)."""
        if request.context_len >= self.max_seq_len:
            raise ValueError(
                f"{request.req_id}: prompt ({request.context_len}) "
                f"leaves no room under max_seq_len={self.max_seq_len}")
        request.state = WAITING
        self.waiting.append(request)
        self._sync_depth()
        return request

    def _requeue_front(self, request):
        request.state = WAITING
        request.slot = None
        self.waiting.appendleft(request)
        self._sync_depth()

    def _sync_depth(self):
        _cmon.stat_set("serve/queue_depth", len(self.waiting))

    def has_work(self):
        return bool(self.waiting or self.running)

    # -- admission ---------------------------------------------------
    def _free_slots(self):
        return [s for s in range(self.max_batch)
                if s not in self.running]

    def schedule(self, on_admit=None):
        """Admit as many waiting requests as slots + pool allow.
        `on_admit(req)` runs IMMEDIATELY after each admission (the
        engine prefills there), so no admitted request is ever left
        with unwritten K/V."""
        admitted = []
        slots = self._free_slots()
        while slots and self.waiting:
            req = self.waiting[0]
            ctx_ids = req.prompt_ids + req.output_ids
            cached_blocks, _ = self.cache.probe_prefix(ctx_ids)
            if not self.cache.can_admit(
                    req.context_len, lookahead_blocks=self._lookahead,
                    cached_blocks=cached_blocks):
                break
            self.waiting.popleft()
            cached = self.cache.admit(req.req_id, ctx_ids)
            if cached is None:     # the pool cannot cover the remainder
                self._requeue_front(req)
                break
            req.cached_tokens = cached
            req.state = RUNNING
            req.slot = slots.pop(0)
            self.running[req.slot] = req
            self._admitted_at[req.req_id] = next(self._admit_seq)
            admitted.append(req)
            if not req._queue_waited:
                # arrival -> FIRST admission only: a re-admission
                # after eviction is recompute churn, not queueing
                req._queue_waited = True
                _cmon.hist_observe(
                    "serve/hist/queue_wait_us",
                    (time.perf_counter() - req.arrival_perf) * 1e6)
            if on_admit is not None:
                on_admit(req)
        self._sync_depth()
        return admitted

    # -- block growth / preemption -----------------------------------
    def ensure_capacity(self, request, new_tokens=None):
        """Grow the request's table to cover its next `new_tokens`
        tokens (default: the speculative width, since a verify dispatch
        may land up to k at once), evicting other requests under pool
        pressure. False when the request itself had to be evicted — or
        was ALREADY evicted by an earlier grow in the same pass
        (growing a request no dispatch covers would strand its new
        blocks)."""
        if self.running.get(request.slot) is not request:
            return False
        if new_tokens is None:
            new_tokens = self.spec_tokens
        need = self.cache.blocks_for_tokens(
            request.context_len + new_tokens)
        while len(self.cache.allocator.owned(request.req_id)) < need:
            if self.cache.allocator.alloc(request.req_id, 1) is not None:
                continue
            victim = self._pick_victim(exclude=request)
            if victim is None:
                self.evict(request)
                return False
            self.evict(victim)
        return True

    def _pick_victim(self, exclude=None):
        """Eviction victim: the youngest admission (the vLLM recompute
        policy — it has the least progress to replay)."""
        cands = [r for r in self.running.values() if r is not exclude]
        if not cands:
            return None
        return max(cands,
                   key=lambda r: self._admitted_at.get(r.req_id, -1))

    def evict(self, request):
        """Preempt a running request: free its blocks NOW, requeue it
        at the front with its generated tokens kept (re-prefill
        rebuilds the K/V it lost)."""
        self.running.pop(request.slot, None)
        self.cache.allocator.release(request.req_id)
        self._admitted_at.pop(request.req_id, None)
        request.evictions += 1
        self._requeue_front(request)
        _cmon.stat_add("serve/evictions", 1)

    # -- completion --------------------------------------------------
    def finish(self, request, state=FINISHED):
        """Terminal transition from ANY state: releases blocks and
        removes a still-queued entry from the waiting deque."""
        was_waiting = request.state == WAITING
        request.state = state
        if request.slot is not None:
            self.running.pop(request.slot, None)
            request.slot = None
        if was_waiting and request in self.waiting:
            self.waiting.remove(request)
            self._sync_depth()
        self.cache.allocator.release(request.req_id)
        self._admitted_at.pop(request.req_id, None)
        if state == FINISHED:
            _cmon.hist_observe(
                "serve/hist/e2e_us",
                (time.perf_counter() - request.arrival_perf) * 1e6)

    def abort(self, request):
        """Cancel wherever it is; blocks release immediately."""
        self.finish(request, state=ABORTED)
