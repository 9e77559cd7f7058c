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
    dispatch runs out of memory), a victim is evicted: its blocks free
    immediately, its prompt + generated-so-far re-queues at the FRONT,
    and a later admission re-prefills it. Sampling seeds are keyed by
    position, so the replay is token-exact.
  * `static_batching=True` degrades admission to serve-a-batch,
    drain-a-batch: nothing is admitted while any request runs.

The SLO ring:

  * DEADLINES — `SamplingParams(deadline_s=)` stamps an absolute expiry
    at arrival. Every admission pass (and the shed check) first sweeps
    the waiting queue and retires expired entries to the terminal
    `EXPIRED` state (`serve/deadline_aborts`). RUNNING requests are
    never deadline-killed: they already paid their prefill.
  * LOAD SHEDDING — `max_queue` (default `PADDLE_SERVE_MAX_QUEUE`, 0 =
    unbounded) bounds the waiting queue; `add()` on a full queue, or on
    a draining scheduler, raises `EngineOverloaded` (`serve/shed`).
    Expired entries are swept before the bound is judged. `add(force=
    True)` (failover re-admission) and eviction requeues bypass both.
  * PRIORITY-AWARE EVICTION — victims go lowest `priority` first, then
    the latest deadline, then the youngest admitted.

Counters: `serve/evictions`, `serve/queue_depth` (gauge, per process as
in the JAX package), `serve/shed`, `serve/deadline_aborts`, and the
queue-wait / e2e histograms; every state change also lands in the
flight ring and, when tracing is armed, in the request's timeline.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque

from ...core import monitor as _cmon
from ...monitor import chaos as _chaos
from ...monitor import flight as _flight
from ...monitor import trace as _trace

__all__ = ["SamplingParams", "Request", "Scheduler",
           "EngineOverloaded", "env_max_queue", "env_deadline_s",
           "WAITING", "RUNNING", "FINISHED", "ABORTED", "EXPIRED",
           "EXPORTED"]

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
ABORTED = "aborted"
EXPIRED = "expired"      # deadline passed while WAITING
EXPORTED = "exported"    # handed off for replay on another engine

_TERMINAL = (FINISHED, ABORTED, EXPIRED, EXPORTED)


def env_max_queue():
    """PADDLE_SERVE_MAX_QUEUE — waiting-queue bound before `add()`
    sheds with EngineOverloaded (default 0 = unbounded)."""
    return max(0, _flight._env_int("PADDLE_SERVE_MAX_QUEUE", 0))


def env_deadline_s():
    """PADDLE_SERVE_DEADLINE_S — default per-request deadline in
    seconds (default 0 = no deadline)."""
    return max(0.0, _flight._env_float("PADDLE_SERVE_DEADLINE_S",
                                       0.0))


class EngineOverloaded(RuntimeError):
    """Load shedding: the waiting queue is at `max_queue` (or the
    engine is draining) — the caller should back off and retry, or
    route to another replica. Carries the shedding engine's state
    summary in `.engine_state` when the engine raised it."""

    def __init__(self, msg, engine_state=None):
        super().__init__(msg)
        self.engine_state = engine_state or {}


def _int_like(v):
    """True for ints and integer numpy scalars; False for bools,
    floats and strings."""
    if isinstance(v, bool):
        return False
    if isinstance(v, int):
        return True
    # numpy integer scalars without importing numpy here
    return (hasattr(v, "dtype")
            and getattr(v.dtype, "kind", "") in ("i", "u")
            and getattr(v, "ndim", 1) == 0)


class SamplingParams:
    """Per-request generation controls plus the SLO fields:
    `deadline_s` (wall-clock budget from arrival; expired WAITING
    requests retire as EXPIRED at admission; default
    `PADDLE_SERVE_DEADLINE_S`) and `priority` (higher survives eviction
    longer). Every field is validated here, at intake, not inside a
    dispatch."""

    def __init__(self, max_new_tokens=16, temperature=0.0, top_k=0,
                 eos_token_id=None, stop_token_ids=(), seed=0,
                 deadline_s=None, priority=0):
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
        if deadline_s is None:
            deadline_s = env_deadline_s() or None
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 (None = no deadline), got "
                f"{deadline_s}")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.stop_token_ids = tuple(int(t) for t in stop_token_ids)
        self.seed = int(seed)
        self.deadline_s = (None if deadline_s is None
                           else float(deadline_s))
        self.priority = int(priority)

    def __repr__(self):
        return (f"SamplingParams(max_new_tokens="
                f"{self.max_new_tokens}, temperature="
                f"{self.temperature}, top_k={self.top_k}, "
                f"priority={self.priority})")


class Request:
    """One generation request moving through the engine."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, sampling=None, on_token=None,
                 req_id=None, trace_id=None):
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
        # tokens covered by shared prefix blocks at LAST admission —
        # the engine's prefill skips them (tail-only prefill)
        self.cached_tokens = 0
        # speculative-decode realign flag: True after a round accepts
        # every proposal (one draft-KV position is then stale; the
        # next round's realign step rewrites it)
        self._spec_gap = False
        self.token_times = []      # perf_counter per emitted token
        self.arrival = time.monotonic()
        # TTFT/e2e latency anchor on the SAME clock as token_times
        # (perf_counter); `arrival` stays the monotonic deadline/
        # queue-wait clock — mixing the two would skew every gap
        self.arrival_perf = time.perf_counter()
        # absolute expiry (monotonic); None = no SLO. Survives
        # eviction/export so a replayed request keeps its budget.
        self.deadline = (self.arrival + self.sampling.deadline_s
                         if self.sampling.deadline_s else None)
        # per-request trace: trace_id minted at intake (add_request /
        # submit build the Request there) and kept through eviction,
        # export and import; `trace` is the bounded stage timeline
        # monitor.trace.note() appends to
        self.trace = []
        self.trace_dropped = 0
        self.trace_id = (trace_id if trace_id is not None
                         else (_trace.mint() if _trace._armed
                               else None))
        if _trace._armed:
            _trace.note(self, "add", prompt=len(self.prompt_ids))
        self._queue_waited = False  # first-admission wait observed

    @property
    def priority(self):
        return self.sampling.priority

    def expired(self, now=None):
        return (self.deadline is not None
                and (time.monotonic() if now is None else now)
                > self.deadline)

    @property
    def context_len(self):
        """Tokens whose K/V must be live for the next decode."""
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def finished(self):
        return self.state in _TERMINAL

    def stop_hit(self, token):
        s = self.sampling
        return (token == s.eos_token_id
                or token in s.stop_token_ids)

    def __repr__(self):
        return (f"<Request {self.req_id} {self.state} "
                f"prompt={len(self.prompt_ids)} "
                f"out={len(self.output_ids)}>")


class Scheduler:
    """Admission/eviction policy over one PagedKVCache + a fixed
    decode batch width."""

    def __init__(self, cache, max_batch, max_seq_len,
                 static_batching=False, max_queue=None,
                 spec_tokens=1):
        self.cache = cache
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.static_batching = bool(static_batching)
        # speculative width: one verify dispatch can append up to
        # `spec_tokens` tokens, so admission's decode lookahead and
        # ensure_capacity's growth target must both cover k — or the
        # verify dispatch right after admission evicts what was just
        # admitted
        self.spec_tokens = max(1, int(spec_tokens))
        self._lookahead = max(
            1, math.ceil(self.spec_tokens / cache.block_size))
        self.max_queue = (env_max_queue() if max_queue is None
                          else max(0, int(max_queue)))
        self.draining = False      # drain(): stop admitting
        self.waiting = deque()
        self.running = {}          # slot -> Request
        self._admit_seq = itertools.count()
        self._admitted_at = {}     # req_id -> admission ordinal

    # -- queue -------------------------------------------------------
    def add(self, request, force=False):
        """Queue a request. `force=True` bypasses the drain gate and
        the shed bound — failover re-admission only: an exported
        request already holds an admission promise from the replica
        that lost it, and dropping it to a full queue would break the
        router's every-request-completes contract."""
        if request.context_len >= self.max_seq_len:
            raise ValueError(
                f"{request.req_id}: prompt ({request.context_len}) "
                f"leaves no room under max_seq_len="
                f"{self.max_seq_len}")
        if force:
            request.state = WAITING
            self.waiting.append(request)
            self._sync_depth()
            return request
        if self.draining:
            _cmon.stat_add("serve/shed", 1)
            _flight.record("serve_shed", req=request.req_id,
                           reason="draining")
            raise EngineOverloaded(
                f"{request.req_id}: engine is draining — retry on "
                "another replica or after resume()")
        if self.max_queue and len(self.waiting) >= self.max_queue:
            # sweep corpses first: a queue full of already-expired
            # entries must not shed live traffic
            self.expire_waiting()
            if len(self.waiting) >= self.max_queue:
                _cmon.stat_add("serve/shed", 1)
                _flight.record("serve_shed", req=request.req_id,
                               reason="queue_full",
                               depth=len(self.waiting))
                raise EngineOverloaded(
                    f"{request.req_id}: waiting queue full "
                    f"({len(self.waiting)} >= max_queue="
                    f"{self.max_queue}) — load shed")
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

    def expire_waiting(self, now=None):
        """Retire WAITING requests whose deadline passed (EXPIRED
        terminal state, `serve/deadline_aborts`). Runs at the head of
        every admission pass AND before the shed bound is judged —
        admission is the last point a dead-on-arrival request can be
        dropped for free (no pool blocks, no prefill). Returns the
        expired requests."""
        now = time.monotonic() if now is None else now
        expired = [r for r in self.waiting if r.expired(now)]
        for req in expired:
            self.waiting.remove(req)
            self.finish(req, state=EXPIRED)
            _cmon.stat_add("serve/deadline_aborts", 1)
        if expired:
            self._sync_depth()
        return expired

    def schedule(self, on_admit=None):
        """Admit as many waiting requests as slots + pool allow.
        `on_admit(req)` runs IMMEDIATELY after each admission (the
        engine prefills there), so no admitted request is ever left
        with unwritten K/V. Expired waiting requests retire first; a
        draining scheduler admits nothing (running requests still
        finish). Static-batching mode only admits into an EMPTY
        batch."""
        admitted = []
        self.expire_waiting()
        if self.draining:
            return admitted
        if self.static_batching and self.running:
            return admitted
        slots = self._free_slots()
        while slots and self.waiting:
            req = self.waiting[0]
            need_tokens = req.context_len
            ctx_ids = req.prompt_ids + req.output_ids
            cached_blocks, _ = self.cache.probe_prefix(ctx_ids)
            if not self.cache.can_admit(
                    need_tokens, lookahead_blocks=self._lookahead,
                    cached_blocks=cached_blocks):
                break
            if _chaos._armed:
                # slow-client / admission faults land here, BEFORE the
                # request takes any pool resources
                _chaos.hit("serve_admit", req=req.req_id)
            self.waiting.popleft()
            nblocks = self.cache.blocks_for_tokens(need_tokens)
            cached = self.cache.admit(req.req_id, ctx_ids)
            if cached is None:     # raced the lookahead margin
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
                    (time.monotonic() - req.arrival) * 1e6)
            _flight.record("serve_admit", req=req.req_id,
                           slot=req.slot, blocks=nblocks)
            if _trace._armed:
                _trace.note(req, "admit", slot=req.slot,
                            blocks=nblocks, readmit=req.evictions)
            if on_admit is not None:
                on_admit(req)
        self._sync_depth()
        return admitted

    # -- block growth / preemption -----------------------------------
    def ensure_capacity(self, request, new_tokens=None):
        """Grow the request's table to cover its next `new_tokens`
        tokens (default: the scheduler's speculative width — a
        verify dispatch may land up to k at once); evicts other
        requests under pool pressure. False when the request itself
        had to be evicted (pool too small even after evicting
        everyone younger) — or was ALREADY evicted by an earlier
        grow in the same pass (growing a non-running request would
        strand blocks no dispatch covers)."""
        if self.running.get(request.slot) is not request:
            return False
        if new_tokens is None:
            new_tokens = self.spec_tokens
        need = self.cache.blocks_for_tokens(
            request.context_len + new_tokens)
        while len(self.cache.allocator.owned(request.req_id)) < need:
            got = self.cache.allocator.alloc(request.req_id, 1)
            if got is not None:
                continue
            victim = self._pick_victim(exclude=request)
            if victim is None:
                self.evict(request)
                return False
            self.evict(victim)
        return True

    def _pick_victim(self, exclude=None):
        """Eviction victim, worst SLO position first: lowest
        `priority`, then latest deadline (no deadline = infinitely
        late — the most slack loses the least by recomputing), then
        youngest-admitted (the vLLM recompute policy as the final
        tiebreak)."""
        cands = [r for r in self.running.values() if r is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: (
            -r.priority,
            r.deadline if r.deadline is not None else math.inf,
            self._admitted_at.get(r.req_id, -1)))

    def evict(self, request):
        """Preempt a running request: free its blocks NOW, requeue it
        at the front with its generated tokens kept (re-prefill will
        rebuild the KV it lost)."""
        self.running.pop(request.slot, None)
        self.cache.allocator.release(request.req_id)
        self._admitted_at.pop(request.req_id, None)
        request.cached_tokens = 0   # re-admission re-probes
        request._spec_gap = False   # re-prefill rewrites draft KV
        request.evictions += 1
        self._requeue_front(request)
        _cmon.stat_add("serve/evictions", 1)
        _flight.record("serve_evict", req=request.req_id,
                       evictions=request.evictions)
        if _trace._armed:
            _trace.note(request, "evict",
                        evictions=request.evictions,
                        kept_tokens=len(request.output_ids))

    # -- completion --------------------------------------------------
    def finish(self, request, state=FINISHED):
        """Terminal transition from ANY state: releases blocks, and
        removes a still-queued entry so no terminal path
        (finish/abort/expire/export) can leave a corpse in the
        waiting deque with `serve/queue_depth` overcounting — the
        router failover hot path aborts WAITING requests. The deque
        scan is gated on the WAITING state (only add/_requeue_front
        put requests there), so the common RUNNING-completion path
        stays O(1) under a deep backlog."""
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
            # e2e latency: arrival at THIS engine -> completion, on
            # the token_times clock. A failover replay re-anchors at
            # import (each engine leg is its own observation; the
            # trace timeline carries the whole story)
            _cmon.hist_observe(
                "serve/hist/e2e_us",
                (time.perf_counter() - request.arrival_perf) * 1e6)
        _flight.record("serve_finish", req=request.req_id,
                       tokens=len(request.output_ids), state=state)
        if _trace._armed:
            _trace.note(request, state,
                        tokens=len(request.output_ids))

    def abort(self, request):
        """Cancel wherever it is; blocks release immediately and a
        queued entry leaves the waiting deque (+ depth gauge) in the
        same call."""
        self.finish(request, state=ABORTED)
