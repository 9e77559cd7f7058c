"""Multi-replica serving router with health-checked failover: the port
of `paddle_tpu/inference/serving/router.py`.

A `Router` owns N `LLMEngine` replicas, each stepped by its own worker
thread. A request is a pure function of (prompt, tokens so far,
sampling) — the sampling seeds are keyed by position — so a replica
lost mid-generation replays its requests TOKEN-IDENTICALLY on a
survivor:

    router = Router(model, replicas=2)          # PADDLE_SERVE_REPLICAS
    outs = router.generate(prompts, sampling)   # survives a replica
    router.drain(); router.shutdown()

Engine keyword arguments (`device=` included) pass through to every
replica, so all replicas of one router live on one device.

Routing — least-loaded by free KV blocks net of queued demand
(`LLMEngine.load_score()`), lowest index on ties. A replica that sheds
(`EngineOverloaded`) falls through to the next; only when EVERY healthy
replica sheds does the router shed to the caller.

Health — each engine stamps `heartbeat` at every completed dispatch
(and the router re-stamps it when an idle replica gets work). The wait
loop marks a replica DEAD when its worker thread raised, its engine was
fenced by the incident hook, or it has live work with a heartbeat older
than `heartbeat_timeout_s` (`PADDLE_SERVE_HEARTBEAT_S`, default 10 s):
a wedged dispatch stops the clock. Set the timeout above the slowest
single dispatch, a cold first one included (on a fresh tree that is the
kernels' build). A heartbeat timeout never retires the LAST healthy
replica. `serve/replica/<i>/healthy` gauges track the fleet.

Failover — the dead replica is FENCED (a zombie thread waking later
no-ops), its live requests are exported and imported on the
least-loaded survivors with `force=True`, bypassing drain gates and
shed bounds: an exported request already holds an admission promise.
`serve/failovers` counts them, with a `serve_failover` flight span. If
no healthy replica remains, the unplaced exports are kept in
`orphan_exports` (never dropped) and the wait raises.

At boot the fleet negotiates ONE speculative config: the weakest
replica's window (`Router.spec_k`, `serve/spec/fleet_k`).

Thread discipline: each worker wraps `engine.step()` in its replica's
`step_lock`; router-side surgery (intake, abort, export, drain) takes
the same lock with a BOUNDED acquire (`_step_guard`): a thread wedged
inside a dispatch holds the lock forever, and failover works around the
wedge rather than joining it. Worker threads are daemons, and
`shutdown()` joins each with a timeout. On the card every replica's
worker dispatches on the current stream of the engines' device; no
worker calls `torch.cuda.set_device`.

Monitor hooks (JAX :167, 266-267, 597-598): the constructor calls
`server.maybe_auto_serve` (PADDLE_MONITOR_SERVE), `_pick_replica` hits
the `serve_route` chaos site before touching any replica, and `drain`
the `serve_drain` site inside its flight span.
"""
from __future__ import annotations

import contextlib
import threading
import time

from ...core import monitor as _cmon
from ...monitor import chaos as _chaos
from ...monitor import flight as _flight
from ...monitor import trace as _trace
from .engine import EngineTimeout, LLMEngine
from .scheduler import EngineOverloaded

__all__ = ["Router", "env_replicas", "env_heartbeat_s"]


def env_replicas():
    """PADDLE_SERVE_REPLICAS — router replica count (default 1)."""
    return max(1, _flight._env_int("PADDLE_SERVE_REPLICAS", 1))


def env_heartbeat_s():
    """PADDLE_SERVE_HEARTBEAT_S — seconds without a completed
    dispatch before a busy replica is declared wedged (default 10)."""
    return max(0.1, _flight._env_float("PADDLE_SERVE_HEARTBEAT_S",
                                       10.0))


class _Replica:
    """One engine + its worker thread + its health flags."""

    def __init__(self, idx, engine):
        self.idx = idx
        self.engine = engine
        self.thread = None
        self.healthy = True
        self.dead = False          # failover completed — terminal
        self.error = None          # exception that killed the worker
        self.work = threading.Event()
        self.step_lock = threading.Lock()

    def load_score(self):
        return self.engine.load_score()


@contextlib.contextmanager
def _step_guard(rep, timeout):
    """Bounded acquire of a replica's step lock; yields whether the
    lock was actually taken. Every router-side touch of a replica's
    scheduler/allocator goes through this ONE helper so each call
    site states its on-timeout policy explicitly — intake/abort back
    off (the worker owns the engine), failover/drain proceed (the
    engine is fenced or quiesced and the holder is presumed wedged
    asleep inside a dispatch)."""
    locked = rep.step_lock.acquire(timeout=timeout)
    try:
        yield locked
    finally:
        if locked:
            rep.step_lock.release()


class _Record:
    """Router-side view of one request: survives failover by
    re-pointing `req` at the replaying replica's Request."""

    __slots__ = ("req_id", "on_token", "replica", "req")

    def __init__(self, req_id, on_token, replica, req):
        self.req_id = req_id
        self.on_token = on_token
        self.replica = replica
        self.req = req


class Router:
    """N-replica front end: least-loaded routing, heartbeat health,
    deterministic failover, graceful drain."""

    def __init__(self, model, replicas=None, heartbeat_timeout_s=None,
                 poll_s=0.002, incident_export=True, **engine_kwargs):
        n = int(replicas or env_replicas())
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        self.heartbeat_timeout_s = (
            env_heartbeat_s() if heartbeat_timeout_s is None
            else float(heartbeat_timeout_s))
        self._poll_s = float(poll_s)
        from ...monitor import server as _mserver

        _mserver.maybe_auto_serve("serving.Router")
        self._lock = threading.RLock()
        self._records = {}         # req_id -> _Record
        self._stop = False
        self._draining = False
        # kept for elastic scale-up: spawn_replica()
        # rebuilds an engine from the SAME recipe, so an autoscaled
        # replica is configured identically to the boot fleet
        self._model = model
        self._engine_kwargs = dict(engine_kwargs)
        self._incident_export = bool(incident_export)
        # exports that could not be placed anywhere (no healthy
        # replica left) — retained, never silently dropped
        self.orphan_exports = []
        self._replicas = []
        for i in range(n):
            eng = LLMEngine(model, **engine_kwargs)
            if incident_export:
                eng.arm_incident_export()
            rep = _Replica(i, eng)
            self._replicas.append(rep)
            _cmon.stat_set(f"serve/replica/{i}/healthy", 1)
        # -- spec-config negotiation ---------------------------------
        # Failover replays any request on any survivor, and while
        # token identity holds at ANY spec window by contract, the
        # fleet must still agree on ONE config or serve/spec/*
        # telemetry and the k-aware admission promise stop meaning
        # anything. All replicas are built from the same kwargs, so
        # disagreement can only come from per-engine clamping (model
        # too shallow for a draft twin, window capped at the kernel
        # limit) — negotiate down to the weakest replica and record
        # the concession instead of serving a lopsided fleet.
        ks = sorted({r.engine.spec_k for r in self._replicas})
        pcs = {bool(r.engine.prefix_cache) for r in self._replicas}
        self.spec_k = ks[0]
        self.prefix_cache = pcs == {True}
        if len(ks) > 1 or len(pcs) > 1:
            _flight.record("serve_spec_negotiate",
                           spec_ks=ks, negotiated=self.spec_k,
                           prefix=sorted(pcs))
        if self.spec_k > 1:
            _cmon.stat_set("serve/spec/fleet_k", self.spec_k)
        for rep in self._replicas:
            t = threading.Thread(
                target=self._replica_loop, args=(rep,),
                name=f"serve-replica-{rep.idx}", daemon=True)
            rep.thread = t
            t.start()
        # observability -> capacity loop: None unless
        # PADDLE_SERVE_AUTOSCALE arms it — zero listeners, zero
        # serve/autoscale/* stats, identical serving otherwise
        from . import autoscaler as _autoscaler

        self.autoscaler = _autoscaler.maybe_autoscale(self)

    # -- worker loop -------------------------------------------------
    def _replica_loop(self, rep):
        eng = rep.engine
        while not self._stop:
            if rep.dead or eng.fenced:
                return
            idle = (not eng.has_unfinished()
                    or (eng.scheduler.draining
                        and not eng.scheduler.running))
            if idle:
                rep.work.clear()
                # re-check after clear so a submit racing the clear
                # costs one bounded wait, never a lost wakeup
                if not eng.has_unfinished() \
                        or (eng.scheduler.draining
                            and not eng.scheduler.running):
                    rep.work.wait(timeout=0.05)
                continue
            try:
                with rep.step_lock:
                    if rep.dead or eng.fenced:
                        return
                    eng.step()
            except Exception as e:
                # the wait loop turns this into a failover; flags
                # only (no router lock from a worker — one-way lock
                # order: router lock -> step_lock)
                rep.error = e
                rep.healthy = False
                _cmon.stat_set(
                    f"serve/replica/{rep.idx}/healthy", 0)
                _flight.record("serve_replica_error",
                               replica=rep.idx,
                               error=f"{type(e).__name__}: {e}")
                return

    # -- routing -----------------------------------------------------
    def _live(self):
        """Replicas that can accept work: healthy, not failed over,
        and not fenced (a watchdog-fenced engine no-ops step() — a
        request routed there before the next health pass would be
        stranded on a dead queue)."""
        return [r for r in self._replicas
                if r.healthy and not r.dead
                and not r.engine.fenced]

    def _pick_replica(self, exclude=()):
        """Healthy replica with the most free KV blocks (least
        loaded), lowest index on ties — deterministic."""
        cands = [r for r in self._live() if r not in exclude]
        if not cands:
            raise RuntimeError(
                "no healthy serving replicas "
                f"({len(self._replicas)} configured, all dead)")
        if _chaos._armed:
            _chaos.hit("serve_route", candidates=len(cands))
        return max(cands, key=lambda r: (r.load_score(), -r.idx))

    def submit(self, prompt_ids, sampling=None, on_token=None,
               req_id=None):
        """Route one request to the least-loaded healthy replica;
        returns its req_id. A replica that sheds (queue full) falls
        through to the next; when every healthy replica sheds, the
        router sheds to the caller (EngineOverloaded)."""
        with self._lock:
            tried = []
            while True:
                try:
                    rep = self._pick_replica(exclude=tried)
                except RuntimeError as e:
                    if tried:
                        # a replica died between the shed fall-
                        # through and this pick: at least one
                        # healthy replica shed, so the caller-
                        # visible contract stays the retryable
                        # EngineOverloaded, not a fleet-death error
                        raise EngineOverloaded(
                            "every remaining replica shed or died "
                            "mid-submit — router overloaded",
                            engine_state=self.state_summary()) from e
                    raise
                # intake mutates the replica's scheduler (queue
                # append, expiry sweep on a full queue) — serialize
                # against its worker's step() like every other
                # router-side surgery; a replica too wedged to hand
                # over the lock is treated as shedding
                try:
                    with _step_guard(rep, 1.0) as locked:
                        if not locked:
                            raise EngineOverloaded(
                                f"replica {rep.idx} step lock busy")
                        was_idle = not rep.engine.scheduler.has_work()
                        rid = rep.engine.add_request(
                            prompt_ids, sampling=sampling,
                            on_token=on_token, req_id=req_id)
                except EngineOverloaded as e:
                    tried.append(rep)
                    if len(tried) >= len(self._live()):
                        raise EngineOverloaded(
                            f"all {len(tried)} healthy replicas "
                            "shed — router overloaded",
                            engine_state=self.state_summary()) from e
                    continue
                rec = _Record(rid, on_token, rep.idx,
                              rep.engine.get_request(rid))
                self._records[rid] = rec
                if _trace._armed:
                    _trace.note(rec.req, "route", replica=rep.idx)
                # reset the wedge clock ONLY on the idle->work
                # transition (an engine idle for an hour is not
                # wedged the moment work lands) — a busy replica
                # must keep its clock, or steady traffic landing on
                # a wedged one would postpone detection forever
                if was_idle:
                    rep.engine.heartbeat = time.monotonic()
                _flight.record("serve_route", req=rid,
                               replica=rep.idx,
                               load_score=rep.load_score())
                rep.work.set()
                return rid

    # -- health / failover -------------------------------------------
    def _check_health(self):
        with self._lock:
            for rep in self._replicas:
                if rep.dead:
                    continue
                eng = rep.engine
                if rep.error is not None:
                    self._failover(rep, f"crash: "
                                   f"{type(rep.error).__name__}: "
                                   f"{rep.error}")
                elif eng.fenced:
                    # watchdog incident hook already fenced+exported
                    self._failover(rep, "incident_export")
                elif eng.scheduler.has_work() and \
                        eng.heartbeat_age() > self.heartbeat_timeout_s \
                        and len(self._live()) > 1:
                    # a heartbeat timeout never retires the LAST
                    # healthy replica: its exports would have nowhere
                    # to replay, and a slow-but-alive dispatch (a
                    # cold kernel build) would otherwise cascade one
                    # wedge into total fleet loss. Real crashes and
                    # incident fences still retire it (orphan
                    # retention takes over).
                    self._failover(rep, "heartbeat_timeout")

    def _failover(self, rep, reason):
        """Retire a dead/wedged replica and replay its in-flight
        requests on the survivors, token-identically (caller holds
        the router lock). Exports that cannot be placed are retained
        in `orphan_exports`, never dropped."""
        rep.healthy = False
        _cmon.stat_set(f"serve/replica/{rep.idx}/healthy", 0)
        with _flight.in_flight("serve_failover",
                               f"replica-{rep.idx}", reason=reason):
            # fence FIRST: a live-but-slow worker (false-positive
            # heartbeat) parks after its current step instead of
            # mutating scheduler state under the export
            eng = rep.engine
            eng._fenced = True
            # bounded grace for a slow-but-live step to finish and
            # observe the fence; a thread wedged INSIDE a dispatch
            # holds the step lock forever and failover must work
            # around the wedge (it's fenced, so a zombie waking
            # later no-ops), not join it — proceed either way
            with _step_guard(rep, 1.25):
                exports = eng.emergency_exports or []
                eng.emergency_exports = None
                # sweep AGAIN even when the incident hook already
                # exported: a request routed here between the fence
                # and this failover pass sits in the scheduler the
                # hook's export never saw
                exports = exports + eng.export_requests(fence=True)
            rep.dead = True
            rep.work.set()          # unpark the worker so it exits
            _cmon.stat_add("serve/failovers", 1)
            _flight.record("serve_failover", replica=rep.idx,
                           reason=str(reason)[:200],
                           exported=len(exports))
            self._replay(exports, rep, reason)

    def _replay(self, exports, rep, reason):
        """Replay exported requests on the survivors,
        token-identically (caller holds the router lock; `rep` is
        the retired source replica). Shared by crash failover and
        planned scale-down — the SAME placement loop, so a drained
        replica's requests land exactly where a crashed one's would.
        Exports that cannot be placed are retained in
        `orphan_exports`, never dropped."""
        for i, exp in enumerate(exports):
            rec = self._records.get(exp["req_id"])
            excluded = []
            while True:
                try:
                    target = self._pick_replica(exclude=excluded)
                except RuntimeError:
                    # nowhere to replay: retain, never drop
                    self.orphan_exports.extend(exports[i:])
                    raise
                try:
                    was_idle = not \
                        target.engine.scheduler.has_work()
                    rid = target.engine.import_request(
                        exp,
                        on_token=rec.on_token if rec else None,
                        force=True)
                except EngineOverloaded:
                    # target got fenced between the pick and
                    # the import (concurrent incident hook) —
                    # try the next survivor
                    excluded.append(target)
                    continue
                break
            if rec is not None:
                rec.replica = target.idx
                rec.req = target.engine.get_request(rid)
            if _trace._armed:
                _trace.note(target.engine.get_request(rid),
                            "failover", from_replica=rep.idx,
                            to_replica=target.idx,
                            reason=str(reason)[:80])
            if was_idle:     # idle->work only, as in submit()
                target.engine.heartbeat = time.monotonic()
            target.work.set()

    # -- elastic capacity --------------------------------------------
    def spawn_replica(self):
        """Scale UP by one replica; returns its index, or None when
        the router is stopping/draining. The engine builds OUTSIDE
        the router lock (its pools' allocation must not stall
        submit/health traffic), then joins the fleet under the lock
        with the same spec negotiation the boot fleet ran."""
        if self._stop or self._draining:
            return None
        eng = LLMEngine(self._model, **self._engine_kwargs)
        if self._incident_export:
            eng.arm_incident_export()
        with self._lock:
            if self._stop or self._draining:
                return None
            idx = len(self._replicas)
            rep = _Replica(idx, eng)
            # fleet spec config only ever negotiates DOWN: a newcomer
            # clamped below the fleet drags the fleet to its window; a
            # roomier one adopts the fleet's
            if eng.spec_k < self.spec_k:
                _flight.record("serve_spec_negotiate",
                               spec_ks=[self.spec_k, eng.spec_k],
                               negotiated=eng.spec_k,
                               scope="spawn")
                self.spec_k = eng.spec_k
            if self.spec_k > 1:
                _cmon.stat_set("serve/spec/fleet_k", self.spec_k)
            self.prefix_cache = (self.prefix_cache
                                 and bool(eng.prefix_cache))
            self._replicas.append(rep)
            _cmon.stat_set(f"serve/replica/{idx}/healthy", 1)
            t = threading.Thread(
                target=self._replica_loop, args=(rep,),
                name=f"serve-replica-{idx}", daemon=True)
            rep.thread = t
            t.start()
        _flight.record("serve_scale_up", replica=idx,
                       replicas=len(self._replicas))
        return idx

    def retire_replica(self, idx=None):
        """Scale DOWN by one replica (default: the newest live one)
        via the token-exact export path: fence, export its in-flight
        requests, replay them on the survivors — callers see
        identical tokens, just from elsewhere. Refuses to retire the
        last healthy replica. Returns the retired index."""
        with self._lock:
            live = self._live()
            if len(live) <= 1:
                raise RuntimeError(
                    "refusing to retire the last healthy replica")
            rep = (max(live, key=lambda r: r.idx) if idx is None
                   else self._replicas[idx])
            if rep not in live:
                raise RuntimeError(
                    f"replica {rep.idx} is not live — nothing to "
                    "retire")
            rep.healthy = False
            _cmon.stat_set(f"serve/replica/{rep.idx}/healthy", 0)
            with _flight.in_flight("serve_scale_down",
                                   f"replica-{rep.idx}"):
                # same fence-then-bounded-sweep as _failover: the
                # worker parks after its current step, a wedged one
                # is worked around (fenced zombies no-op)
                eng = rep.engine
                eng._fenced = True
                with _step_guard(rep, 1.25):
                    exports = eng.emergency_exports or []
                    eng.emergency_exports = None
                    exports = exports + eng.export_requests(
                        fence=True)
                rep.dead = True
                rep.work.set()      # unpark the worker so it exits
                _flight.record("serve_scale_down", replica=rep.idx,
                               exported=len(exports),
                               replicas=len(self._live()))
                self._replay(exports, rep, "scale_down")
            return rep.idx

    # -- completion --------------------------------------------------
    def wait(self, ids=None, timeout_s=None):
        """Block until every tracked (or listed) request reaches a
        terminal state, running health checks + failover as it polls.
        Raises EngineTimeout (router state attached) on timeout —
        never hangs on a wedged fleet."""
        ids = list(self._records) if ids is None else list(ids)
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while True:
            self._check_health()
            recs = [self._records[i] for i in ids]
            if all(r.req.finished for r in recs):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise EngineTimeout(
                    f"router wait() exceeded timeout_s={timeout_s} "
                    f"with {sum(not r.req.finished for r in recs)} "
                    "request(s) live",
                    engine_state=self.state_summary())
            time.sleep(self._poll_s)

    def generate(self, prompts, sampling=None, timeout_s=None):
        """Submit `prompts` across the fleet and wait to drain;
        returns each prompt's generated ids in order. Survives
        replica loss mid-flood with token-identical outputs."""
        ids = [self.submit(p, sampling=sampling) for p in prompts]
        self.wait(ids, timeout_s=timeout_s)
        outs = [self._records[i].req.output_ids for i in ids]
        for i in ids:
            self.release(i)
        return outs

    def get_request(self, req_id):
        """The LIVE Request object (follows failover re-homing)."""
        return self._records[req_id].req

    def release(self, req_id):
        """Drop the router record + the owning replica's retained
        result for a finished request."""
        rec = self._records.get(req_id)
        if rec is None or not rec.req.finished:
            return
        # finished-only: terminal states released their blocks at
        # scheduler.finish time, this only drops host records
        del self._records[req_id]
        for rep in self._replicas:
            rep.engine.release_request(req_id)

    def abort(self, req_id):
        """Cancel a live request. Backs off (EngineOverloaded) when
        the owning replica's worker holds its step lock past the
        bound — aborting UNLOCKED would free the request's KV blocks
        under an in-flight dispatch that still reads them; retry, or
        let failover reap the replica."""
        rec = self._records.get(req_id)
        if rec is None or rec.req.finished:
            return
        with self._lock:
            rep = self._replicas[rec.replica]
            with _step_guard(rep, 1.0) as locked:
                if not locked:
                    raise EngineOverloaded(
                        f"replica {rep.idx} is busy (step lock held "
                        f"past bound) — retry abort({req_id!r})",
                        engine_state=self.state_summary())
                rep.engine.abort_request(req_id)

    # -- lifecycle ---------------------------------------------------
    def drain(self, timeout_s=None):
        """Graceful router drain: stop admitting fleet-wide (new
        `submit` sheds), let RUNNING requests complete, export the
        leftovers. Returns the combined export list; `resume()`
        re-opens admission."""
        with _flight.in_flight("serve_drain", "router",
                               replicas=len(self._live())):
            if _chaos._armed:
                _chaos.hit("serve_drain", scope="router")
            with self._lock:
                self._draining = True
                live = self._live()
                for rep in live:
                    rep.engine.scheduler.draining = True
            deadline = (time.monotonic() + timeout_s
                        if timeout_s is not None else None)
            while any(rep.engine.scheduler.running for rep in live):
                self._check_health()
                if deadline is not None \
                        and time.monotonic() > deadline:
                    break
                time.sleep(self._poll_s)
            exports = []
            with self._lock:
                # sweep every NON-DEAD replica, fenced ones
                # included: a replica the incident hook fenced after
                # the last health pass holds its in-flight work in
                # emergency_exports, and skipping it here would
                # neither return nor fail over those requests
                for rep in self._replicas:
                    if rep.dead:
                        continue
                    with _step_guard(rep, 1.0):
                        em = rep.engine.emergency_exports
                        if em:
                            rep.engine.emergency_exports = None
                            exports.extend(em)
                        exports.extend(
                            rep.engine.export_requests(fence=False))
            _cmon.stat_add("serve/drains", 1)
            _flight.record("serve_drain_done", scope="router",
                           exported=len(exports))
        return exports

    def resume(self):
        """Re-open admission after drain() on every surviving
        replica."""
        with self._lock:
            self._draining = False
            for rep in self._live():
                rep.engine.resume()
                rep.work.set()

    def shutdown(self, timeout_s=2.0):
        """Stop worker threads, disarm incident hooks. Engines stay
        readable (results, audits) but nothing steps anymore."""
        self._stop = True
        if self.autoscaler is not None:
            self.autoscaler.detach()
        for rep in self._replicas:
            rep.work.set()
        for rep in self._replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=timeout_s)
        for rep in self._replicas:
            rep.engine.disarm_incident_export()

    # -- trace spool -------------------------------------------------
    def export_traces(self):
        """Fleet-wide trace spool: every replica's retained requests,
        each entry tagged with its replica index. A failed-over
        request appears once per engine leg (same trace_id) — the
        exporting replica's story up to EXPORTED plus the survivor's
        import-and-replay continuation."""
        entries = []
        for rep in self._replicas:
            spool = _trace.export_requests(
                rep.engine._requests.values(),
                extra={"replica": rep.idx})
            entries.extend(spool["requests"])
        out = _trace.export_requests(())
        out["requests"] = entries
        return out

    def dump_traces(self, path):
        import json

        with open(path, "w") as f:
            json.dump(self.export_traces(), f, default=str)
        return path

    # -- introspection -----------------------------------------------
    def replica_healthy(self, idx):
        rep = self._replicas[idx]
        return rep.healthy and not rep.dead

    def state_summary(self):
        return {
            "replicas": len(self._replicas),
            "healthy": len(self._live()),
            "spec_k": self.spec_k,
            "prefix_cache": self.prefix_cache,
            "draining": self._draining,
            "records": len(self._records),
            "orphan_exports": len(self.orphan_exports),
            "engines": [r.engine.state_summary()
                        for r in self._replicas],
        }

    def check_drained(self):
        """Zero-leak audit over the WHOLE fleet — dead replicas
        included (export releases their blocks host-side)."""
        leaks = {}
        for rep in self._replicas:
            for owner, blocks in rep.engine.check_drained().items():
                leaks[f"replica{rep.idx}:{owner}"] = blocks
        return leaks
