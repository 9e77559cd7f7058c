"""paddle_tpu_torch.jit — the train step, the port of
`paddle_tpu/jit/__init__.py` `TrainStepCompiler` (:850).

    step = TrainStepCompiler(model, opt)            # model(*batch) is the loss
    step = TrainStepCompiler(model, opt, loss_fn)   # loss_fn(model(*inputs), label)
    loss = step(*batch)                              # updates the model in place

The JAX class traces forward, backward and update into one donated XLA
program. PyTorch runs eagerly, so there is nothing to trace, compile or
donate here: each microstep clears the gradients, runs the forward
loss, `backward()` and the optimizer's update in order, with the
compiled step's semantics (`one_step`, :1515-1598):

- `accumulate_steps=k`: gradient merge. Each microstep's gradients are
  added in f32 buffers (`acc + g.float()`); on every k-th microstep the
  optimizer applies `(acc / k).to(g.dtype)` and the buffers are zeroed
  (:1561-1580). The gradients are cleared every microstep, so PyTorch
  never sums them in the parameter's dtype.
- `guard_nonfinite=True`: a microstep whose loss or any gradient is not
  finite is skipped: without merge the update does not run at all (the
  parameters, slots and beta powers stay as they were); under merge it
  adds nothing and the cadence runs on schedule (:1534-1547, 1582-1592).
  Its non-finite loss is still returned. `last_skips` counts the trips
  of the last call; reading the verdict costs one host sync per
  microstep. A tripped microstep also keeps the model's old floating
  buffers (BatchNorm's running statistics, which the forward writes in
  place): they are copied before the forward and written back on a
  trip, as the JAX step passes the old ones through (:1534-1547,
  1582-1592). Otherwise every microstep commits its buffers.
- `grad_scaler=amp.GradScaler(...)`: the backward runs on loss * scale,
  the gradients are unscaled to their own dtype (:1651-1653), the guard
  is implied, and each microstep's verdict feeds the scaler's
  `_record_step` after the call (:1289-1291).
- `steps_per_dispatch=K`: every batch element carries a leading K axis;
  one call runs the K microsteps, samples the learning rate (and the
  loss scale) once, as `np.float32(get_lr())` (:1200), and returns the
  K losses.

The optimizer's `_step_count` advances by the merge boundaries a call
crossed (:1269-1275), skipped or not, as in the JAX package. O2 is
`amp.decorate` on the model, as in the JAX package. `amp_level="O1"`
runs each microstep's forward loss, and not its backward, inside
`amp.auto_cast(level="O1", dtype=amp_dtype, custom_white_list=...,
custom_black_list=...)`, as the JAX `_build` wraps `loss_of`
(:1445-1458): the white-listed ops of models built from the port's
functional layer (`nn`, `incubate.nn`) then run on bf16 inputs. A
model that calls no such op (the port's GPT, whose loss is one op in
the JAX package too, `"gpt_loss"`) trains exactly as in f32.

The step's own state (`state_dict`, `restore_state`, `adopt_state_from`,
JAX :1320-1410) is the microstep count `_step`, the merge buffers
`_accum` and the communication state `_comm_state` (a data-parallel
step's error-feedback residual); the optimizer's slots live in the
optimizer, so `restore_state` writes them into its `_accumulators` and
`adopt_state_from` shares them. Slots and buffers are keyed by the
model's structured parameter names, which survive a relaunch.

Monitor hooks, at the JAX package's places (:1120-1300, 1495-1525):

- the `dispatch` chaos site at the top of each call (`monitor.chaos`);
- the memory ledger at the first call: its peak-memory delta on the
  card (`monitor.memory.first_call_footprint`, gauges
  `mem/program/<name>/*`), which `cache_report()` carries into dump
  bundles. `<name>` is `train_step:<model class>[@k<K>]`. The train
  step records no cost (`perf/program/<name>/*`): the JAX package
  reads XLA's `cost_analysis()`, and counting the port's aten ops
  takes a dispatch mode, which imports `torch._dynamo` (seconds, once
  a process) and would still miss the ctypes kernel launches;
- `observe_dispatch` of every later call into
  `jit/hist/<name>/dispatch_us` with a `dispatch_end` flight event,
  blocked on the call's work (a device synchronisation) under
  PADDLE_PERF_DISPATCH, on by default as in the JAX package;
- the `nonfinite_skip` flight event beside `train/nonfinite_skips`;
- the PTA093 audit and, under PADDLE_SANITIZE=numerics (armed at the
  first call), the numerics probe: each microstep's loss, gradients
  (after unscaling and the data-parallel reduction) and pre-update
  parameters go through `monitor.numerics.stats_tree`, and the call's
  stats through `numerics.observe`. Disarmed, nothing of it runs.
"""
from __future__ import annotations

import contextlib
import time
import weakref

import numpy as np
import torch

from .. import amp as _amp
from ..core import monitor as _monitor
from ..monitor import chaos as _chaos
from ..monitor import flight as _flight
from ..monitor import memory as _memory
from ..monitor import perf as _perf
from ..monitor import sanitize as _sanitize

__all__ = ["TrainStepCompiler", "cache_report"]

# every live train step, for cache_report()
_live_compiled = weakref.WeakSet()


def cache_report():
    """The program ledger of every live train step — what flight dump
    bundles embed as `jit_caches` (the JAX package's keys): kind, fn,
    entries (1 once its first call ran), steps, steps_per_dispatch,
    memory (the first-call footprint) and cost (None: the train step
    records none)."""
    out = []
    for obj in list(_live_compiled):
        try:
            out.append({"kind": "train_step",
                        "fn": type(obj._model).__name__,
                        "entries": int(obj._calls > 0),
                        "steps": obj._step,
                        "steps_per_dispatch": obj._steps_per_dispatch,
                        "memory": obj._mem_analysis,
                        "cost": None})
        except Exception:
            pass  # a half-torn-down object must not break a dump
    out.sort(key=lambda d: (d["kind"], d["fn"]))
    return out


class TrainStepCompiler:
    def __init__(self, model, optimizer, loss_fn=None, donate=True,
                 accumulate_steps=1, amp_level=None, amp_dtype="bfloat16",
                 amp_custom_white_list=None, amp_custom_black_list=None,
                 steps_per_dispatch=1, guard_nonfinite=False,
                 grad_scaler=None):
        # The parameters and optimizer state are always updated in
        # place, which is what the JAX package's buffer donation buys.
        if not donate:
            raise NotImplementedError(
                "TrainStepCompiler: donate=False is not ported (the port "
                "updates parameters in place)")
        if amp_level not in (None, "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O1' or 'O2', got "
                             f"{amp_level!r}")
        self._amp_level = amp_level
        self._amp_dtype = amp_dtype
        self._amp_white = amp_custom_white_list
        self._amp_black = amp_custom_black_list
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn
        self._accum_steps = max(1, int(accumulate_steps))
        self._steps_per_dispatch = max(1, int(steps_per_dispatch))
        # a disabled scaler is no scaler, as on the eager path
        if grad_scaler is not None and not grad_scaler.is_enable():
            grad_scaler = None
        self._grad_scaler = grad_scaler
        self._guard_nonfinite = bool(guard_nonfinite
                                     or grad_scaler is not None)
        self.last_skips = 0  # non-finite trips in the last call
        self._accum = {}     # param name -> f32 gradient-merge buffer
        self._step = 0       # microsteps run
        self._comm_state = {}  # a data-parallel step's residual
        # monitor: the ledgers' program name (the dispatch width keeps a
        # fused step and its K=1 tail apart), calls run, the first
        # call's footprint, the numerics probe (armed at the
        # first call) and its per-microstep stats
        self._perf_name = f"train_step:{type(model).__name__}"
        if self._steps_per_dispatch != 1:
            self._perf_name += f"@k{self._steps_per_dispatch}"
        self._calls = 0
        self._mem_analysis = None
        self._numerics_built = False
        self._nstats = []
        _live_compiled.add(self)

    def _device(self):
        return next(self._model.parameters()).device

    def _amp_ctx(self):
        if self._amp_level != "O1":
            return contextlib.nullcontext()
        return _amp.auto_cast(enable=True, level="O1", dtype=self._amp_dtype,
                              custom_white_list=self._amp_white,
                              custom_black_list=self._amp_black)

    def _loss(self, batch):
        with self._amp_ctx():
            if self._loss_fn is not None:
                return self._loss_fn(self._model(*batch[:-1]), batch[-1])
            return self._model(*batch)

    def __call__(self, *batch):
        k = self._steps_per_dispatch
        # chaos site "dispatch": a synthetic out-of-memory here drives
        # the real OOM-forensics path
        if _chaos._armed:
            _chaos.hit("dispatch", steps=k)
        dev = self._device()
        batch = [torch.as_tensor(b, device=dev) for b in batch]
        if k > 1:
            bad = [tuple(b.shape) for b in batch if b.dim() < 1
                   or b.shape[0] != k]
            if bad:
                raise ValueError(f"steps_per_dispatch={k}: every batch "
                                 f"element needs a leading axis of {k}, "
                                 f"got {bad}")
        fresh = self._calls == 0
        if fresh:
            self._first_call_setup()
        # host scalars, sampled once per call
        lr = np.float32(self._opt.get_lr())
        scale = np.float32(self._grad_scaler._scale
                           if self._grad_scaler is not None else 1.0)
        # the first call runs the memory ledger; later ones are timed
        # (blocked on their work) when dispatch timing is on
        t_d0 = (time.perf_counter()
                if not fresh and _perf.dispatch_timing_enabled() else None)
        with self._ledgers(dev) if fresh else contextlib.nullcontext():
            losses, skips = [], []
            for i in range(k):
                micro = [b[i] for b in batch] if k > 1 else batch
                loss, skipped = self._one_step(micro, lr, scale,
                                               self._step + i)
                losses.append(loss)
                skips.append(skipped)
        if t_d0 is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dus = int((time.perf_counter() - t_d0) * 1e6)
            _perf.observe_dispatch(self._perf_name, dus)
            _flight.record("dispatch_end", name=self._perf_name,
                           dur_us=dus)
        self._calls += 1
        prev = self._step
        self._step += k
        # optimizer steps: the merge boundaries these microsteps crossed
        a = self._accum_steps
        self._opt._step_count += self._step // a - prev // a
        _monitor.stat_add("jit/dispatches", 1)
        _monitor.stat_add("jit/steps", k)
        if k > 1:
            _monitor.stat_set("jit/steps_per_dispatch", k)
            _flight.record("jit_dispatch", steps=k)
        if self._guard_nonfinite:
            self.last_skips = n = sum(skips)
            if n:
                _monitor.stat_add("train/nonfinite_skips", n)
                _flight.record("nonfinite_skip", steps=n,
                               dispatch_steps=k)
            if self._grad_scaler is not None:
                for s in skips:
                    self._grad_scaler._record_step(s)
        if self._numerics_built:
            self._observe_numerics(prev)
        return losses[0] if k == 1 else torch.stack(losses)

    def _first_call_setup(self):
        """The JAX step's build-time work: the PTA093 audit (raises under
        PADDLE_SANITIZE=numerics, reports under PADDLE_ANALYSIS=1) and
        arming the numerics probe."""
        from ..analysis.precision import audit_train_precision

        audit_train_precision(
            {n: str(p.dtype).replace("torch.", "")
             for n, p in self._model.named_parameters() if p.requires_grad},
            self._grad_scaler, getattr(self._opt, "_multi_precision", False),
            where=f"train_step:{type(self._model).__name__}")
        self._numerics_built = _sanitize._numerics

    @contextlib.contextmanager
    def _ledgers(self, dev):
        """The first call's footprint, recorded after it (never raises
        for the ledger's sake)."""
        with _memory.first_call_footprint(dev) as mem:
            yield
        try:
            self._mem_analysis = _memory.record_program_memory(
                self._perf_name, footprint=mem)
        except Exception:
            pass

    def _observe_numerics(self, step):
        """The probe's host leg over this call's microsteps: one (K, 3)
        stack per tensor into numerics.observe (its sample=N cadence
        decides whether the host reads them)."""
        from ..monitor import numerics as _numerics

        rows, self._nstats = self._nstats, []
        stats = {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
        _numerics.observe(stats, where=self._perf_name, step=step)

    def _one_step(self, batch, lr, scale, microstep):
        """One microstep; returns (its loss, detached f32; whether the
        guard tripped)."""
        opt = self._opt
        opt.clear_grad()
        # the buffers a tripped microstep must leave as they were
        bufs = ([b for b in self._model.buffers() if b.is_floating_point()]
                if self._guard_nonfinite else [])
        kept = [b.detach().clone() for b in bufs]
        loss = self._forward_backward(batch, scale)
        # a trainable parameter the loss does not reach gets a zero
        # gradient, as under `value_and_grad` over every trainable
        # parameter (:1629-1660): the update still moves it (decoupled
        # decay, decaying moments) and its merge buffer exists from the
        # first microstep. Frozen parameters stay out.
        named = [(n, p) for n, p in opt._named if p.requires_grad]
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            if self._grad_scaler is not None:
                inv = float(np.float32(1.0) / scale)
                for _, p in named:
                    p.grad = (p.grad.float() * inv).to(p.grad.dtype)
            loss, named = self._reduce_grads(loss, named)
            if self._numerics_built:
                self._probe(loss, named)
            ok = True
            if self._guard_nonfinite:
                finite = [torch.isfinite(loss)] + [
                    torch.isfinite(p.grad).all() for _, p in named]
                ok = self._agree(bool(torch.stack(finite).all()))
            if not ok:
                for b, old in zip(bufs, kept):
                    b.copy_(old)
            self._commit_comm(ok)
            k = self._accum_steps
            if k == 1:
                if ok:
                    opt._apply(float(lr))
            else:
                for n, p in named:
                    acc = self._accum.get(n)
                    if acc is None:
                        acc = self._accum[n] = torch.zeros(
                            p.shape, dtype=torch.float32, device=p.device)
                    if ok:   # a tripped microstep adds nothing
                        acc.add_(p.grad.float())
                if microstep % k == k - 1:
                    div = torch.tensor(float(k), device=loss.device)
                    for n, p in opt._named:
                        acc = self._accum.get(n)
                        if acc is None:
                            continue
                        # a true division (a host scalar divisor is a
                        # reciprocal multiply on the card)
                        p.grad = (acc / div).to(p.dtype)
                        acc.zero_()
                    opt._apply(float(lr))
        return loss.detach(), int(not ok)

    def _probe(self, loss, named):
        """One microstep's numerics stats: loss, gradients and the
        pre-update parameters, by structured name."""
        from ..monitor import numerics as _numerics

        to_s, _ = self._structured()
        self._nstats.append(_numerics.stats_tree(
            {"loss": loss,
             "grad": {to_s.get(n, n): p.grad for n, p in named},
             "param": {to_s.get(n, n): p for n, p in named}}))

    def _forward_backward(self, batch, scale):
        """The microstep's forward loss (f32) and its backward, on loss
        * scale under a GradScaler; returns the loss."""
        loss = self._loss(batch).float()
        if self._grad_scaler is not None:
            (loss * float(scale)).backward()
        else:
            loss.backward()
        return loss

    def _agree(self, ok):
        """The guard's verdict, agreed by every rank that must skip
        together (one host sync here); one process: its own."""
        return ok

    def _reduce_grads(self, loss, named):
        """Where a data-parallel subclass reduces the unscaled
        gradients and the loss across ranks, before the guard and the
        gradient merge read them; returns (loss, named). One process:
        nothing to reduce."""
        return loss, named

    def _commit_comm(self, ok):
        """Commit the communication state `_reduce_grads` computed,
        unless the guard tripped (`ok` false)."""

    # -- the step's own state (elastic checkpoints) -----------------------
    def _structured(self):
        """{optimizer name: structured name} and back, the structured
        names being the model's `named_parameters()` keys."""
        sname = {id(p): n for n, p in self._model.named_parameters()}
        to_s = {n: sname.get(id(p), n) for n, p in self._opt._named}
        return to_s, {s: n for n, s in to_s.items()}

    def state_dict(self):
        """The step's state, live tensors keyed by the model's structured
        parameter names: the optimizer's slots, the microstep count, the
        merge buffers and the communication state (the error-feedback
        residual of a data-parallel step)."""
        to_s, _ = self._structured()
        return {"slots": self._opt._slot_state(
                    list(self._model.named_parameters())),
                "step": self._step,
                "accum": {to_s.get(n, n): t for n, t in self._accum.items()},
                "comm": dict(self._comm_state)}

    @torch.no_grad()
    def restore_state(self, slots, step, accum=None, comm=None):
        """Load the state `state_dict` gave, from host or device tensors:
        the slots go into the optimizer's `_accumulators` (in place where
        a slot exists), the merge buffers and the residual onto the
        step's device. A residual whose shape no longer fits the packed
        gradient (another world size) is dropped at the first call."""
        dev = self._device()
        self._opt._load_slot_state(slots or {},
                                   list(self._model.named_parameters()))
        _, from_s = self._structured()
        self._accum = {from_s.get(n, n): torch.as_tensor(t).to(
                           dev, torch.float32, copy=True)
                       for n, t in (accum or {}).items()}
        self._comm_state = {n: torch.as_tensor(t).to(dev, copy=True)
                            for n, t in (comm or {}).items()}
        self._step = int(step)

    def adopt_state_from(self, other):
        """Share `other`'s live state: its optimizer's slots (when the two
        hold different optimizers), its microstep count, its merge buffers
        when the merge width is the same (else this step's window starts
        empty) and its communication state when the compression is the
        same. For two steps over one model and optimizer that differ in
        `steps_per_dispatch`, as hapi's fused dispatch and its one-batch
        tail are."""
        if other is None or other is self:
            return
        if other._opt is not self._opt:
            self._opt._accumulators = other._opt._accumulators
        self._step = other._step
        self._accum = (other._accum
                       if other._accum_steps == self._accum_steps else {})
        if getattr(other, "_compress", None) == getattr(self, "_compress",
                                                        None):
            self._comm_state = other._comm_state
