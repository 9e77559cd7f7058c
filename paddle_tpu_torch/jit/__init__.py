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
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import amp as _amp
from ..core import monitor as _monitor

__all__ = ["TrainStepCompiler"]


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
        dev = self._device()
        batch = [torch.as_tensor(b, device=dev) for b in batch]
        k = self._steps_per_dispatch
        if k > 1:
            bad = [tuple(b.shape) for b in batch if b.dim() < 1
                   or b.shape[0] != k]
            if bad:
                raise ValueError(f"steps_per_dispatch={k}: every batch "
                                 f"element needs a leading axis of {k}, "
                                 f"got {bad}")
        # host scalars, sampled once per call
        lr = np.float32(self._opt.get_lr())
        scale = np.float32(self._grad_scaler._scale
                           if self._grad_scaler is not None else 1.0)
        losses, skips = [], []
        for i in range(k):
            micro = [b[i] for b in batch] if k > 1 else batch
            loss, skipped = self._one_step(micro, lr, scale, self._step + i)
            losses.append(loss)
            skips.append(skipped)
        prev = self._step
        self._step += k
        # optimizer steps: the merge boundaries these microsteps crossed
        a = self._accum_steps
        self._opt._step_count += self._step // a - prev // a
        _monitor.stat_add("jit/dispatches", 1)
        _monitor.stat_add("jit/steps", k)
        if self._guard_nonfinite:
            self.last_skips = n = sum(skips)
            if n:
                _monitor.stat_add("train/nonfinite_skips", n)
            if self._grad_scaler is not None:
                for s in skips:
                    self._grad_scaler._record_step(s)
        return losses[0] if k == 1 else torch.stack(losses)

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
