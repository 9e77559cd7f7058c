"""High-level `Model`, the port of `paddle_tpu/hapi/model.py` (reference:
python/paddle/hapi/model.py, prepare:906 / fit:1485 / evaluate:1556 /
predict:1786).

    model = Model(network)                        # runs where network is
    model.prepare(optimizer, loss, metrics)
    model.fit(loader, epochs=2, resume="auto")    # resumes bit for bit

Every training step goes through `jit.TrainStepCompiler` over the
network, the optimizer and `loss(*outputs, *labels)`, or through
`jit.distributed.DistributedTrainStepCompiler` when torch.distributed
is up with more than one rank (every rank passes the global batch;
`comm_compress` from $PADDLE_COMM_COMPRESS). The JAX package's
fallbacks are not ported: it demotes a failing compiled step to the
tape path and a failing fused dispatch to one batch a step
(:155-159, 172-178, 245-347); here there is one step path, and a step
that raises propagates. Batches go to the network's device (that of
its first parameter); a `Dataset` passed to fit / evaluate / predict is
loaded by a `DataLoader` on that device.

`fit` (:383-696): `accumulate_grad_batches` (the step's gradient
merge), `steps_per_dispatch=K` (K loader batches stacked into one call
of a K-wide step; a ragged group runs batch by batch through a K=1
sibling that shares its state), `num_iters`, `guard_nonfinite`,
`terminate_on_nan=K` (K non-finite losses in a row: an emergency
snapshot when checkpointing, then stop) and `resume`:

- resume=True / "auto" / a directory: an elastic `CheckpointManager`
  (the EDL env contract, or the directory) restores the newest valid
  snapshot, the data loader's sampler is fast-forwarded to its cursor,
  and a `ModelCheckpoint(training_state=True)` keeps snapshotting at
  the manager's cadence, after every other callback has run, so a
  snapshot at step s holds the learning rate step s + 1 runs at.
  SIGTERM saves the current boundary and stops the fit.
- A snapshot (`_training_state`, :791-835) holds the network's state
  dict, the optimizer's slots keyed by the network's structured
  parameter names, the step's merge buffers and error-feedback
  residual, `opt_meta` (the optimizer's `_step_count` and its LR
  scheduler's state) and `rng`; the cursor is in its manifest. The JAX
  `rng` is the package's global key and counter; the port has no
  global key, and its counterpart is the `get_state()` of every
  `torch.Generator` the network holds as a module attribute (BERT's
  `dropout_generator`), set back on restore.

Monitor hooks (JAX :428-437, 620-627, 764): `fit` calls
`flight.maybe_auto_arm` and `server.maybe_auto_serve` first and runs
its loop inside `memory.auto_oom_observer()`, so an out-of-memory
leaves an "oom" bundle whose census was taken before unwinding freed
the tensors; `terminate_on_nan` records its flight event. The JAX
fit's `_note_step_failure` bundles an OOM its fallbacks swallow; the
port's fit swallows no step failure, so every OOM reaches the
observer.

`summary(net)` and `flops(net, input_size)` (JAX :918-970) give the JAX
package's totals: every parameter counted, the trainable ones apart;
2 x k_h x k_w x c_in / groups FLOPs an output element of each Conv2D
and 2 x in x out a row of each Linear, over one forward of zeros
(float32, on the network's device) in eval mode, restored afterwards
(the JAX package leaves the network in eval mode). The JAX rule counts
a convolution's output elements without the batch dimension and a
Linear's rows with it (ROADMAP queue 3 #38); the port keeps that rule.
`fit`'s `num_workers` (-1 = auto) reaches the `DataLoader` it builds.
"""
from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch

from ..core import monitor as _cmon
from ..io import DataLoader, Dataset, _to_device
from ..monitor import flight as _flight
from ..monitor import memory as _memory
from ..monitor import server as _mserver
from . import callbacks as cb_mod

__all__ = ["Model", "summary", "flops"]


def _batch_size_of(inputs):
    """Leading-dim batch size of the first tensor-like input, or None."""
    for x in inputs:
        shape = getattr(x, "shape", None)
        if shape:
            return int(shape[0])
    return None


def _generators(network):
    """(name, torch.Generator) of every generator the network's modules
    hold as attributes, each once, in module order."""
    seen, out = set(), []
    for mname, mod in network.named_modules():
        for attr, v in vars(mod).items():
            if isinstance(v, torch.Generator) and id(v) not in seen:
                seen.add(id(v))
                out.append((f"{mname}.{attr}" if mname else attr, v))
    return out


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._compiled_step = None  # the live step (K wide under fit)
        self._tail_step = None      # its K=1 sibling for stragglers
        self._stale_step = None     # a retired step whose state the next
        # one built adopts (the end of an accumulate_grad_batches fit)
        self._fit_accum = 1         # fit(accumulate_grad_batches=...)
        self._guard_nonfinite = False
        self._nan_streak = 0        # consecutive non-finite losses (fit)
        self._nonfinite_stopped = False
        self._ckpt_manager = None   # elastic CheckpointManager (fit)
        self._pending_restore = None  # restored step state for the next
        # step built: {"step", "accum", "comm"}
        self.stop_training = False

    def _device(self):
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return torch.device("cpu")

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        return self

    # -- single-batch APIs ------------------------------------------------
    def _make_compiled_step(self, steps_per_dispatch=1):
        """The train step over network, optimizer and loss: data parallel
        when torch.distributed runs more than one rank."""
        if self._optimizer is None or self._loss is None:
            raise ValueError("Model.prepare(optimizer=..., loss=...) is "
                             "required for training")
        import torch.distributed as dist

        def loss_fn(out, lbl):
            return self._compute_loss(out, [lbl])

        kw = dict(steps_per_dispatch=steps_per_dispatch,
                  accumulate_steps=self._fit_accum,
                  guard_nonfinite=self._guard_nonfinite)
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            from ..jit.distributed import DistributedTrainStepCompiler

            comp = DistributedTrainStepCompiler(
                self.network, self._optimizer, loss_fn, **kw)
        else:
            from ..jit import TrainStepCompiler

            comp = TrainStepCompiler(self.network, self._optimizer, loss_fn,
                                     **kw)
        stale, self._stale_step = self._stale_step, None
        if stale is not None:
            comp.adopt_state_from(stale)
        pend, self._pending_restore = self._pending_restore, None
        if pend is not None:
            # the slots are in the optimizer already
            comp.restore_state({}, pend["step"], pend["accum"],
                               pend["comm"])
        return comp

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._to_list(inputs)
        labels = self._to_list(labels)
        if not update:
            # a loss probe: no backward, no update
            with torch.no_grad():
                loss = self._compute_loss(
                    self.network(*_to_device(inputs, self._device())),
                    _to_device(labels, self._device()))
            return [float(loss)]
        step = self._compiled_step
        if step is not None and step._steps_per_dispatch != 1:
            # a K-wide step cannot take one batch: its K=1 sibling can
            return self._train_batch_tail(inputs, labels)
        if step is None:
            step = self._compiled_step = self._make_compiled_step()
        return [float(step(*inputs, *labels))]

    def _train_batch_fused(self, group):
        """One call of a K-wide step over a group of K (inputs, labels)
        pairs, each tensor position stacked along a new leading axis;
        the K losses. None for a ragged group (shapes or dtypes differ),
        which the caller then steps batch by batch."""
        self.network.train()
        k = len(group)
        step = self._compiled_step
        if step is None or step._steps_per_dispatch != k:
            fused = self._make_compiled_step(k)
            if step is not None:
                # a step of another width exists: build around its live
                # state; a K=1 one becomes the tail sibling
                fused.adopt_state_from(step)
                if step._steps_per_dispatch == 1 and self._tail_step is None:
                    self._tail_step = step
            self._compiled_step = step = fused
        rows = [[torch.as_tensor(t) for t in self._to_list(ins)
                 + self._to_list(lbls)] for ins, lbls in group]
        sigs = [[(tuple(t.shape), t.dtype) for t in row] for row in rows]
        if any(s != sigs[0] for s in sigs[1:]):
            return None
        stacked = [torch.stack([row[j] for row in rows])
                   for j in range(len(rows[0]))]
        return step(*stacked).tolist()

    def _train_batch_tail(self, inputs, labels):
        """A batch outside a full group in a fused fit: runs through the
        K=1 sibling, which adopts the fused step's state and hands it
        back, so the slots stay one stream."""
        fused = self._compiled_step
        if fused is None or fused._steps_per_dispatch == 1:
            return self.train_batch(inputs, labels)
        self.network.train()
        if self._tail_step is None:
            self._tail_step = self._make_compiled_step(1)
        tail = self._tail_step
        tail.adopt_state_from(fused)
        loss = tail(*self._to_list(inputs), *self._to_list(labels))
        fused.adopt_state_from(tail)
        return [float(loss)]

    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        if callable(self._loss):
            return self._loss(*outs, *labels)
        raise ValueError("Model.prepare(loss=...) required for training")

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        inputs = _to_device(self._to_list(inputs), dev)
        labels = _to_device(self._to_list(labels), dev)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        metrics = []
        for m in self._metrics:
            res = m.compute(outputs if not isinstance(outputs, (list, tuple))
                            else outputs[0], *labels)
            m.update(res)
            metrics.append(m.accumulate())
        return [float(loss)], metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*_to_device(self._to_list(inputs),
                                       self._device()))
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [(o.float() if o.dtype == torch.bfloat16 else o)
                .detach().cpu().numpy() for o in outs]

    # -- loops ------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            steps_per_dispatch=None, resume=None, terminate_on_nan=None,
            guard_nonfinite=None):
        """See the module docstring. `steps_per_dispatch` defaults to
        $PADDLE_JIT_STEPS_PER_DISPATCH (else 1); `num_iters` may
        overshoot by up to K - 1 steps (a group is indivisible);
        `guard_nonfinite` defaults to $PADDLE_JIT_GUARD_NONFINITE. For a
        bit-identical resume pass a DataLoader over a seeded
        BatchSampler (or shuffle=False)."""
        # failure forensics: distributed fits (or PADDLE_FLIGHT_AUTOARM
        # =1) get the watchdog + crash-bundle excepthook before the
        # first step; PADDLE_MONITOR_SERVE=<port> exposes /metrics,
        # /statusz, /flightz, ... for the run's lifetime
        _flight.maybe_auto_arm("hapi.Model.fit")
        _mserver.maybe_auto_serve("hapi.Model.fit")
        accum = max(1, int(accumulate_grad_batches))
        self._fit_accum = accum
        if guard_nonfinite is None:
            guard_nonfinite = _cmon._env_on("PADDLE_JIT_GUARD_NONFINITE",
                                            default=False)
        guard_nonfinite = bool(guard_nonfinite)
        if guard_nonfinite != self._guard_nonfinite:
            # the guard is a property of the step: retire the live one;
            # the next one built adopts its state
            self._guard_nonfinite = guard_nonfinite
            live = self._compiled_step or self._tail_step
            if live is not None and self._stale_step is None:
                self._stale_step = live
            self._compiled_step = self._tail_step = None
        nan_k = max(0, int(terminate_on_nan or 0))  # True -> 1
        self._nan_streak = 0
        self._nonfinite_stopped = False
        for attr in ("_compiled_step", "_tail_step"):
            step = getattr(self, attr)
            if step is not None and step._accum_steps != accum:
                warnings.warn(
                    "accumulate_grad_batches changed with a live step; "
                    "rebuilding it (its merge window restarts)",
                    RuntimeWarning)
                if self._stale_step is None:
                    self._stale_step = step
                setattr(self, attr, None)
        if steps_per_dispatch is None:
            steps_per_dispatch = _cmon._env_int(
                "PADDLE_JIT_STEPS_PER_DISPATCH", 1)
        k_fused = max(1, int(steps_per_dispatch))
        loader = self._as_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        eval_loader = (self._as_loader(eval_data, batch_size, False, False,
                                       num_workers)
                       if eval_data is not None else None)
        start_epoch = 0
        mgr = None
        if resume:
            mgr, start_epoch = self._resume(resume, loader)
        cbks = cb_mod.config_callbacks(
            callbacks, model=self, epochs=epochs,
            steps=self._safe_len(loader), log_freq=log_freq,
            save_dir=save_dir, verbose=verbose,
            metrics=["loss"] + [m.name() for m in self._metrics])
        if mgr is not None and not any(
                isinstance(c, cb_mod.ModelCheckpoint) and c.training_state
                for c in cbks.callbacks):
            saver = cb_mod.ModelCheckpoint(training_state=True)
            saver.set_model(self)
            cbks.callbacks.append(saver)
        # training-state savers run last: they must see the schedule the
        # next step runs at
        ts_savers = [c for c in cbks.callbacks
                     if isinstance(c, cb_mod.ModelCheckpoint)
                     and c.training_state]
        for c in ts_savers:
            cbks.callbacks.remove(c)
        cbks.callbacks.extend(ts_savers)
        cbks.on_begin("train")
        iters_done = 0
        loss = [0.0]
        pending = []  # buffered (step, ins, lbls, bs) awaiting dispatch

        def flush_pending():
            """Run the buffered batches, one K-wide call for a full
            stackable group, else batch by batch, firing the per-batch
            callbacks for each."""
            nonlocal loss, iters_done
            if not pending:
                return
            fused = None
            if k_fused > 1 and len(pending) == k_fused:
                fused = self._train_batch_fused(
                    [(ins, lbls) for _, ins, lbls, _ in pending])
            for idx, (s2, ins2, lbls2, b2) in enumerate(pending):
                cbks.on_batch_begin("train", s2, {"batch_size": b2})
                if fused is not None:
                    loss = [fused[idx]]
                else:
                    loss = self._train_batch_tail(ins2, lbls2)
                cbks.on_batch_end("train", s2, {"loss": loss[0], "step": s2,
                                                "batch_size": b2})
                iters_done += 1
                if nan_k:
                    if math.isfinite(loss[0]):
                        self._nan_streak = 0
                    else:
                        self._nan_streak += 1
                        if (self._nan_streak >= nan_k
                                and not self.stop_training):
                            self._escalate_nonfinite(mgr)
            pending.clear()

        try:
            # OOM forensics: an out-of-memory anywhere in the loop leaves
            # an "oom" bundle with the live-tensor census, taken here
            # before unwinding frees the tensors
            with _memory.auto_oom_observer():
                for epoch in range(start_epoch, epochs):
                    cbks.on_epoch_begin(epoch)
                    for m in self._metrics:
                        m.reset()
                    for step, batch in enumerate(loader):
                        ins, lbls = self._split_batch(batch)
                        pending.append((step, ins, lbls,
                                        _batch_size_of(ins)))
                        if len(pending) >= k_fused:
                            flush_pending()
                            if self.stop_training:
                                break
                            if (num_iters is not None
                                    and iters_done >= num_iters):
                                break
                    flush_pending()  # a short last group
                    cbks.on_epoch_end(epoch, {"loss": loss[0]})
                    # an aborted epoch (preemption, terminate_on_nan) is
                    # incomplete: no eval, no epoch save
                    aborted = ((mgr is not None
                                and mgr.preempted.is_set())
                               or self._nonfinite_stopped)
                    if eval_loader is not None and not aborted \
                            and (epoch + 1) % eval_freq == 0:
                        self.evaluate(eval_loader, batch_size=batch_size,
                                      verbose=0)
                    if save_dir is not None and not aborted \
                            and (epoch + 1) % save_freq == 0:
                        self.save(f"{save_dir}/epoch_{epoch}")
                    if self.stop_training:
                        break
                    if num_iters is not None and iters_done >= num_iters:
                        break
            cbks.on_end("train")
        finally:
            if self._fit_accum > 1:
                # a live step merges every A calls: a train_batch() after
                # the fit must not skip updates. Retire it; the next one
                # built adopts its state (a merge window only at the
                # same width)
                live = self._compiled_step or self._tail_step
                if live is not None:
                    self._stale_step = live
                self._compiled_step = self._tail_step = None
            self._fit_accum = 1
            self._pending_restore = None  # consumed, or stale
            if mgr is not None:
                # drain the writer, disarm the handler; the manager stays
                # on the model for a later fit(resume=...)
                mgr.close()
        return self

    def _resume(self, resume, loader):
        """Restore the newest snapshot, fast-forward the loader, arm the
        preemption handler; (manager, first epoch)."""
        from ..incubate.checkpoint import elastic as _elastic

        explicit = (resume if isinstance(resume, str)
                    and resume not in ("auto", "true", "True") else None)
        mgr = self._ckpt_manager
        if mgr is None or (explicit is not None and mgr.dir != explicit):
            mgr = _elastic.CheckpointManager(dir=explicit,
                                             device=self._device())
        start_epoch = 0
        cursor = self._restore_training_state(mgr)
        if cursor is not None:
            start_epoch = int(cursor["epoch"])
            skip = int(cursor["step_in_epoch"])
            n_steps = self._safe_len(loader)
            if n_steps is not None and skip >= n_steps:
                # the snapshot landed on an epoch boundary
                start_epoch += 1
                skip = 0
                mgr.cursor = {"epoch": start_epoch, "step_in_epoch": 0,
                              "global_step": cursor["global_step"]}
            bs = getattr(loader, "batch_sampler", None)
            if bs is not None and hasattr(bs, "set_state_dict"):
                bs.set_state_dict({"epoch": start_epoch, "consumed": skip})
                if skip and not getattr(bs, "_resume_deterministic", True):
                    warnings.warn(
                        "elastic resume: the batch sampler's shuffle is "
                        "unseeded, so the resumed epoch replays another "
                        "permutation; pass BatchSampler(seed=...) (or "
                        "shuffle=False) for a bit-identical resume",
                        RuntimeWarning)
            elif skip:
                warnings.warn(
                    "elastic resume: the data pipeline has no resumable "
                    "batch_sampler; restarting the epoch from its first "
                    "batch", RuntimeWarning)
                # the epoch replays from batch 0, and the cursor says so
                mgr.cursor = dict(mgr.cursor or {}, step_in_epoch=0)
        mgr.arm()
        self._ckpt_manager = mgr
        return mgr, start_epoch

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, lbls = self._split_batch(batch)
            loss, _ = self.eval_batch(ins, lbls)
            losses.append(loss[0])
        out = {"loss": [float(np.mean(losses))] if losses else [0.0]}
        for m in self._metrics:
            out[m.name() if isinstance(m.name(), str) else "metric"] = \
                m.accumulate()
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_label=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence ------------------------------------------------------
    def save(self, path, training=True):
        from .. import framework

        framework.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import framework

        self.network.load_state_dict(framework.load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(framework.load(opt_path))

    def _escalate_nonfinite(self, mgr):
        """terminate_on_nan tripped: checkpoint (the last completed step
        boundary, through the manager's state provider), then stop."""
        _cmon.stat_add("train/nonfinite_stops", 1)
        _flight.record("terminate_on_nan", streak=self._nan_streak)
        step = mgr.emergency_save("nonfinite") if mgr is not None else None
        warnings.warn(
            f"terminate_on_nan: {self._nan_streak} consecutive non-finite "
            "losses; stopping training"
            + (f" (emergency snapshot at step {step})"
               if step is not None else ""), RuntimeWarning)
        self._nonfinite_stopped = True
        self.stop_training = True

    # -- elastic training state -------------------------------------------
    def _live_compiler(self):
        for c in (self._compiled_step, self._tail_step, self._stale_step):
            if c is not None:
                return c
        return None

    def _training_state(self):
        """The training-state snapshot (live tensors; the manager copies
        them to the host): see the module docstring."""
        from ..optimizer.lr import LRScheduler as _Sched

        comp = self._live_compiler()
        opt = self._optimizer
        accum = comm = None
        if comp is not None:
            st = comp.state_dict()
            slots, accum, comm = st["slots"], st["accum"], st["comm"]
        else:
            slots = (opt._slot_state(list(self.network.named_parameters()))
                     if opt is not None else {})
            if self._pending_restore is not None:
                accum = self._pending_restore["accum"]
                comm = self._pending_restore["comm"]
        opt_meta = {"step_count": 0, "lr_sched": None}
        if opt is not None:
            opt_meta["step_count"] = int(opt._step_count)
            if isinstance(opt._learning_rate, _Sched):
                opt_meta["lr_sched"] = opt._learning_rate.state_dict()
        return {"model": dict(self.network.state_dict()),
                "opt_slots": slots,
                "opt_accum": accum or None,
                "opt_comm": comm or None,
                "opt_meta": opt_meta,
                "rng": {name: g.get_state()
                        for name, g in _generators(self.network)}}

    def _restore_training_state(self, mgr):
        """Apply the newest valid snapshot of `mgr`: the state dict into
        the network, the slots, step count and schedule into the
        optimizer, the generators' states, and the step's microstep
        count, merge buffers and residual into the next step built.
        Returns mgr.cursor (None: a fresh start)."""
        from ..optimizer.lr import LRScheduler as _Sched

        state = mgr.restore()
        if state is None:
            return None
        self.network.load_state_dict(state["model"])
        opt = self._optimizer
        if opt is not None:
            om = state.get("opt_meta") or {}
            opt._step_count = int(om.get("step_count", 0))
            sd = om.get("lr_sched")
            if sd is not None and isinstance(opt._learning_rate, _Sched):
                opt._learning_rate.set_state_dict(sd)
            opt._load_slot_state(state.get("opt_slots") or {},
                                 list(self.network.named_parameters()))
        rng = state.get("rng") or {}
        for name, g in _generators(self.network):
            if name in rng:
                g.set_state(rng[name])
        self._pending_restore = {
            "accum": state.get("opt_accum"), "comm": state.get("opt_comm"),
            "step": int((mgr.cursor or {}).get("global_step", 0))}
        # a step from a previous fit holds the state before the restore
        self._compiled_step = self._tail_step = self._stale_step = None
        return mgr.cursor

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _to_list(x):
        if x is None:
            return []
        if isinstance(x, (list, tuple)):
            return list(x)
        return [x]

    @staticmethod
    def _safe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers,
                              device=self._device())
        return data

    @staticmethod
    def _split_batch(batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if has_label and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []


def summary(net, input_size=None, dtypes=None, input=None):
    """paddle.summary (reference: hapi/model_summary.py): prints each
    parameter's name, shape and size and returns {"total_params",
    "trainable_params"}. `input_size`, `dtypes` and `input` are
    accepted and unused, as in the JAX package."""
    rows = []
    total_params = 0
    trainable_params = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape))
        total_params += n
        if p.requires_grad:
            trainable_params += n
        rows.append((name, tuple(p.shape), n))
    lines = [f"{'Param':<50s}{'Shape':<24s}{'Count':>12s}"]
    lines += [f"{n:<50s}{str(s):<24s}{c:>12,d}" for n, s, c in rows]
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params,
            "trainable_params": trainable_params}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """paddle.flops — analytic Conv2D / Linear FLOPs of one forward at
    `input_size` (see the module docstring for the rule). `custom_ops`
    and `print_detail` are accepted and unused, as in the JAX
    package."""
    from ..nn import Conv2D, Linear

    total = [0]

    def conv_hook(layer, inputs, output):
        kh, kw = layer._kernel_size
        cin = layer._in_channels // layer._groups
        total[0] += 2 * kh * kw * cin * int(np.prod(output.shape[1:]))

    def linear_hook(layer, inputs, output):
        total[0] += 2 * layer._in_features * layer._out_features * \
            int(np.prod(output.shape[:-1]))

    hooks = []
    for lay in net.modules():
        if isinstance(lay, Conv2D):
            hooks.append(lay.register_forward_hook(conv_hook))
        elif isinstance(lay, Linear):
            hooks.append(lay.register_forward_hook(linear_hook))
    dev = next((t.device for t in net.parameters()), torch.device("cpu"))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(list(input_size), device=dev))
    finally:
        for h in hooks:
            h.remove()
        net.train(was_training)
    return total[0]
