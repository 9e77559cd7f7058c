"""Callbacks of `hapi.Model.fit`, the port of
`paddle_tpu/hapi/callbacks.py` (:14-305, 348-378; reference:
python/paddle/hapi/callbacks.py): `Callback`, `CallbackList`,
`ProgBarLogger`, `ModelCheckpoint`, `LRScheduler`, `EarlyStopping`,
`VisualDL`, `config_callbacks`.

`config_callbacks` installs a `ProgBarLogger` (when `verbose`), an
`LRScheduler` stepped by batch and, first in dispatch order, a
`Telemetry` callback (monitor.StepTimer: the `step/*` stats of every
fit step), as the JAX package does (:307-378).
"""
from __future__ import annotations

import os
import time

from ..core.monitor import _env_int

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "Telemetry", "VisualDL",
           "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._t0 = None

    def on_train_begin(self, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._step_t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            loss = logs.get("loss") if logs else None
            dt = (time.time() - self._step_t0) / max(step + 1, 1)
            print(f"Epoch {self.epoch} step {step}: "
                  f"loss={loss if loss is None else f'{loss:.5f}'} "
                  f"({dt * 1000:.1f} ms/step)")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            loss = (logs or {}).get("loss")
            print(f"Epoch {epoch} done, loss="
                  f"{loss if loss is None else f'{loss:.5f}'}")


class ModelCheckpoint(Callback):
    """Periodic checkpoints during fit.

    Epoch snapshots (`save_dir`/<epoch>.pdparams and .pdopt) rotate: the
    newest `max_checkpoint_num` are kept (default
    PADDLE_EDL_MAX_CHECKPOINT_NUM, else 5; <= 0 keeps all).

    training_state=True makes it write full training-state snapshots
    through an elastic `CheckpointManager`: the model's state dict, the
    optimizer's slots, the step's merge buffers and residual, the step
    count and schedule, the generators' states and the step cursor,
    captured at a step boundary and written by the manager's writer
    thread; every `save_steps` steps (default: the manager's cadence)
    and at every `save_freq`-th epoch end. `Model.fit(resume=...)`
    installs one and runs it after every other callback, so a snapshot
    at step s holds the learning rate step s + 1 runs at. It uses the
    fit's manager (`model._ckpt_manager`), or builds one over
    `save_dir`/training_state (else the EDL env contract) on the
    model's device. On a preemption signal it saves the current
    boundary synchronously and stops the fit."""

    def __init__(self, save_freq=1, save_dir=None, max_checkpoint_num=None,
                 training_state=False, save_steps=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        if max_checkpoint_num is None:
            max_checkpoint_num = _env_int("PADDLE_EDL_MAX_CHECKPOINT_NUM", 5)
        self.max_checkpoint_num = int(max_checkpoint_num)
        self.training_state = training_state
        self.save_steps = save_steps
        self._mgr = None
        self._owns_mgr = False  # this callback built the manager
        self._epoch = 0
        self._step_in_epoch = 0

    def _manager(self):
        # the model's manager is authoritative: a later fit(resume=) may
        # have swapped it
        live = getattr(self.model, "_ckpt_manager", None)
        if live is not None:
            if self.save_steps is not None and live is not self._mgr:
                live.save_steps = max(0, int(self.save_steps))
            self._mgr = live
            return live
        if self._mgr is None:
            from ..incubate.checkpoint import elastic as _elastic

            d = (os.path.join(self.save_dir, "training_state")
                 if self.save_dir else None)
            self._mgr = _elastic.CheckpointManager(
                dir=d, save_steps=self.save_steps,
                device=self.model._device())
            self._owns_mgr = True
            self.model._ckpt_manager = self._mgr
        return self._mgr

    def _cursor(self, mgr):
        return {"epoch": self._epoch, "step_in_epoch": self._step_in_epoch,
                "global_step": mgr.global_step}

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._step_in_epoch = 0
        if self.training_state:
            mgr = self._manager()
            cur = mgr.cursor
            # resumed mid-epoch: the fast-forwarded batches count, when
            # the cursor describes this boundary (epoch and global step)
            if (cur and int(cur.get("epoch", -1)) == epoch
                    and int(cur.get("global_step", -1))
                    == mgr.global_step):
                self._step_in_epoch = int(cur.get("step_in_epoch", 0))

    def on_train_batch_end(self, step, logs=None):
        if not self.training_state:
            return
        mgr = self._manager()
        self._step_in_epoch += 1
        mgr.global_step += 1
        cur = self._cursor(mgr)
        mgr.set_state_provider(
            lambda c=cur: (self.model._training_state(), c))
        if mgr.preempted.is_set():
            # one synchronous boundary checkpoint, then stop
            if not self.model.stop_training:
                mgr.save(self.model._training_state(), sync=True, **cur)
                self.model.stop_training = True
            return
        mgr.maybe_save(self.model._training_state, **cur)

    def on_epoch_end(self, epoch, logs=None):
        live = getattr(self.model, "_ckpt_manager", None)
        if (live is not None and live.preempted.is_set()) \
                or getattr(self.model, "_nonfinite_stopped", False):
            # a preemption or terminate_on_nan break leaves the epoch
            # incomplete: no epoch snapshot of it
            return
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")
            self._rotate_epochs()
        if self.training_state and (epoch + 1) % self.save_freq == 0:
            mgr = self._manager()
            # skip a boundary the step cadence captured already
            if mgr.last_captured_step() < mgr.global_step:
                mgr.save(self.model._training_state(), **self._cursor(mgr))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")
        if self.training_state and self._mgr is not None:
            if self._owns_mgr:
                self._mgr.close()
            else:
                self._mgr.flush()

    def _rotate_epochs(self):
        """Keep the newest max_checkpoint_num epoch snapshots (numeric
        prefixes only: 'final' and other files stay)."""
        if self.max_checkpoint_num <= 0 or not self.save_dir:
            return
        try:
            epochs = sorted(
                int(f[:-len(".pdparams")])
                for f in os.listdir(self.save_dir)
                if f.endswith(".pdparams")
                and f[:-len(".pdparams")].isdigit())
        except OSError:
            return
        for e in epochs[:-self.max_checkpoint_num]:
            for suffix in (".pdparams", ".pdopt"):
                try:
                    os.remove(os.path.join(self.save_dir, f"{e}{suffix}"))
                except OSError:
                    pass


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        lr = getattr(getattr(self.model, "_optimizer", None),
                     "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda cur, best: cur > best + self.min_delta
        else:
            self.better = lambda cur, best: cur < best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._records = []

    def on_train_batch_end(self, step, logs=None):
        self._records.append(("train", step, dict(logs or {})))


class Telemetry(Callback):
    """Per-step training telemetry: drives a monitor.StepTimer so every
    Model.fit step records step time, throughput, loss, lr and the
    card's memory gauges under `step/...`. config_callbacks installs
    one; pass your own instance to share its StepTimer."""

    def __init__(self, step_timer=None):
        super().__init__()
        if step_timer is None:
            from .. import monitor as _mon

            step_timer = _mon.StepTimer()
        self.step_timer = step_timer

    def _lr(self):
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return None
        try:
            return float(opt.get_lr())
        except Exception:
            return None

    def on_train_batch_begin(self, step, logs=None):
        self.step_timer.begin_step()

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        loss = logs.get("loss")
        if isinstance(loss, (list, tuple)):
            loss = loss[0] if loss else None
        self.step_timer.end_step(batch_size=logs.get("batch_size"),
                                 loss=loss, lr=self._lr())


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if not any(isinstance(c, Telemetry) for c in cbks):
        # FIRST in dispatch order: on_train_batch_end must read the lr
        # the step ran at, before any LRScheduler callback advances it
        cbks.insert(0, Telemetry())
    cl = CallbackList(cbks)
    for c in cbks:
        c.set_model(model)
        c.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                      "metrics": metrics or []})
    return cl
