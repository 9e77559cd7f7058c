"""Auto checkpoint / resume, job-keyed epoch ranges: the port of
`paddle_tpu/incubate/checkpoint/auto_checkpoint.py` (:43-217; reference:
fluid/incubate/checkpoint/auto_checkpoint.py, AutoCheckpointChecker:71,
train_epoch_range:598).

    register("model", model); register("opt", opt)
    for epoch in train_epoch_range(90):
        train_one_epoch()

- `AutoCheckpointChecker` reads the EDL env contract: the feature is on
  when PADDLE_RUNNING_ENV == PADDLE_EDL_AUTO_CHECKPOINT or
  PADDLE_CHECKPOINT_DIR is set; otherwise the range is a plain range.
- Ranges are named: two loops in one job checkpoint apart.
- A save writes every registered object's `state_dict()` through
  `framework.save` into `<job>/<range>/epoch_<N>.tmp/`, then
  `meta.json`, and renames the directory into place; the newest
  PADDLE_EDL_MAX_CHECKPOINT_NUM are kept, and restore falls back past a
  torn one to the newest valid one.
- Saves fire on the epoch interval, on the last epoch and when
  PADDLE_EDL_SAVE_CHECKPOINT_INTER seconds have passed; only trainer 0
  writes, every trainer restores.

The JAX package stores through the fleet FS abstraction (`LocalFS`);
here the local filesystem is used directly.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import time

from ... import framework

__all__ = ["AutoCheckpointChecker", "train_epoch_range", "register",
           "clear_registry", "checkpoint_dir", "job_id",
           "save_checkpoint", "load_checkpoint"]

_registered = []  # (name, obj with state_dict / set_state_dict)


class AutoCheckpointChecker:
    """The env contract (reference AutoCheckpointChecker:71)."""

    def __init__(self):
        self.run_env = os.getenv("PADDLE_RUNNING_ENV")
        self.job_id = os.getenv("PADDLE_JOB_ID", "default_job")
        self.trainer_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self.checkpoint_path = os.getenv(
            "PADDLE_CHECKPOINT_DIR",
            os.getenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH",
                      os.path.join(".", "auto_checkpoint")))
        self.save_checkpoint_inter = int(os.getenv(
            "PADDLE_EDL_SAVE_CHECKPOINT_INTER", "900"))
        self.max_checkpoint_num = int(os.getenv(
            "PADDLE_EDL_MAX_CHECKPOINT_NUM", "2"))

    @property
    def enabled(self):
        return (self.run_env == "PADDLE_EDL_AUTO_CHECKPOINT"
                or "PADDLE_CHECKPOINT_DIR" in os.environ)

    def job_dir(self):
        return os.path.join(self.checkpoint_path, self.job_id)


def job_id():
    return AutoCheckpointChecker().job_id


def checkpoint_dir():
    return AutoCheckpointChecker().job_dir()


def register(name, obj):
    """Register an object with state_dict / set_state_dict (a model, an
    optimizer) for auto checkpointing."""
    _registered.append((name, obj))
    return obj


def clear_registry():
    _registered.clear()


class _Range:
    """One named resumable range (reference TrainEpochRange)."""

    def __init__(self, name, checker=None):
        self.checker = checker or AutoCheckpointChecker()
        self.name = name
        self.dir = os.path.join(self.checker.job_dir(), name)
        self._last_save_t = time.time()

    def _epoch_dir(self, epoch):
        return os.path.join(self.dir, f"epoch_{epoch}")

    def _snapshots(self):
        if not os.path.isdir(self.dir):
            return []
        out = []
        for base in os.listdir(self.dir):
            if base.startswith("epoch_") and os.path.isdir(
                    os.path.join(self.dir, base)):
                try:
                    out.append(int(base[len("epoch_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, epoch):
        if self.checker.trainer_id != 0:
            return  # only trainer 0 writes
        d = self._epoch_dir(epoch)
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, obj in _registered:
            framework.save(obj.state_dict(), os.path.join(tmp, name + ".pd"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "ts": time.time(),
                       "names": [n for n, _ in _registered],
                       "complete": True}, f)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)  # atomic publish: no torn snapshots
        self._last_save_t = time.time()
        for old in self._snapshots()[:-self.checker.max_checkpoint_num]:
            shutil.rmtree(self._epoch_dir(old), ignore_errors=True)

    def restore(self):
        """Restore the newest valid snapshot into the registered objects;
        its epoch, or -1."""
        for epoch in reversed(self._snapshots()):
            d = self._epoch_dir(epoch)
            try:
                with open(os.path.join(d, "meta.json")) as f:
                    meta = json.load(f)
                if not meta.get("complete"):
                    continue
                for name, obj in _registered:
                    p = os.path.join(d, name + ".pd")
                    if os.path.exists(p):
                        obj.set_state_dict(framework.load(p))
                return int(meta["epoch"])
            except (OSError, ValueError, KeyError, EOFError,
                    pickle.UnpicklingError):
                continue  # torn snapshot: the one before
        return -1

    def due(self, epoch, save_inter_epochs, max_epoch_num):
        """Save on the epoch interval, on the last epoch, or when the
        time interval has passed."""
        if epoch == max_epoch_num - 1:
            return True
        if (epoch + 1) % max(save_inter_epochs, 1) == 0:
            return True
        return (time.time() - self._last_save_t
                >= self.checker.save_checkpoint_inter)


def save_checkpoint(epoch, name="default_range"):
    _Range(name).save(epoch)


def load_checkpoint(name="default_range"):
    return _Range(name).restore()


def train_epoch_range(max_epoch_num, save_checkpoint_inter=1,
                      name="default_range"):
    """Resumable epoch generator (reference train_epoch_range:598): a
    fresh job yields 0..N-1 and snapshots the registered objects; a
    relaunch with the same PADDLE_JOB_ID restores the newest valid
    snapshot and resumes at the first incomplete epoch. Without the env
    contract: a plain range."""
    checker = AutoCheckpointChecker()
    if not checker.enabled:
        yield from range(max_epoch_num)
        return
    rng = _Range(name, checker)
    last_done = rng.restore()
    for epoch in range(last_done + 1, max_epoch_num):
        yield epoch
        if rng.due(epoch, save_checkpoint_inter, max_epoch_num):
            rng.save(epoch)
