"""Elastic training checkpoints, the port of
`paddle_tpu/incubate/checkpoint/elastic.py` (:82-110, 225-772):
`CheckpointManager`, the store under `hapi.Model.fit(resume=...)`.

    mgr = CheckpointManager(save_steps=4, max_num=2)   # device: the card
    mgr.save(state, epoch=0, step_in_epoch=3, global_step=4)
    state = mgr.restore()        # newest valid snapshot, or None
    mgr.cursor                   # {epoch, step_in_epoch, global_step}

A snapshot is any nested dict / list / tuple of tensors, numpy arrays
and plain values; `hapi.Model._training_state` decides what goes in.

- Capture. `save()` copies every tensor of the tree to the host before
  it returns: the next step's optimizer launch overwrites the
  parameters and slots in place, so a writer holding device tensors
  would write a snapshot torn between two steps. CUDA tensors go into
  reused pinned host buffers by `non_blocking` copies, then the
  stream is synchronised once; CPU tensors are copied into reused
  buffers. A buffer returns to the pool when no snapshot holds it, and
  a capture first lets go of the snapshots it supersedes, so two sets
  (the writer's and the new one) serve the steady state.
- Async writes. The writer thread only pickles and fsyncs host bytes
  (`framework._dump`, protocol 5: each tensor's bytes go to the file
  from its buffer). One slot, latest wins: a save arriving while the
  previous one still waits drops that one (`ckpt/dropped`).
  `sync=True`, `async_write=False` or preemption write on the caller's
  thread.
- Layout, rotated to the newest `max_num`:

      <dir>/step_<G>/state_rank<r>.pd   rank r's whole tree (atomic)
      <dir>/step_<G>/manifest.json      rank 0, written last (atomic)

  Data-parallel ranks hold full replicas, so each rank writes its whole
  tree (the JAX package's shard pieces and layout specs, `_mesh_axes`,
  `_spec_of`, `_shard_pieces`, `_merge_trees`, are not ported), and
  `restore()` reads this rank's own file: its error-feedback residual
  is its own. A snapshot counts only with its manifest and every rank
  file of the manifest's world; a torn or incomplete one falls back to
  the one before.
- `dir` defaults to the EDL env contract:
  <PADDLE_CKPT_DIR|PADDLE_CHECKPOINT_DIR|PADDLE_EDL_HDFS_CHECKPOINT_PATH
  |./auto_checkpoint>/<PADDLE_JOB_ID>/train_state, so a relaunch with
  the same PADDLE_JOB_ID finds the snapshots.
- Emergencies: `set_state_provider(fn)` (refreshed by the fit callback
  at every step boundary), `emergency_save(reason)`, and
  `install_preemption_handler()` (SIGTERM, or PADDLE_CKPT_PREEMPT_SIGNAL):
  the handler sets `preempted`, the fit saves synchronously at its next
  boundary and stops, and a background thread saves through the
  provider if no boundary save lands within the grace window.
- Counters: ckpt/{saves, async_inflight, write_us, bytes, dropped,
  errors, emergency_saves, restores, capture_us} (`core.monitor`).
- Monitor hooks (JAX :72-74, 291-305, 349-354, 380-520, 569-744): the
  `ckpt_write` chaos site (its `torn` fault writes half a rank file and
  no manifest, then raises; `enospc` raises ENOSPC), each write inside
  `in_flight("ckpt_write")`, the `ckpt_save` / `ckpt_error` /
  `ckpt_restore` / `ckpt_emergency` / `preempt` flight events and the
  "preempt" dump bundle, the sanitizer's `lock` / `condition`, the
  PTA043 ownership check of each capture under
  PADDLE_SANITIZE=donation, and `_on_incident`: `arm()` registers it
  as a flight incident hook, so a watchdog fire writes an emergency
  snapshot next to the bundle.
"""
from __future__ import annotations

import glob as _glob
import io
import json
import os
import pickle
import shutil
import signal
import threading
import time

import numpy as np
import torch

from ... import framework as _framework
from ...core import monitor as _cmon
from ...core.monitor import _env_float, _env_int, _env_on
from ...device import resolve_device
from ...monitor import chaos as _chaos
from ...monitor import flight as _flight
from ...monitor import sanitize as _sanitize

__all__ = ["CheckpointManager", "SCHEMA", "default_checkpoint_dir"]

SCHEMA = "paddle_tpu.ckpt/1"


def default_checkpoint_dir(name="train_state"):
    """EDL env contract -> snapshot directory."""
    root = (os.environ.get("PADDLE_CKPT_DIR")
            or os.environ.get("PADDLE_CHECKPOINT_DIR")
            or os.environ.get("PADDLE_EDL_HDFS_CHECKPOINT_PATH")
            or os.path.join(".", "auto_checkpoint"))
    job = os.environ.get("PADDLE_JOB_ID", "default_job")
    return os.path.join(root, job, name)


def _rank_world():
    from ...distributed.env import get_rank, get_world_size

    return get_rank(), get_world_size()


class _HostPool:
    """Host buffers reused across captures, by (shape, dtype); pinned
    for a card."""

    def __init__(self, pin):
        self._pin = pin
        self._free = {}
        self._lock = threading.Lock()

    def take(self, shape, dtype):
        with self._lock:
            free = self._free.get((tuple(shape), dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    def give(self, bufs):
        with self._lock:
            for b in bufs:
                self._free.setdefault((tuple(b.shape), b.dtype),
                                      []).append(b)


class _Snapshot:
    """A captured host tree, its manifest meta and the pooled buffers it
    holds; the buffers go back to the pool when `refs` reaches 0."""

    __slots__ = ("tree", "meta", "bufs", "refs")

    def __init__(self, tree, meta, bufs):
        self.tree, self.meta, self.bufs, self.refs = tree, meta, bufs, 0


# what a truncated or corrupt pickle or manifest can raise
_TORN = (OSError, ValueError, KeyError, EOFError, pickle.UnpicklingError)


class CheckpointManager:
    """Async, rotated training-state snapshots with preemption and
    emergency saves (see the module docstring).

    Cadence (`due(global_step)`): every `save_steps` steps when > 0
    (PADDLE_CKPT_SAVE_STEPS), else every `save_interval_s` seconds
    (PADDLE_CKPT_INTERVAL_S, default PADDLE_EDL_SAVE_CHECKPOINT_INTER =
    900). Rotation keeps the newest `max_num` (PADDLE_CKPT_MAX_NUM,
    default PADDLE_EDL_MAX_CHECKPOINT_NUM = 2). `async_write`
    (PADDLE_CKPT_ASYNC, default on). `device` (None: the card) is where
    the captured tensors live: a card's are copied into pinned buffers;
    "cpu" pins nothing. `restore()` returns CPU tensors."""

    def __init__(self, dir=None, name="train_state", save_steps=None,
                 save_interval_s=None, max_num=None, async_write=None,
                 *, device=None):
        self.device = resolve_device(device)
        self.dir = dir or default_checkpoint_dir(name)
        if save_steps is None:
            save_steps = _env_int("PADDLE_CKPT_SAVE_STEPS", 0)
        self.save_steps = max(0, int(save_steps))
        if save_interval_s is None:
            save_interval_s = _env_float(
                "PADDLE_CKPT_INTERVAL_S",
                _env_float("PADDLE_EDL_SAVE_CHECKPOINT_INTER", 900.0))
        self.save_interval_s = float(save_interval_s)
        if max_num is None:
            max_num = _env_int("PADDLE_CKPT_MAX_NUM",
                               _env_int("PADDLE_EDL_MAX_CHECKPOINT_NUM", 2))
        self.max_num = max(1, int(max_num))
        if async_write is None:
            async_write = _env_on("PADDLE_CKPT_ASYNC", True)
        self.async_write = bool(async_write)
        self.rank, self.world_size = _rank_world()
        self.global_step = 0     # completed optimizer microsteps
        self.cursor = None       # set by restore(): where to resume
        self.preempted = threading.Event()
        self._pool = _HostPool(pin=self.device.type == "cuda")
        # sanitize-aware primitives (PADDLE_SANITIZE=locks): plain
        # threading objects when disarmed
        self._cv = _sanitize.condition("ckpt.cv")
        self._pending = None     # latest-wins _Snapshot slot
        self._busy = False
        self._writer = None
        self._closed = False
        self._last = None        # newest captured _Snapshot
        self._durable_step = -1  # newest step on disk
        self._last_save_t = time.monotonic()
        self._state_provider = None
        self._prev_sig = None
        self._preempt_thread = None
        self._preempt_grace_s = 10.0  # window for the loop's own save
        self._lock_timeout_s = 15.0   # bounded waits on a wedged writer
        self._closing = threading.Event()
        self._write_lock = _sanitize.lock("ckpt.writer")  # vs emergency

    # -- cadence ----------------------------------------------------------
    def due(self, global_step):
        if self.preempted.is_set():
            return True
        if self.save_steps > 0:
            return global_step % self.save_steps == 0
        if time.monotonic() - self._last_save_t < self.save_interval_s:
            return False
        if self.world_size > 1:
            # every rank must pick the same step, or the snapshot is
            # torn: quantize the time cadence to every 8th step
            return global_step % 8 == 0
        return True

    def maybe_save(self, state_fn, epoch=0, step_in_epoch=0,
                   global_step=None, sync=False):
        g = self.global_step if global_step is None else int(global_step)
        if not self.due(g):
            return False
        self.save(state_fn(), epoch=epoch, step_in_epoch=step_in_epoch,
                  global_step=g, sync=sync)
        return True

    # -- capture ----------------------------------------------------------
    def _capture(self, state):
        """(host tree, pooled buffers): every tensor of `state` copied
        into a pooled host buffer (a card's by non_blocking copies into
        pinned memory, then one synchronise of each card's stream);
        numpy arrays copied; other leaves as they are."""
        bufs, streams = [], {}

        def host(obj):
            if isinstance(obj, torch.Tensor):
                t = obj.detach()
                buf = self._pool.take(t.shape, t.dtype)
                bufs.append(buf)
                if t.device.type == "cuda":
                    buf.copy_(t, non_blocking=True)
                    streams[t.device] = torch.cuda.current_stream(t.device)
                else:
                    buf.copy_(t)
                return buf
            if isinstance(obj, np.ndarray):
                return np.array(obj)
            if isinstance(obj, dict):
                return {k: host(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(host(v) for v in obj)
            return obj

        t0 = time.perf_counter()
        tree = host(state)
        for s in streams.values():
            s.synchronize()
        if _sanitize._donation:
            # PTA043: every leaf must own its memory — a view of a
            # pooled buffer would change under the snapshot when the
            # next capture reuses that buffer
            tree = _sanitize.verify_host_tree(
                tree, site="ckpt.save", what="checkpoint snapshot")
        _cmon.stat_add("ckpt/capture_us",
                       int((time.perf_counter() - t0) * 1e6))
        return tree, bufs

    def _snapshot(self, state, g, epoch, step_in_epoch, **extra):
        tree, bufs = self._capture(state)
        meta = {"schema": SCHEMA, "step": int(g), "epoch": int(epoch),
                "step_in_epoch": int(step_in_epoch),
                "ts": round(time.time(), 3), "world_size": self.world_size,
                "complete": True, **extra}
        return _Snapshot(tree, meta, bufs)

    def _hold(self, snap):
        snap.refs += 1
        return snap

    def _release(self, snap):
        """Drop one hold (under self._cv); the last returns the buffers."""
        if snap is None:
            return
        snap.refs -= 1
        if snap.refs == 0:
            self._pool.give(snap.bufs)
            snap.bufs = ()

    # -- save path --------------------------------------------------------
    def save(self, state, epoch=0, step_in_epoch=0, global_step=None,
             sync=False):
        """Snapshot `state` for step `global_step`. The device-to-host
        copy happens here, before this returns; pickling and the disk
        happen on the writer thread unless `sync`."""
        g = self.global_step if global_step is None else int(global_step)
        inline = sync or not self.async_write
        with self._cv:
            # this capture supersedes the newest one and, on the async
            # path, a snapshot still waiting for the writer (latest
            # wins): their buffers go back to the pool first, so that
            # steady state needs two sets, the writer's and this one
            old, self._last = self._last, None
            self._release(old)
            if not inline and self._pending is not None:
                _cmon.stat_add("ckpt/dropped", 1)
                self._release(self._pending)
                self._pending = None
        snap = self._snapshot(state, g, epoch, step_in_epoch)
        with self._cv:
            self._last = self._hold(snap)
        self._last_save_t = time.monotonic()
        if inline:
            with self._cv:
                self._hold(snap)
            try:
                # bounded lock wait when a writer thread exists: the
                # preemption save runs on the fit's thread, and a writer
                # wedged on a hung filesystem must not turn
                # checkpoint-then-stop into a hang
                self._write_snapshot(
                    snap, lock_timeout=(self._lock_timeout_s
                                        if self.async_write else None))
            except Exception as e:
                # best effort like the writer path: a full disk must not
                # crash the fit out of checkpoint-then-stop
                _cmon.stat_add("ckpt/errors", 1)
                _flight.record("ckpt_error",
                               error=f"{type(e).__name__}: {e}"[:200])
            finally:
                with self._cv:
                    self._release(snap)
            return
        self._ensure_writer()
        with self._cv:
            if self._pending is not None:
                # latest wins: never queue behind a slow disk
                _cmon.stat_add("ckpt/dropped", 1)
                self._release(self._pending)
            self._pending = self._hold(snap)
            _cmon.stat_set("ckpt/async_inflight", 1)
            self._cv.notify_all()

    def _ensure_writer(self):
        if self._writer is not None and self._writer.is_alive():
            return
        self._closed = False
        self._writer = threading.Thread(
            target=self._writer_loop, name="paddle-ckpt-writer",
            daemon=True)
        self._writer.start()

    def _writer_loop(self):
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None:
                    return  # closed and drained
                snap, self._pending = self._pending, None
                self._busy = True
            try:
                self._write_snapshot(snap)
            except Exception as e:
                _cmon.stat_add("ckpt/errors", 1)
                _flight.record("ckpt_error",
                               error=f"{type(e).__name__}: {e}"[:200])
            finally:
                with self._cv:
                    self._release(snap)
                    self._busy = False
                    _cmon.stat_set("ckpt/async_inflight",
                                   int(self._pending is not None))
                    self._cv.notify_all()

    def last_captured_step(self):
        """Newest step `save()` captured (on disk or still with the
        writer); -1 before the first."""
        with self._cv:
            return self._last.meta["step"] if self._last is not None \
                else -1

    def flush(self, timeout=30.0):
        """Block until the writer drained. False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def _step_dir(self, g):
        return os.path.join(self.dir, f"step_{g}")

    @staticmethod
    def _rank_of(path):
        base = os.path.basename(path)
        try:
            return int(base[len("state_rank"):-len(".pd")])
        except ValueError:
            return -1

    def _snapshot_steps(self):
        out = []
        for p in _glob.glob(os.path.join(self.dir, "step_*")):
            try:
                out.append(int(os.path.basename(p)[len("step_"):]))
            except ValueError:
                continue
        return sorted(out)

    def _write_snapshot(self, snap, lock_timeout=None):
        g = snap.meta["step"]
        t0 = time.perf_counter()
        if lock_timeout is None:
            self._write_lock.acquire()
        elif not self._write_lock.acquire(timeout=lock_timeout):
            # the writer thread is wedged inside a write: an emergency
            # save must not block behind it
            raise TimeoutError("checkpoint writer lock held past "
                               f"{lock_timeout}s")
        nbytes = [0]

        def write(f):
            _framework._dump({"schema": SCHEMA, "state": snap.tree}, f)
            nbytes[0] = f.tell()

        try:
            with _flight.in_flight("ckpt_write", f"step_{g}"):
                d = self._step_dir(g)
                os.makedirs(d, exist_ok=True)
                own = os.path.join(d, f"state_rank{self.rank}.pd")
                # chaos site "ckpt_write": enospc/delay/stall enact
                # inside hit(); "torn" comes back for us to enact — a
                # PARTIAL rank file bypassing the atomic writer and no
                # manifest, what a crash mid-write leaves (restore()
                # skips it and falls back to the previous snapshot)
                if _chaos._armed:
                    act = _chaos.hit("ckpt_write", step=g)
                    if act is not None and act.fault == "torn":
                        buf = io.BytesIO()
                        write(buf)
                        payload = buf.getvalue()
                        with open(own, "wb") as fh:
                            fh.write(payload[:max(1, len(payload) // 2)])
                        raise OSError(
                            "chaos: torn checkpoint write (injected)")
                _framework._atomic_write(own, write)
                if self.rank == 0:
                    # the manifest last: its presence is the published-
                    # snapshot marker
                    payload = json.dumps(snap.meta, indent=1).encode()
                    _framework._atomic_write(
                        os.path.join(d, "manifest.json"),
                        lambda f: f.write(payload))
                    self._rotate()
        finally:
            self._write_lock.release()
        self._durable_step = max(self._durable_step, g)
        us = int((time.perf_counter() - t0) * 1e6)
        _cmon.stat_add("ckpt/saves", 1)
        _cmon.stat_add("ckpt/write_us", us)
        _cmon.stat_add("ckpt/bytes", nbytes[0])
        _flight.record("ckpt_save", step=g, bytes=nbytes[0], us=us)

    def _rotate(self):
        for g in self._snapshot_steps()[:-self.max_num]:
            shutil.rmtree(self._step_dir(g), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self):
        """Load the newest valid snapshot (its tensors on the CPU), or
        None. Torn snapshots (a truncated pickle, a missing rank file, a
        corrupt manifest) fall back to the one before. Sets `cursor` to
        {epoch, step_in_epoch, global_step} and `global_step`."""
        for g in reversed(self._snapshot_steps()):
            d = self._step_dir(g)
            try:
                with open(os.path.join(d, "manifest.json")) as f:
                    meta = json.load(f)
                if not meta.get("complete"):
                    continue
                # only the ranks the manifest's world wrote: a step dir
                # rewritten after a world shrink may hold stale files
                ws = int(meta.get("world_size") or 1)
                files = {self._rank_of(fp): fp for fp in _glob.glob(
                    os.path.join(d, "state_rank*.pd"))}
                if any(r not in files for r in range(ws)):
                    continue  # a missing rank file
                own = files[self.rank if self.rank < ws else 0]
                with open(own, "rb") as f:
                    state = _framework._load(f)["state"]
                self.cursor = {"epoch": int(meta["epoch"]),
                               "step_in_epoch": int(meta["step_in_epoch"]),
                               "global_step": int(meta["step"])}
                self.global_step = int(meta["step"])
                self._durable_step = int(meta["step"])
                _cmon.stat_add("ckpt/restores", 1)
                _flight.record("ckpt_restore", step=meta["step"])
                return state
            except _TORN:
                continue  # torn snapshot: the one before
        return None

    # -- emergency (preemption) -------------------------------------------
    def set_state_provider(self, fn):
        """fn() -> (state, {"epoch", "step_in_epoch", "global_step"}),
        refreshed by the fit callback at every step boundary, so an
        emergency save captures the last completed step."""
        self._state_provider = fn

    def emergency_save(self, reason="emergency"):
        """Best-effort synchronous checkpoint: a fresh capture through
        the state provider, else the newest captured snapshot if it is
        not on disk yet. Returns the step written, or None (which
        includes "the newest capture is already on disk")."""
        prov = self._state_provider
        snap = None
        if prov is not None:
            try:
                state, cur = prov()
                snap = self._snapshot(
                    state, cur.get("global_step", 0), cur.get("epoch", 0),
                    cur.get("step_in_epoch", 0), reason=reason)
            except Exception:
                snap = None  # a capture mid-step may fail: the fallback
        with self._cv:
            if snap is None:
                last = self._last
                if last is None or last.meta["step"] <= self._durable_step:
                    return None
                snap = last
            self._hold(snap)
        try:
            self._write_snapshot(snap, lock_timeout=self._lock_timeout_s)
        except Exception:
            _cmon.stat_add("ckpt/errors", 1)
            return None
        finally:
            with self._cv:
                self._release(snap)
        _cmon.stat_add("ckpt/emergency_saves", 1)
        _flight.record("ckpt_emergency", reason=reason,
                       step=snap.meta["step"])
        return snap.meta["step"]

    def _on_incident(self, reason):
        self.emergency_save(reason)

    # -- arming -----------------------------------------------------------
    def arm(self):
        """Watchdog checkpoint-then-abort and preemption: a watchdog
        fire (an incident hook) or a SIGTERM now produces a resumable
        snapshot."""
        self._closing.clear()
        # a preemption flag latched by a previous fit must not stop this
        # one at its first boundary
        self.preempted.clear()
        _flight.add_incident_hook(self._on_incident)
        self.install_preemption_handler()
        return self

    def install_preemption_handler(self, signum=None):
        """Chain a checkpoint-then-stop handler onto the preemption
        signal (PADDLE_CKPT_PREEMPT_SIGNAL, default SIGTERM; a falsy
        value disables). Main thread only; True when installed."""
        if signum is None:
            name = os.environ.get("PADDLE_CKPT_PREEMPT_SIGNAL",
                                  "SIGTERM").strip()
            if name.lower() in ("", "0", "off", "none", "no"):
                return False
            signum = getattr(signal, name, None)
            if signum is None:
                try:
                    signum = int(name)
                except ValueError:
                    return False
        if threading.current_thread() is not threading.main_thread():
            return False
        if self._prev_sig is not None:
            return self._prev_sig[0] == signum
        try:
            prev = signal.signal(signum, self._on_preempt_signal)
        except (ValueError, OSError):
            return False
        self._prev_sig = (signum, prev)
        return True

    def uninstall_preemption_handler(self):
        if self._prev_sig is None:
            return
        signum, prev = self._prev_sig
        try:
            # == not `is`: each access builds a new bound method
            if signal.getsignal(signum) == self._on_preempt_signal:
                signal.signal(signum, prev if prev is not None
                              else signal.SIG_DFL)
            # else someone chained onto us: leave their chain alone
        except (ValueError, OSError):
            pass
        self._prev_sig = None

    def _on_preempt_signal(self, signum, frame):
        self.preempted.set()
        _flight.record("preempt", signal=int(signum))

        def _bg():
            # off the handler (it runs between bytecodes, possibly over a
            # held recorder/registry lock)
            try:
                _flight.write_dump("preempt",
                                   extra={"signal": int(signum)})
            except Exception:
                pass
            # a live fit loop saves its next boundary itself; only when
            # none lands within the grace window is the provider asked
            start = self._durable_step
            deadline = time.monotonic() + self._preempt_grace_s
            while time.monotonic() < deadline:
                if (self._durable_step > start or self._closed
                        or self._closing.is_set()):
                    return
                time.sleep(0.2)
            self.emergency_save("preempt")

        self._preempt_thread = threading.Thread(
            target=_bg, name="paddle-ckpt-preempt", daemon=True)
        self._preempt_thread.start()
        prev = self._prev_sig[1] if self._prev_sig else None
        if callable(prev):
            prev(signum, frame)

    def close(self, timeout=30.0):
        """Disarm the hooks and drain and join the writer (fit exit)."""
        self._closing.set()
        _flight.remove_incident_hook(self._on_incident)
        self.uninstall_preemption_handler()
        t, self._preempt_thread = self._preempt_thread, None
        if t is not None and t.is_alive():
            t.join(timeout)
        self._state_provider = None
        ok = self.flush(timeout)
        with self._cv:
            self._closed = True
            # nothing can use the emergency fallback any more: let its
            # buffers go
            old, self._last = self._last, None
            self._release(old)
            self._cv.notify_all()
        w, self._writer = self._writer, None
        if w is not None and w.is_alive():
            w.join(timeout)
        return ok
