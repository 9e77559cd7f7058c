"""Multiprocess DataLoader workers with shared-memory transport, the port
of `paddle_tpu/io/worker.py`.

Parity target: python/paddle/fluid/dataloader/dataloader_iter.py:326
(_DataLoaderIterMultiProcess), worker.py (worker loop + WorkerInfo),
and the mmap shared-memory tensor path
(paddle/fluid/memory/allocation/mmap_allocator.cc).

Design (the JAX package's): each worker OWNS one C shared-memory SPSC
ring (`csrc/shm_ring.cc`, lock-free head/tail atomics, built with g++
into `_build/` at first use and bound with ctypes); batches are pickled
(protocol 5) straight into the ring slot, so worker->trainer transport
never touches a pipe. Batch i is assigned to worker i % W and the
trainer pops rings in that order — global batch order is deterministic
regardless of worker speed (the reference's reorder buffer, by
construction). The trainer copies each batch out of its slot: into a
pinned staging buffer on the way to the card, or into a tensor of its
own on the CPU (`paddle_tpu_torch.io`).

Workers are forked from the trainer, whose CUDA context may be live: a
worker never touches CUDA. It stays numpy end to end, runs torch on
one thread (a forked OpenMP pool can hang), and seeds numpy's global
RNG and torch's CPU default generator with `base_seed + id`.

Port addition: `MultiprocessLoader` checks that the shared-memory
filesystem has room for every ring before it forks (a ring that
outgrows a full tmpfs dies of SIGBUS on first write), and raises
OSError naming both sizes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import subprocess
import sys as _sys
import threading
from pathlib import Path

import numpy as np

from ..monitor import chaos as _chaos
from ..monitor import sanitize as _sanitize

_EOF = b"\x00PDEOF"
_ERR = b"\x00PDERR"
# skip marker (on_bad_sample="skip"): pickle of (partial batch or
# None, n_skipped, formatted traceback of the last failure) — the
# trainer counts io/bad_samples and drops a fully-failed batch
_SKP = b"\x00PDSKP"

# run_epoch-internal sentinel: a fed index batch whose every sample
# failed under the skip policy — consumed (the fed/popped accounting
# must advance) but never yielded
_SKIPPED = object()

_bad_sample_logged = [False]

_PKG_DIR = Path(__file__).resolve().parents[1]
_RING_SRC = _PKG_DIR / "csrc" / "shm_ring.cc"
_BUILD_DIR = _PKG_DIR / "_build"
_SHM_DIR = "/dev/shm"


def note_bad_samples(n, err, worker=None):
    """Trainer-side accounting for skipped samples: counter + flight
    event always, and the FIRST failure's traceback once at VLOG(0) —
    on_bad_sample='skip' must not force an operator to rerun in
    'raise' mode just to learn WHY records are failing."""
    from ..core import monitor as _monitor
    from ..monitor import flight as _flight

    _monitor.stat_add("io/bad_samples", n)
    _flight.record("io_bad_sample", n=n, worker=worker)
    if err and not _bad_sample_logged[0]:
        _bad_sample_logged[0] = True
        try:
            _monitor.VLOG(
                0, "DataLoader on_bad_sample='skip' dropped a sample "
                   "(io/bad_samples counts them); first failure:\n"
                   + str(err))
        except Exception:
            pass

# zero-copy frame: magic(8) meta_len(8) nbufs(8) [off(8) len(8)]*n
# meta-pickle then 64B-aligned out-of-band buffers. Arrays deserialize
# ALIASING the shm slot — the slot is held until the next pop on the
# same ring, and the trainer's copy out of it (pinned staging buffer or
# a CPU tensor of its own) is the single remaining copy.
_ZC_MAGIC = b"PDZC\x01\x00\x00\x00"


def _zero_copy_enabled():
    return os.environ.get("FLAGS_dataloader_zero_copy", "1") != "0"


def _overlap_decode_enabled():
    """Worker-side decode/collate overlap (PADDLE_IO_OVERLAP_DECODE,
    default on): a decode thread runs dataset[i] fetches one index
    batch AHEAD while the worker main thread collates into / waits on
    the shm ring — sample decode rides under ring backpressure instead
    of serializing behind it."""
    return os.environ.get("PADDLE_IO_OVERLAP_DECODE", "1") not in (
        "0", "false", "off")


def _slot_overflow(nbytes, slot_bytes):
    return ValueError(
        f"batch of {nbytes} bytes exceeds the shared-memory slot "
        f"({slot_bytes}B) — raise FLAGS_dataloader_shm_slot_mb or "
        "shrink the batch")


def _push_batch(ring, batch):
    """Serialize a batch into `ring`. Zero-copy framing when enabled:
    pickle protocol-5 splits numpy array bodies out as buffers, and
    both the metadata and the buffers are written DIRECTLY into the
    reserved shm slot (no intermediate bytes object, no second copy in
    ring_push)."""
    import struct

    if not _zero_copy_enabled():
        ring.push(pickle.dumps(batch, protocol=5))
        return
    bufs = []
    meta = pickle.dumps(batch, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw().cast("B") for b in bufs]
    n = len(raws)
    header = 24 + n * 16
    off = header + len(meta)
    table = []
    for r in raws:
        off = (off + 63) & ~63          # 64B-align each array body
        table.append((off, r.nbytes))
        off += r.nbytes
    total = off
    if total > ring.slot_bytes:
        raise _slot_overflow(total, ring.slot_bytes)
    mv = ring.reserve()
    struct.pack_into("<8sQQ", mv, 0, _ZC_MAGIC, len(meta), n)
    for i, (o, ln) in enumerate(table):
        struct.pack_into("<QQ", mv, 24 + i * 16, o, ln)
    mv[header:header + len(meta)] = meta
    for (o, ln), r in zip(table, raws):
        mv[o:o + ln] = r
    mv.release()
    ring.commit(total)


# the stacked fast path writes array bodies at fixed offsets after a
# reserved header page, so collation happens DIRECTLY into the slot
# (one copy per sample total: sample -> shm; the separate np.stack
# batch materialization disappears)
_ZC_HEADER_BYTES = 4096


def _try_push_stacked(ring, samples):
    """Collate-into-slot fast path for the default collate: samples
    that are flat tuples/lists of array-likes with identical structure
    stack straight into the reserved shm slot. Returns False when the
    structure is unsupported (caller falls back to collate+push)."""
    import struct

    first = samples[0]
    if not isinstance(first, (tuple, list)):
        return False
    k = len(first)
    try:
        arrs0 = [np.asarray(f) for f in first]
    except Exception:
        return False
    if any(a.dtype == object for a in arrs0):
        return False
    B = len(samples)
    off = _ZC_HEADER_BYTES
    layout = []
    for a in arrs0:
        off = (off + 63) & ~63
        nbytes = int(a.nbytes) * B
        layout.append((off, (B,) + a.shape, a.dtype))
        off += nbytes
    total = off
    if total > ring.slot_bytes:
        raise _slot_overflow(total, ring.slot_bytes)
    mv = ring.reserve()
    views = batch = bufs = None
    try:
        views = []
        for o, shape, dtype in layout:
            v = np.frombuffer(mv, dtype=dtype,
                              count=int(np.prod(shape)),
                              offset=o).reshape(shape)
            views.append(v)
        for j, s in enumerate(samples):
            if len(s) != k:
                return False
            for i in range(k):
                src = np.asarray(s[i])
                if src.shape != layout[i][1][1:]:
                    # np.stack would raise on ragged samples — don't
                    # silently broadcast a wrong-shaped one; the
                    # generic fallback surfaces the real error
                    return False
                if src.dtype != layout[i][2]:
                    # np.stack would PROMOTE mixed dtypes (f32+f64 ->
                    # f64); copyto(casting="same_kind") into the
                    # sample-0 layout would instead silently DOWNCAST
                    # this sample — fall back to the generic
                    # collate+push path, which promotes like np.stack
                    return False
                # [j, ...] keeps a 0-d ndarray view for scalar fields
                # (plain [j] yields a numpy scalar copyto rejects)
                np.copyto(views[i][j, ...], src, casting="same_kind")
        # meta: pickle the slot-aliasing arrays out-of-band — the
        # buffer table then points at the bodies already in the slot
        bufs = []
        batch = tuple(views)
        meta = pickle.dumps(batch, protocol=5,
                            buffer_callback=bufs.append)
        n = len(bufs)
        header = 24 + n * 16
        if header + len(meta) > _ZC_HEADER_BYTES or n != k:
            return False  # generic path re-reserves the same slot
        struct.pack_into("<8sQQ", mv, 0, _ZC_MAGIC, len(meta), n)
        for i, (o, shape, dtype) in enumerate(layout):
            nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
            struct.pack_into("<QQ", mv, 24 + i * 16, o, nb)
        mv[header:header + len(meta)] = meta
    except (TypeError, ValueError):
        return False  # dtype/casting surprise: let collate+push handle
    finally:
        # drop every slot-aliasing export (arrays, PickleBuffers)
        # before releasing the memoryview — release() raises
        # BufferError while exports are alive
        views = batch = bufs = None
        mv.release()
    ring.commit(total)
    return True


def _decode_view(view):
    """Deserialize a zero-copy framed batch from a slot view, or None
    if the payload is not zero-copy framed (markers, plain pickles).
    The returned object's arrays alias `view`'s memory."""
    import struct

    if len(view) < 24 or bytes(view[:8]) != _ZC_MAGIC:
        return None
    _, meta_len, n = struct.unpack_from("<8sQQ", view, 0)
    header = 24 + n * 16
    table = [struct.unpack_from("<QQ", view, 24 + i * 16)
             for i in range(n)]
    meta = view[header:header + meta_len]
    bufs = [view[o:o + ln] for (o, ln) in table]
    return pickle.loads(meta, buffers=bufs)

_lib = None
_lib_lock = _sanitize.lock("io.shm_lib")


def _build_ring_lib():
    """Compile csrc/shm_ring.cc with g++ into _build/ (cached by the
    source's digest; a per-process temporary name published by
    os.replace, so concurrent first builds do not collide); returns the
    library's path."""
    digest = hashlib.sha256(_RING_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libshm_ring-{digest}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run(
        ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", str(_RING_SRC),
         "-o", tmp, "-lrt"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ build of shm_ring failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _ring_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_ring_lib()))
            lib.ring_open.restype = ctypes.c_void_p
            lib.ring_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint64, ctypes.c_int]
            lib.ring_push.restype = ctypes.c_int
            lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_int64]
            lib.ring_pop.restype = ctypes.c_int64
            lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_int64]
            lib.ring_push_reserve.restype = ctypes.c_void_p
            lib.ring_push_reserve.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64]
            lib.ring_push_commit.restype = ctypes.c_int
            lib.ring_push_commit.argtypes = [ctypes.c_void_p,
                                             ctypes.c_uint64]
            lib.ring_pop_view.restype = ctypes.c_void_p
            lib.ring_pop_view.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_uint64),
                                          ctypes.c_int64]
            lib.ring_pop_release.argtypes = [ctypes.c_void_p]
            lib.ring_close.argtypes = [ctypes.c_void_p]
            lib.ring_unlink.argtypes = [ctypes.c_char_p]
            _lib = lib
        return _lib


def ring_bytes(slots, slot_bytes):
    """Bytes of one ring's mapping (shm_ring.cc's total_bytes: a 64 B
    header, then each slot's 64 B length block and 64 B-rounded
    payload)."""
    return 64 + slots * (64 + ((slot_bytes + 63) & ~63))


def _check_shm_room(need):
    """Raise OSError when the shared-memory filesystem has less than
    `need` bytes free."""
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        return  # no /dev/shm to measure: shm_open reports for itself
    free = st.f_bavail * st.f_frsize
    if need > free:
        raise OSError(
            f"{_SHM_DIR} has {free} bytes free ({st.f_blocks * st.f_frsize}"
            f" in all); the DataLoader's shared-memory rings need {need} — "
            "lower num_workers / PADDLE_IO_WORKERS, prefetch_factor or "
            "FLAGS_dataloader_shm_slot_mb")


class ShmRing:
    """One SPSC ring in POSIX shared memory (ctypes over shm_ring.cc)."""

    def __init__(self, name, slots, slot_bytes, create):
        self._lib = _ring_lib()
        self.name = name.encode()
        self.slot_bytes = slot_bytes
        self._h = self._lib.ring_open(self.name, slots, slot_bytes,
                                      1 if create else 0)
        if not self._h:
            raise OSError(f"shm ring {name} open failed")
        self._creator = create
        self._pending = False
        # bind ctypes helpers: module globals are None'd during
        # interpreter shutdown while generator finalizers may still
        # drain rings
        self._c_uint64 = ctypes.c_uint64
        self._byref = ctypes.byref
        self._c_ubyte = ctypes.c_ubyte

    def push(self, data: bytes, timeout_ms=-1):
        rc = self._lib.ring_push(self._h, data, len(data), timeout_ms)
        if rc == -2:
            raise _slot_overflow(len(data), self.slot_bytes)
        return rc == 0

    # -- zero-copy API: batches serialize straight into the slot and
    # deserialize straight out of it; see _push_batch/_decode_view
    def reserve(self, timeout_ms=-1):
        """Writable memoryview over the next free slot's payload area
        (full slot_bytes), or None on timeout. Publish with commit()."""
        if not self._h:
            return None
        ptr = self._lib.ring_push_reserve(self._h, timeout_ms)
        if not ptr:
            return None
        arr = (self._c_ubyte * self.slot_bytes).from_address(ptr)
        return memoryview(arr).cast("B")

    def commit(self, length):
        rc = self._lib.ring_push_commit(self._h, length)
        if rc == -2:
            raise _slot_overflow(length, self.slot_bytes)

    def pop_view(self, timeout_ms=-1):
        """Memoryview of the tail slot's payload WITHOUT copying.
        Auto-releases any previous pending view first — so a view (and
        arrays deserialized out of it) is valid until the NEXT
        pop_view/release_view on this ring."""
        if not self._h:
            return None
        self.release_view()
        n = self._c_uint64()
        ptr = self._lib.ring_pop_view(self._h, self._byref(n),
                                      timeout_ms)
        if not ptr:
            return None
        self._pending = True
        arr = (self._c_ubyte * n.value).from_address(ptr)
        return memoryview(arr).cast("B")

    def release_view(self):
        if self._pending and self._h:
            self._lib.ring_pop_release(self._h)
            self._pending = False

    def close(self):
        if self._h:
            self._lib.ring_close(self._h)
            self._h = None
        if self._creator:
            self._lib.ring_unlink(self.name)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    """reference: paddle.io.get_worker_info (dataloader/worker.py)."""
    return _worker_info


def _fetch_samples(dataset, indices, worker_id, on_bad_sample):
    """Per-sample fetch with the chaos `io_fetch` site and the
    per-sample error policy: "raise" keeps today's fail-the-epoch
    behavior; "skip" drops the failing sample and reports (samples,
    n_skipped, last traceback) so the trainer can count it instead of
    killing the epoch on one corrupt record."""
    skip = on_bad_sample == "skip"
    out, skipped, err = [], 0, None
    for i in indices:
        try:
            if _chaos._armed:
                _chaos.hit("io_fetch", worker=worker_id)
            out.append(dataset[i])
        except (SystemExit, KeyboardInterrupt):
            raise
        except Exception as e:
            # tagged chaos exceptions are runtime-FAULT injection
            # (raise/enospc/resource_exhausted, a downgraded crash),
            # NOT bad records — the skip policy swallowing one would
            # make the chaos/* triggered counters claim faults with
            # no observable effect. ChaosBadSample IS the bad-record
            # simulation and stays skippable.
            if not skip or getattr(e, "_paddle_chaos_fault", False):
                raise
            skipped += 1
            import traceback

            err = traceback.format_exc()
    return out, skipped, err


def _seed_worker(seed):
    """A forked worker's first act: torch on one thread (the parent's
    OpenMP pool did not survive the fork), then numpy's global RNG and
    torch's CPU default generator from the worker's seed. The CUDA
    generators are left alone: a worker never touches CUDA."""
    import torch

    torch.set_num_threads(1)
    np.random.seed(seed % (2 ** 31))
    torch.default_generator.manual_seed(seed)


def _worker_loop(worker_id, num_workers, dataset, collate_fn, ring_name,
                 slots, slot_bytes, index_queue, worker_init_fn,
                 iterable_mode, batch_size, drop_last, base_seed,
                 default_collate=False, on_bad_sample="raise"):
    """Runs in the child process: pull work, compute, push to the ring."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset,
                              seed=base_seed + worker_id)
    _seed_worker(base_seed + worker_id)
    ring = ShmRing(ring_name, slots, slot_bytes, create=False)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if iterable_mode:
            # each worker consumes a strided shard of the iterable
            # (reference _IterableDatasetStopIteration contract); the
            # index queue carries per-epoch start markers so persistent
            # workers serve any number of epochs
            import itertools

            while True:
                item = index_queue.get()
                if item == "QUIT":
                    break
                try:
                    it = itertools.islice(iter(dataset), worker_id, None,
                                          num_workers)
                    if batch_size is None:
                        # batch_size=None: raw per-sample values, no
                        # collate (matches the single-process path)
                        for sample in it:
                            _push_batch(ring, sample)
                    else:
                        while True:
                            batch = list(itertools.islice(it, batch_size))
                            if not batch or (len(batch) < batch_size
                                             and drop_last):
                                break
                            _push_batch(ring, collate_fn(batch))
                except Exception as e:
                    import traceback

                    ring.push(_ERR + pickle.dumps(
                        (type(e).__name__, traceback.format_exc())))
                ring.push(_EOF)
            return
        # map mode. With PADDLE_IO_OVERLAP_DECODE=1 (default) a decode
        # thread fetches the NEXT index batch's samples while this
        # thread collates the current one into the ring (or blocks on
        # ring backpressure) — the queue keeps marker/batch order, so
        # EOF/QUIT handling and the fed-log restart contract are
        # unchanged. With overlap off, _next_work inlines the fetch.
        q_local = None
        if _overlap_decode_enabled():
            import queue as _qmod

            q_local = _qmod.Queue(maxsize=1)

            def _decode_loop():
                while True:
                    item = index_queue.get()
                    if item is None or item == "QUIT":
                        q_local.put((item, None))
                        if item == "QUIT":
                            return
                        continue
                    try:
                        q_local.put(("BATCH", _fetch_samples(
                            dataset, item, worker_id, on_bad_sample)))
                    except BaseException as e:
                        import traceback

                        q_local.put(("ERR", (type(e).__name__,
                                             traceback.format_exc())))

            threading.Thread(target=_decode_loop, daemon=True,
                             name="paddle-io-decode").start()

        def _next_work():
            if q_local is not None:
                return q_local.get()
            item = index_queue.get()
            if item is None or item == "QUIT":
                return item, None
            try:
                return "BATCH", _fetch_samples(dataset, item,
                                               worker_id, on_bad_sample)
            except BaseException as e:
                import traceback

                return "ERR", (type(e).__name__,
                               traceback.format_exc())

        while True:
            kind, payload = _next_work()
            if kind is None:
                ring.push(_EOF)
                # persistent workers loop for the next epoch's indices
                continue
            if kind == "QUIT":
                break
            if kind == "ERR":  # surface the fetch error to the trainer
                ring.push(_ERR + pickle.dumps(payload))
                continue
            samples, skipped, err = payload
            try:
                if skipped:
                    # skip-and-count: the trainer must still see ONE
                    # payload for this fed batch (ring order), so the
                    # partial batch (or None when every sample failed)
                    # rides a _SKP frame with the skip count
                    batch = collate_fn(samples) if samples else None
                    ring.push(_SKP + pickle.dumps(
                        (batch, skipped, err), protocol=5))
                # default collate + zero-copy: stack straight into the
                # slot (one copy per sample total)
                elif not (default_collate and _zero_copy_enabled()
                          and _try_push_stacked(ring, samples)):
                    _push_batch(ring, collate_fn(samples))
            except Exception as e:  # surface the error to the trainer
                import traceback

                ring.push(_ERR + pickle.dumps(
                    (type(e).__name__, traceback.format_exc())))
    finally:
        ring.close()


class MultiprocessLoader:
    """Trainer-side controller: W workers, W rings, ordered pops.

    SUPERVISED (map-style pipelines): a worker that dies (OOM-killed,
    chaos crash) or wedges past `wedge_timeout_s` is restarted up to
    `restarts` times EACH (per-worker budgets — one crashy worker
    can't starve the others') with a FRESH ring + index queue, and
    every index batch it was fed but the trainer has not yet popped
    is re-fed in
    order off the per-worker fed-log — global batch order is preserved
    by construction (pops still ride ring w for batch k == w mod W).
    Iterable-mode shards have no replayable cursor and keep the
    fail-fast raise. Counters: io/workers/{restarts,leaked},
    io/bad_samples; flight events io_worker_restart / io_bad_sample."""

    def __init__(self, dataset, collate_fn, num_workers, prefetch_factor,
                 slot_mb, worker_init_fn, timeout, persistent,
                 iterable_mode=False, batch_size=1, drop_last=False,
                 default_collate=False, on_bad_sample="raise",
                 restarts=2, wedge_timeout_s=0.0):
        import collections
        import multiprocessing as mp

        self._mp = mp.get_context("fork")
        self.num_workers = num_workers
        self.timeout_ms = int(timeout * 1000) if timeout else -1
        self.persistent = persistent
        self.iterable_mode = iterable_mode
        self._slot_bytes = slot_mb * 1024 * 1024
        slots = max(2, prefetch_factor)
        self._slots = slots
        self._busy = False
        self._base = f"/pdtpu_{os.getpid()}_{id(self)}"
        self.rings = []
        self.queues = []
        self.procs = []
        self._retired_rings = [[] for _ in range(num_workers)]
        _check_shm_room(num_workers * ring_bytes(slots, self._slot_bytes))
        base_seed = np.random.randint(0, 2 ** 31 - 1)
        # everything a respawn needs (the dataset/collate refs fork
        # cleanly). base_seed is REUSED, which restores the
        # predecessor's INITIAL np.random state — but the respawn
        # resumes mid-stream, so draw-dependent __getitem__ transforms
        # (augmentation) diverge from the fault-free run after a
        # restart: recovery trades that corner of bit-identity for a
        # finished epoch, and io_worker_restart events mark where
        self._spawn = dict(
            dataset=dataset, collate_fn=collate_fn,
            worker_init_fn=worker_init_fn, batch_size=batch_size,
            drop_last=drop_last, base_seed=base_seed,
            default_collate=default_collate,
            on_bad_sample=on_bad_sample)
        # PER-WORKER restart budgets: one crashy worker must not
        # starve the others' supervision (the docstring contract is
        # "restarted up to `restarts` times" per worker)
        self._restart_budget = [max(0, int(restarts))] * num_workers
        self._wedge_ms = int(max(0.0, float(wedge_timeout_s)) * 1000)
        self._ring_gen = [0] * num_workers
        # per-worker index batches fed but not yet popped (map mode) —
        # the refeed source on restart
        self._fed_log = [collections.deque()
                         for _ in range(num_workers)]
        self._done_feeding = False
        # per-worker: did THIS epoch's end-of-epoch EOF already pop?
        # (a restart must not replay the None marker then — the fresh
        # worker's second EOF would surface as a garbage "batch" at
        # the start of the NEXT persistent epoch)
        self._eof_seen = [False] * num_workers
        for w in range(num_workers):
            ring, q, p = self._spawn_worker(w)
            self.rings.append(ring)
            self.queues.append(q)
            self.procs.append(p)

    def _spawn_worker(self, w):
        """Fork one worker on a fresh ring + queue (initial spawn and
        restart share this path)."""
        gen = self._ring_gen[w]
        ring_name = (f"{self._base}_{w}" if gen == 0
                     else f"{self._base}_{w}g{gen}")
        ring = ShmRing(ring_name, self._slots, self._slot_bytes,
                       create=True)
        q = self._mp.Queue()
        s = self._spawn
        p = self._mp.Process(
            target=_worker_loop,
            args=(w, self.num_workers, s["dataset"], s["collate_fn"],
                  ring_name, self._slots, self._slot_bytes, q,
                  s["worker_init_fn"], self.iterable_mode,
                  s["batch_size"], s["drop_last"], s["base_seed"],
                  s["default_collate"], s["on_bad_sample"]),
            daemon=True)
        p.start()
        return ring, q, p

    @staticmethod
    def _reap(p, grace=2.0):
        """terminate -> kill escalation with bounded joins; returns
        False when the process survived everything (leaked). ONE copy
        shared by restart and shutdown so the escalation discipline
        can't drift between them."""
        try:
            if not p.is_alive():
                p.join(0.5)
                return True
            p.terminate()
            p.join(grace)
            if p.is_alive():
                p.kill()  # SIGKILL: wedged in C code / a chaos stall
                p.join(1.0)
        except Exception:
            pass
        return not p.is_alive()

    def _restart_worker(self, w, why):
        """Replace a dead/wedged worker: kill what's left of it, drop
        its ring (possibly holding a torn half-pushed batch), respawn
        on a fresh ring, and re-feed its outstanding index batches in
        their original order."""
        from ..core import monitor as _monitor
        from ..monitor import flight as _flight

        self._restart_budget[w] -= 1
        self._reap(self.procs[w])
        # release the dead worker's queue (feeder thread + pipe fds):
        # dropping the reference alone leaks them until GC, and a
        # queue with unflushed items can block interpreter exit on
        # the feeder join
        try:
            old_q = self.queues[w]
            old_q.cancel_join_thread()
            old_q.close()
        except Exception:
            pass
        # do NOT close (munmap) the old ring yet: the last batch this
        # worker delivered may be a zero-copy view still aliasing a
        # slot — by contract it stays valid until the worker's NEXT
        # pop, so the unmap is deferred to exactly that point (the
        # new ring uses a fresh shm name, so no collision)
        self._retired_rings[w].append(self.rings[w])
        self._ring_gen[w] += 1
        ring, q, proc = self._spawn_worker(w)
        self.rings[w] = ring
        self.queues[w] = q
        self.procs[w] = proc
        refed = list(self._fed_log[w])
        for idxs in refed:
            q.put(list(idxs))
        if self._done_feeding and not self._eof_seen[w]:
            q.put(None)  # replay the epoch-end marker too
        _monitor.stat_add("io/workers/restarts", 1)
        _flight.record("io_worker_restart", worker=w, why=why,
                       refed=len(refed),
                       restarts_left=self._restart_budget[w])

    def run_epoch(self, index_batches):
        """Feed indices round-robin with a bounded in-flight window;
        yield deserialized batches in order. Batch k is assigned to
        worker k % W and popped from ring k % W, so pops see each
        ring's batches exactly in global order and every ring ends the
        epoch with exactly one EOF marker. An early-exited epoch
        (break / generator close) is drained in the finally so
        persistent workers start the next epoch with clean rings."""
        if self._busy:
            raise RuntimeError(
                "this DataLoader's persistent workers are already "
                "serving an iterator — finish or close it before "
                "starting another")
        self._busy = True
        try:
            if self.iterable_mode:
                yield from self._run_iterable()
                return
            it = iter(index_batches)
            fed = popped = 0
            window = self.num_workers * self._slots
            self._done_feeding = False
            for d in self._fed_log:
                d.clear()
            self._eof_seen = [False] * self.num_workers

            def feed():
                nonlocal fed
                while not self._done_feeding and fed - popped < window:
                    try:
                        idxs = next(it)
                    except StopIteration:
                        self._done_feeding = True
                        for q in self.queues:
                            q.put(None)  # epoch end marker
                        return
                    w = fed % self.num_workers
                    idxs = list(idxs)
                    self.queues[w].put(idxs)
                    self._fed_log[w].append(idxs)
                    fed += 1

            feed()
            try:
                while popped < fed or not self._done_feeding:
                    batch = self._pop_checked(
                        popped % self.num_workers)
                    popped += 1
                    feed()
                    if batch is _SKIPPED:
                        continue  # every sample failed: drop, don't
                        # yield (on_bad_sample="skip")
                    yield batch
            finally:
                # early exit: flush remaining fed batches + all EOFs
                # (skip when _pop_checked already shut us down, and at
                # interpreter shutdown, where module globals the drain
                # needs are already torn down)
                if self.rings and not _sys.is_finalizing():
                    if not self._done_feeding:
                        self._done_feeding = True
                        for q in self.queues:
                            q.put(None)
                    while popped < fed:
                        self._pop_checked(popped % self.num_workers)
                        popped += 1
                    for w in range(self.num_workers):
                        self._pop_checked(w)  # EOF markers
        finally:
            self._busy = False

    def _run_iterable(self):
        for q in self.queues:
            q.put("EPOCH")  # wake (persistent) workers for this epoch
        live = set(range(self.num_workers))
        w = 0
        try:
            while live:
                if w not in live:
                    w = (w + 1) % self.num_workers
                    continue
                batch = self._pop_checked(w)
                if batch is _EOF:
                    live.discard(w)
                elif batch is not _SKIPPED:
                    yield batch
                w = (w + 1) % self.num_workers
        finally:
            # early exit: drain until every worker's EOF arrives
            # (skip when _pop_checked already shut us down, or at
            # interpreter shutdown)
            while live and self.rings and not _sys.is_finalizing():
                for w in list(live):
                    batch = self._pop_checked(w)
                    if batch is _EOF:
                        live.discard(w)

    def _can_restart(self, w):
        return not self.iterable_mode and self._restart_budget[w] > 0

    def _pop_checked(self, w):
        """Pop + decode worker `w`'s ring with liveness polling: a
        worker killed by the OS (or crashed outside the guarded
        region) is RESTARTED with its outstanding batches re-fed when
        the supervision budget allows (map mode), else raises — never
        hangs; a worker alive but silent past the wedge timeout
        (PADDLE_IO_WORKER_TIMEOUT_S) is treated the same way. Returns
        the decoded batch, the _EOF marker, or _SKIPPED (a fully
        failed batch under on_bad_sample="skip"). Zero-copy batches
        alias the ring slot; the slot is auto-released on the NEXT pop
        of the same ring (pop_view), so a yielded batch stays valid
        until that worker's next batch is fetched — W batches of slack
        in the round-robin order."""
        import time as _t

        from ..core import monitor as _monitor
        from ..monitor import flight as _flight

        tick = 2000
        if self._wedge_ms > 0:
            tick = max(50, min(tick, self._wedge_ms // 2))
        waited = 0        # total wait for THIS batch (user timeout)
        wedge_waited = 0  # silence since last progress/restart
        t0 = _t.perf_counter()
        while True:
            if not self.procs:
                raise RuntimeError("DataLoader was shut down while "
                                   "batches were still pending")
            budget = (self.timeout_ms if self.timeout_ms > 0
                      else tick)
            view = self.rings[w].pop_view(min(budget, tick))
            if view is not None:
                # this pop is the contract point where the worker's
                # PREVIOUS batch becomes invalid — a pre-restart ring
                # kept mapped for that batch can be unmapped now
                for r in self._retired_rings[w]:
                    try:
                        r.close()
                    except Exception:
                        pass
                self._retired_rings[w] = []
                break
            waited += tick
            wedge_waited += tick
            # the user's per-batch timeout is TOTAL wait including
            # any restarts — only the wedge timer resets on restart,
            # or DataLoader(timeout=) would silently stretch to
            # (restarts+1) x its bound
            if self.timeout_ms > 0 and waited >= self.timeout_ms:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader timed out after {self.timeout_ms} ms "
                    "waiting for a worker batch")
            dead = [i for i, p in enumerate(self.procs)
                    if not p.is_alive()]
            wedged = (self._wedge_ms > 0
                      and wedge_waited >= self._wedge_ms
                      and w not in dead)
            if dead and not self.iterable_mode \
                    and all(self._restart_budget[i] > 0 for i in dead):
                # restart every dead worker now (not just the one
                # being popped) — their outstanding batches re-feed
                # while this pop keeps waiting
                for i in dead:
                    self._restart_worker(i, why="died")
                wedge_waited = 0
                continue
            if wedged and self._can_restart(w):
                self._restart_worker(w, why="wedged")
                wedge_waited = 0
                continue
            if dead or wedged:
                self.shutdown()
                raise RuntimeError(
                    "a DataLoader worker process "
                    + ("died unexpectedly (killed or crashed)"
                       if dead else
                       "wedged past PADDLE_IO_WORKER_TIMEOUT_S")
                    + (" (iterable-mode pipelines are fail-fast by "
                       "design)" if self.iterable_mode else
                       " and its restart budget (worker_restarts) "
                       "is exhausted")
                    + " — see worker logs")
        # telemetry: ring-wait time (trainer blocked on workers) +
        # delivered payload bytes — io/ring_wait_us climbing while
        # step/time holds steady means the pipeline is input-bound
        _monitor.stat_add("io/ring_wait_us",
                          int((_t.perf_counter() - t0) * 1e6))
        _monitor.stat_add("io/ring_bytes", int(view.nbytes))
        batch = _decode_view(view)
        if batch is not None:
            self._note_popped(w)
            return batch
        payload = bytes(view)
        view.release()
        self.rings[w].release_view()
        if payload == _EOF:
            self._eof_seen[w] = True
            return _EOF
        if payload.startswith(_ERR):
            name, tb = pickle.loads(payload[len(_ERR):])
            self.shutdown()
            raise RuntimeError(
                f"DataLoader worker raised {name}:\n{tb}")
        if payload.startswith(_SKP):
            batch, nskip, err = pickle.loads(payload[len(_SKP):])
            note_bad_samples(nskip, err, worker=w)
            self._note_popped(w)
            return _SKIPPED if batch is None else batch
        self._note_popped(w)
        return pickle.loads(payload)

    def _note_popped(self, w):
        """One fed index batch of worker w was delivered — it leaves
        the restart refeed window."""
        if not self.iterable_mode and self._fed_log[w]:
            self._fed_log[w].popleft()

    def shutdown(self):
        """Tear the pool down with a BOUNDED grace window: QUIT, join,
        escalate terminate -> kill, and COUNT any worker that survives
        all of it under io/workers/leaked — teardown on an exception
        mid-epoch must neither hang the trainer nor silently rely on
        daemon reaping at interpreter exit."""
        for q in self.queues:
            try:
                q.put("QUIT")
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=2)
        leaked = sum(0 if self._reap(p, grace=1.0) else 1
                     for p in self.procs)
        if leaked:
            from ..core import monitor as _monitor
            from ..monitor import flight as _flight

            _monitor.stat_add("io/workers/leaked", leaked)
            _flight.record("io_worker_leak", n=leaked)
        for q in self.queues:
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass
        for r in self.rings:
            r.close()
        for rs in self._retired_rings:
            for r in rs:
                try:
                    r.close()
                except Exception:
                    pass
        self._retired_rings = [[] for _ in range(self.num_workers)]
        self.procs, self.queues, self.rings = [], [], []

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass
