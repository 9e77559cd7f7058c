"""paddle_tpu_torch.io — the data pipeline `hapi.Model.fit` drives, the
port of `paddle_tpu/io/__init__.py` and `io/worker.py`.

    ds = TensorDataset([ids])
    sampler = BatchSampler(ds, shuffle=True, batch_size=32, seed=11,
                           drop_last=True)
    loader = DataLoader(ds, batch_sampler=sampler)       # batches on the card
    loader = DataLoader(ds, batch_size=8, device="cpu")  # ... or on the CPU
    loader = DataLoader(ds, batch_size=8, num_workers=-1)  # forked workers

The datasets and samplers are the JAX package's, with its numpy logic
carried over line for line, so the same seed gives the same batch order
in both packages: `RandomSampler` and `random_split` draw from numpy's
global RNG, `BatchSampler(seed=s, shuffle=True)` shuffles epoch e with
`RandomState(s + e)`, `DistributedBatchSampler` shuffles with
`RandomState(epoch)`. A `BatchSampler` or `DistributedBatchSampler`
keeps an (epoch, consumed) cursor: `state_dict()` reads it and
`set_state_dict()` makes the next iteration replay that epoch's order
past the consumed batches, which is how a resumed fit fast-forwards.

`DataLoader` fetches in the calling process (`num_workers=0`), in
forked workers over shared-memory rings (`num_workers > 0`, `-1` =
auto; `io/worker.py`), or in a thread (`use_shared_memory=False`);
`prefetch_to_device` adds the device-feed stage. Each batch is
collated into torch tensors (`default_collate_fn`, or `collate_fn`;
the workers collate into numpy) and moved to `device` (None: the
card). The bad-sample policy (`on_bad_sample`) and the worker restart
budget (`worker_restarts`) are the JAX package's.

Telemetry (JAX :689-870, 939-1040): each map-style fetch passes the
`io_fetch` chaos site once per sample (in a worker too, with its id),
and each batch counts `io/batches`, in process `io/fetch_us` and the
`io/hist/fetch_us` histogram, and records an `io_fetch` flight event
(`transport="shm"` from the workers; the per-sample batch_size=None
path keeps the chaos site only). The device-feed stage counts
`io/h2d_us` and `io/device_prefetch/{depth,stalls,bytes}` and records
`io_h2d` and `io_device_prefetch`; the workers count
`io/workers/{restarts,leaked}`, `io/ring_wait_us`, `io/ring_bytes` and
`io/bad_samples` and record `io_worker_restart` and `io_bad_sample`.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import threading
import time
import warnings

import numpy as np
import torch

from ..core import monitor as _monitor
from ..device import resolve_device
from ..monitor import flight as _flight

# a batch whose every sample failed under on_bad_sample="skip":
# consumed, never yielded (the in-process analog of worker._SKIPPED)
_SKIPPED_BATCH = object()

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split", "BatchSampler", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "DistributedBatchSampler", "DataLoader", "get_worker_info",
    "default_collate_fn",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(n, float) for n in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * frac)) for frac in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    total = sum(lengths)
    perm = np.random.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Groups sampler indices into batches. Elastic-training hooks:

      * `seed` + shuffle=True makes the per-epoch shuffle deterministic
        (RandomState(seed + epoch)) and reshuffled each epoch, which a
        bit-identical resume needs; seed=None keeps the global-RNG
        shuffle.
      * `state_dict()` / `set_state_dict()` expose an (epoch, consumed)
        cursor; restoring fast-forwards the next iteration past the
        consumed batches. Note: a prefetching pipeline (worker pools,
        the device-feed stage, on by default on the card) fetches ahead
        of the train loop, so a cursor read from the sampler mid-epoch
        overcounts by the batches in flight: Model.fit's checkpoint
        records its own consumed-step cursor and restores through
        set_state_dict, which is exact.
    """

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, seed=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._consumed = 0  # batches served (or skipped) this epoch
        self._skip = 0      # fast-forward pending from set_state_dict
        # the seeded shuffle replaces only an internal RandomSampler: an
        # explicit sampler carries its own policy (weighted, subset, ...)
        self._auto_sampler = sampler is None
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def _index_order(self):
        if self.shuffle and self.seed is not None and self._auto_sampler:
            rng = np.random.RandomState(
                (int(self.seed) + self._epoch) % (2 ** 32))
            return iter(rng.permutation(len(self.sampler)).tolist())
        return iter(self.sampler)

    def __iter__(self):
        skip, self._skip = self._skip, 0
        self._consumed = 0
        n_batch = 0
        batch = []
        for idx in self._index_order():
            batch.append(idx)
            if len(batch) == self.batch_size:
                n_batch += 1
                self._consumed = n_batch
                if n_batch > skip:
                    yield batch
                batch = []
        if batch and not self.drop_last:
            n_batch += 1
            self._consumed = n_batch
            if n_batch > skip:
                yield batch
        # a fully consumed epoch advances the (seeded) shuffle; an
        # abandoned iterator leaves the epoch in place, so iterating
        # again replays the same order
        self._epoch += 1
        self._consumed = 0

    def set_epoch(self, epoch):
        self._epoch = int(epoch)
        self._consumed = 0
        self._skip = 0

    @property
    def _resume_deterministic(self):
        """Does replaying an epoch give the same index order? If not, a
        restored cursor skips batches of another permutation."""
        if self._auto_sampler:
            return (not self.shuffle) or self.seed is not None
        return isinstance(self.sampler, SequenceSampler)

    def state_dict(self):
        return {"epoch": self._epoch, "consumed": self._consumed,
                "seed": self.seed}

    def set_state_dict(self, state):
        self._epoch = int(state.get("epoch", 0))
        self._consumed = int(state.get("consumed", 0))
        self._skip = self._consumed
        if state.get("seed") is not None:
            self.seed = state["seed"]

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across ranks: rank r takes every nranks-th
    index from r of the (padded) epoch order, shuffled with
    RandomState(epoch)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_rank, get_world_size

        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else get_world_size())
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self._consumed = 0
        self._skip = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank:self.total_size:self.nranks]
        skip, self._skip = self._skip, 0
        self._consumed = 0
        n_batch = 0
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                n_batch += 1
                self._consumed = n_batch
                if n_batch > skip:
                    yield batch
                batch = []
        if batch and not self.drop_last:
            n_batch += 1
            self._consumed = n_batch
            if n_batch > skip:
                yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
        self._consumed = 0
        self._skip = 0

    @property
    def _resume_deterministic(self):
        return True  # the epoch number is the shuffle seed

    def state_dict(self):
        return {"epoch": self.epoch, "consumed": self._consumed}

    def set_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        self._consumed = int(state.get("consumed", 0))
        self._skip = self._consumed


def _as_tensor(x):
    """A CPU tensor of one collated leaf; float64 becomes float32, as
    the JAX package's `to_tensor` makes it."""
    t = torch.as_tensor(x)
    return t.float() if t.dtype == torch.float64 else t


def default_collate_fn(batch):
    """Stack a list of samples into batch tensors (on the CPU), leaf by
    leaf through tuples, lists and dicts."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return _as_tensor(torch.stack([torch.as_tensor(s) for s in batch]))
    if isinstance(sample, np.ndarray):
        return _as_tensor(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return _as_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def get_worker_info():
    """In a worker process, describes this worker (reference
    dataloader/worker.py WorkerInfo); None in the main process."""
    from .worker import get_worker_info as _gwi

    return _gwi()


def _np_collate(batch):
    """Collate into numpy (worker side: the worker never makes a torch
    tensor of its own, and the trainer turns the arrays into tensors).
    CPU torch tensors become numpy; a dtype numpy has no name for
    (bfloat16) stays a stacked torch tensor."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        try:
            return np.stack([s.numpy() for s in batch])
        except TypeError:
            return torch.stack(list(batch))
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return tuple(_np_collate(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    return batch


def _detach_views(obj):
    """Copy numpy arrays that don't own their data (shm-slot views) so
    the caller owns the batch outright. Exact tuple/list/dict recurse
    cheaply; any other container (namedtuple, dataclass, subclass)
    deep-copies — deepcopy preserves the type AND detaches every array
    view, matching the ownership the old pickle round-trip gave."""
    if isinstance(obj, np.ndarray):
        return obj.copy() if obj.base is not None else obj
    if type(obj) is tuple:
        return tuple(_detach_views(o) for o in obj)
    if type(obj) is list:
        return [_detach_views(o) for o in obj]
    if type(obj) is dict:
        return {k: _detach_views(v) for k, v in obj.items()}
    if isinstance(obj, (int, float, complex, str, bytes, bool,
                        type(None))):
        return obj
    import copy

    return copy.deepcopy(obj)


def _auto_num_workers():
    """Worker count for num_workers=-1/"auto": PADDLE_IO_WORKERS when
    set, else os.cpu_count() capped at 16 (beyond that the trainer-side
    ring pops and the single H2D stream are the bottleneck, and each
    worker pins a whole shm ring). The trainer thread doesn't get a
    reserved core — it mostly blocks in ring pops."""
    env = os.environ.get("PADDLE_IO_WORKERS")
    if env:
        try:
            # clamped to >= 1: auto-sizing always means SOME worker
            # pool (MultiprocessLoader's round-robin math divides by
            # it); to disable workers pass num_workers=0 explicitly
            return max(1, int(env))
        except ValueError:
            pass
    n = os.cpu_count() or 1
    return max(1, min(n, 16))


def _resolve_num_workers(n):
    if n in (-1, "auto"):
        return _auto_num_workers()
    return n


def _own_for_cpu(arr, dev):
    """A shm-ring slot view would alias the ring past slot reuse and
    munmap once `torch.as_tensor` wraps it for the CPU: detach views
    there. A copy to the card copies off the host anyway."""
    if arr.base is not None and dev.type == "cpu":
        return arr.copy()
    return arr


def _to_device(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, np.ndarray):
        return _as_tensor(_own_for_cpu(obj, dev)).to(dev)
    if isinstance(obj, tuple):
        return tuple(_to_device(o, dev) for o in obj)
    if isinstance(obj, list):
        return [_to_device(o, dev) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    return obj


def _host_nbytes(obj):
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_host_nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_host_nbytes(v) for v in obj.values())
    return 0


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)


class _PinnedStage:
    """The device-feed stage's copy to the card. Each host leaf is
    copied into a pinned buffer of its own — the copy that detaches it
    from its ring slot, made before the feeder's next ring pop — and
    then to the card with non_blocking=True on a stream of this stage's
    own, after which an event is recorded. The buffer is dropped at
    once: torch's pinned-memory allocator records the copy on it and
    hands the block out again only after that copy has ended. The
    stage's stream first waits on the feeder's current stream, so the
    event also covers leaves already on the card that the feeder made
    there. The consumer's stream waits on the event before the batch is
    used (`ready`), and each device tensor is recorded on the
    consumer's stream, so the allocator does not reuse its memory while
    the consumer still reads it. float64 leaves become float32 on the
    way, as `_as_tensor` makes them."""

    def __init__(self, dev):
        self.dev = dev
        self.stream = torch.cuda.Stream(dev)
        self._torch_dtype = {}   # numpy dtype -> torch dtype, or None

    def _stage(self, leaf):
        if isinstance(leaf, np.ndarray):
            dt = np.dtype(np.float32) if leaf.dtype == np.float64 \
                else leaf.dtype
            if dt not in self._torch_dtype:
                try:
                    self._torch_dtype[dt] = torch.from_numpy(
                        np.empty(0, dt)).dtype
                except TypeError:
                    self._torch_dtype[dt] = None
            dtype = self._torch_dtype[dt]
            if dtype is None or leaf.size == 0:
                return _to_device(leaf, self.dev)
            host = torch.empty(leaf.shape, dtype=dtype, pin_memory=True)
            np.copyto(host.numpy(), leaf, casting="same_kind")
        elif leaf.device.type == "cpu" and leaf.numel():
            dtype = torch.float32 if leaf.dtype == torch.float64 \
                else leaf.dtype
            host = torch.empty(leaf.shape, dtype=dtype, pin_memory=True)
            host.copy_(leaf)
        else:
            return _to_device(leaf, self.dev)
        return host.to(self.dev, non_blocking=True)

    def _place(self, obj):
        if isinstance(obj, (np.ndarray, torch.Tensor)):
            return self._stage(obj)
        if isinstance(obj, tuple):
            return tuple(self._place(o) for o in obj)
        if isinstance(obj, list):
            return [self._place(o) for o in obj]
        if isinstance(obj, dict):
            return {k: self._place(v) for k, v in obj.items()}
        return obj

    def __call__(self, batch):
        ev = torch.cuda.Event()
        self.stream.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.stream):
            try:
                out = self._place(batch)
            finally:
                ev.record(self.stream)
        return out, ev

    def ready(self, item):
        """The batch, usable on the consumer's current stream."""
        out, ev = item
        cur = torch.cuda.current_stream(self.dev)
        cur.wait_event(ev)
        for t in _leaves(out):
            if t.device.type == "cuda":
                t.record_stream(cur)
        return out


class DataLoader:
    """reference: fluid/reader.py:146 + dataloader_iter.py:326.

    Batches come from `batch_sampler` (else a `BatchSampler(dataset,
    shuffle, batch_size, drop_last)`; no sampler at batch_size=None:
    one sample at a time), are collated (`default_collate_fn`, or
    `collate_fn`) and moved to `device` (None: the card; "cpu" keeps
    them on the host), a custom `collate_fn`'s batches leaf by leaf
    too. `state_dict` / `set_state_dict` carry the batch sampler's
    cursor.

    num_workers>0 (or -1 / "auto"), use_shared_memory=True (default):
    forked worker processes fetch and collate batches into numpy and
    hand them to the trainer through C shared-memory SPSC rings
    (`csrc/shm_ring.cc`, the mmap_allocator.cc analog), batch k from
    worker k % W, so the order is the sampler's; supports
    worker_init_fn, timeout, and persistent_workers. With
    use_shared_memory=False, a thread prefetcher is used instead. When
    the rings cannot be made (no g++, /dev/shm too small) the loader
    warns (RuntimeWarning) and falls back to the thread prefetcher.

    prefetch_to_device=N adds a device-feed stage: a background thread
    copies each batch to `device` into a bounded N-deep buffer, so its
    copy rides under the previous step's compute instead of blocking
    the training thread (the BufferedReader double-buffer). On the card
    the copy goes through a pinned buffer on a stream of its own
    (`_PinnedStage`). Default: depth 2 when `device` is a CUDA
    device, 0 on the CPU; PADDLE_IO_DEVICE_PREFETCH=N overrides (0
    disables, N>0 forces depth N on any device), and the argument
    overrides both. The JAX package places a batch pre-sharded over a
    live single-process mesh's "dp" axis; the port has no
    single-process dp mesh, so placement is always the device's
    default. Observable via io/h2d_us and
    io/device_prefetch/{depth,stalls,bytes} counters and the io_h2d /
    io_device_prefetch flight events. The JAX package's
    `io/fetch_batch` and `io/shm_pop` profiler spans wait on the
    profiler (ROADMAP queue 1 item 4)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, prefetch_to_device=None,
                 on_bad_sample=None, worker_restarts=None, *, device=None):
        """on_bad_sample: per-sample error policy — "raise" (default)
        fails the epoch on the first bad record; "skip" drops the
        sample, counts it under io/bad_samples, and keeps the epoch
        alive (a fully-failed batch is dropped whole). Map-style
        datasets only: an IterableDataset has no per-sample fetch to
        retry around, so iterable pipelines keep fail-fast and "skip"
        warns. Default from PADDLE_IO_ON_BAD_SAMPLE.

        worker_restarts: how many times EACH worker may be restarted
        after dying or wedging (fresh shm ring, outstanding batches
        re-fed in order) before the epoch fails. Default
        PADDLE_IO_WORKER_RESTARTS (2). A worker that is alive but
        silent past PADDLE_IO_WORKER_TIMEOUT_S seconds counts as
        wedged (0 = never, the default).

        num_workers=-1 (or "auto") sizes the worker pool from the
        host: PADDLE_IO_WORKERS when set, else os.cpu_count() capped
        at 16."""
        self.device = resolve_device(device)
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn
        self.num_workers = _resolve_num_workers(num_workers) or 0
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self.prefetch_to_device = prefetch_to_device
        if on_bad_sample not in (None, "raise", "skip"):
            raise ValueError(
                f"DataLoader: on_bad_sample={on_bad_sample!r} "
                "(expected 'raise' or 'skip')")
        self.on_bad_sample = on_bad_sample
        self.worker_restarts = worker_restarts
        self._pf_orphans = []  # feeder threads outliving their epoch
        self._mp_loader = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode and self._bad_sample_policy() == "skip":
            warnings.warn(
                "DataLoader: on_bad_sample='skip' has no effect on an "
                "IterableDataset (no per-sample fetch to retry "
                "around) — errors still fail the epoch",
                RuntimeWarning)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif not self._iterable_mode:
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last) if batch_size is not None else None
        else:
            self.batch_size = batch_size
            self.batch_sampler = None
        self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    # -- elastic resume ----------------------------------------------
    def state_dict(self):
        """The batch sampler's (epoch, consumed) cursor. An
        IterableDataset pipeline has no replayable cursor and raises."""
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "state_dict"):
            raise TypeError(
                "DataLoader.state_dict() needs a batch_sampler with state "
                "(IterableDataset pipelines are not resumable)")
        return {"batch_sampler": bs.state_dict()}

    def set_state_dict(self, state):
        """Restore the cursor: the next iteration replays the saved
        epoch's (seeded) order past the consumed batches."""
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "set_state_dict"):
            raise TypeError(
                "DataLoader.set_state_dict() needs a batch_sampler with "
                "state")
        bs.set_state_dict(state.get("batch_sampler", state))

    # -- fault policy (shared by the worker and in-process pipelines) -
    def _bad_sample_policy(self):
        v = self.on_bad_sample
        if v is None:
            v = os.environ.get("PADDLE_IO_ON_BAD_SAMPLE") or "raise"
            if str(v).lower() not in ("raise", "skip"):
                # the ctor kwarg validates loudly — the env leg must
                # not silently turn a typo ('drop', 'sip') into
                # fail-fast, which is the exact incident the knob
                # exists to prevent (warnings dedup per call site)
                warnings.warn(
                    f"PADDLE_IO_ON_BAD_SAMPLE={v!r} is not "
                    "'raise'|'skip' — falling back to 'raise'",
                    RuntimeWarning)
        return "skip" if str(v).lower() == "skip" else "raise"

    def _worker_restart_budget(self):
        n = self.worker_restarts
        if n is None:
            n = _flight._env_int("PADDLE_IO_WORKER_RESTARTS", 2)
        return max(0, int(n))

    def _collate(self, samples):
        return (self.collate_fn or default_collate_fn)(samples)

    def _fetch(self, indices, to_device=True, telemetry=True,
               policy=None):
        """The batch at `indices`, fetched in this thread: each sample
        through the `io_fetch` chaos site (worker None) and the
        bad-sample policy, then collated and (to_device) moved.
        telemetry=False (the batch_size=None per-sample path) keeps the
        policy and the chaos site but skips the counters and the flight
        event, which a million-sample pass would flood."""
        from .worker import _fetch_samples, note_bad_samples

        t0 = time.perf_counter()
        samples, skipped, err = _fetch_samples(
            self.dataset, indices, None,
            policy or self._bad_sample_policy())
        if skipped:
            note_bad_samples(skipped, err)
            if not samples:
                return _SKIPPED_BATCH
        batch = self._collate(samples)
        if to_device:
            batch = _to_device(batch, self.device)
        if telemetry:
            us = int((time.perf_counter() - t0) * 1e6)
            _monitor.stat_add("io/batches", 1)
            _monitor.stat_add("io/fetch_us", us)
            _monitor.hist_observe("io/hist/fetch_us", us)
            _flight.record("io_fetch", n=len(indices), us=us)
        return batch

    def _iter_batches(self, to_device=True):
        # to_device=False yields HOST batches — the device-feed stage
        # owns placement then
        dev = ((lambda b: _to_device(b, self.device)) if to_device
               else (lambda b: b))
        if self._iterable_mode:
            it = iter(self.dataset)
            if self.batch_size is None:
                for sample in it:
                    yield dev(sample)
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield dev(self._collate(batch))
        elif self.batch_sampler is None:
            pol = self._bad_sample_policy()  # once, not per sample
            for i in range(len(self.dataset)):
                batch = self._fetch([i], to_device=to_device,
                                    telemetry=False, policy=pol)
                if batch is not _SKIPPED_BATCH:
                    yield batch
        else:
            pol = self._bad_sample_policy()  # once, not per batch
            for indices in self.batch_sampler:
                batch = self._fetch(indices, to_device=to_device,
                                    policy=pol)
                if batch is not _SKIPPED_BATCH:
                    yield batch  # every sample failed under "skip"

    def _multiprocess_iter(self, to_device=True):
        """Batches from the worker pool. to_device=True moves each one
        to `device` before the next ring pop (a CPU batch is copied out
        of its slot); to_device=False yields the slot views themselves,
        for the device-feed stage, which copies each out before it pops
        the next."""
        from .worker import MultiprocessLoader, _zero_copy_enabled

        def make_loader():
            slot_mb = int(os.environ.get("FLAGS_dataloader_shm_slot_mb",
                                         "64"))
            return MultiprocessLoader(
                self.dataset, self.collate_fn or _np_collate,
                self.num_workers, max(2, self.prefetch_factor),
                slot_mb, self.worker_init_fn, self.timeout,
                self.persistent_workers,
                iterable_mode=self._iterable_mode,
                batch_size=self.batch_size,
                drop_last=self.drop_last,
                default_collate=self.collate_fn is None,
                on_bad_sample=self._bad_sample_policy(),
                restarts=self._worker_restart_budget(),
                wedge_timeout_s=_flight._env_float(
                    "PADDLE_IO_WORKER_TIMEOUT_S", 0.0))

        try:
            if self.persistent_workers:
                # one long-lived worker pool; run_epoch serializes
                # epochs (a second concurrent iterator raises). A pool
                # torn down by a worker error/timeout is rebuilt.
                if self._mp_loader is None or not self._mp_loader.procs:
                    self._mp_loader = make_loader()
                loader, owned = self._mp_loader, False
            else:
                # each iterator owns an independent pool — concurrent
                # iterators (zip(dl, dl)) cannot corrupt each other
                loader, owned = make_loader(), True
        except (RuntimeError, OSError, FileNotFoundError) as e:
            # shared-memory transport unavailable (no g++, /dev/shm
            # too small): fall back to the threaded prefetcher
            warnings.warn(
                f"multiprocess DataLoader unavailable ({e}); falling "
                "back to thread prefetching — pass "
                "use_shared_memory=False to silence", RuntimeWarning)
            yield from self._threaded_iter(to_device=to_device)
            return

        if self.batch_sampler is not None:
            batches = iter(self.batch_sampler)
        elif not self._iterable_mode:
            # batch_size=None: one sample per index (matches the
            # single-process path)
            batches = ([i] for i in range(len(self.dataset)))
        else:
            batches = []
        # a custom collate's batch may hold slot views in any container:
        # detach them (zero-copy transport only: pickled batches own
        # their bytes)
        raw = self.collate_fn is not None and _zero_copy_enabled()
        try:
            gen = loader.run_epoch(batches)
            while True:
                try:
                    batch = next(gen)
                except StopIteration:
                    break
                _monitor.stat_add("io/batches", 1)
                _flight.record("io_fetch", transport="shm")
                # a zero-copy batch aliases its ring slot, valid only
                # until that worker's next batch is popped
                if raw:
                    batch = _detach_views(batch)
                yield _to_device(batch, self.device) if to_device \
                    else batch
        finally:
            if owned:
                loader.shutdown()

    def _threaded_iter(self, to_device=True):
        # threaded prefetch: a producer thread fetches batches
        q = queue.Queue(maxsize=max(1, self.num_workers *
                                    self.prefetch_factor))
        sentinel = object()
        failure = []

        def producer():
            try:
                for b in self._iter_batches(to_device=to_device):
                    q.put(b)
            except BaseException as e:  # surfaced on the consumer side
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                break
            yield item

    def _device_prefetch_depth(self):
        """Resolved depth of the device-feed stage (0 = off).
        Precedence: constructor arg > PADDLE_IO_DEVICE_PREFETCH env >
        auto (2 on a CUDA device, 0 on the CPU)."""
        n = self.prefetch_to_device
        if n is None:
            env = os.environ.get("PADDLE_IO_DEVICE_PREFETCH")
            if env:
                try:
                    n = int(env)
                except ValueError:
                    n = None
        if n is None:
            n = 2 if self.device.type == "cuda" else 0
        return max(0, int(n))

    # bound (seconds) on waiting for the feeder thread when the
    # consumer abandons a prefetching iterator; a feeder mid-fetch
    # that outlives it is parked in _pf_orphans and reaped before the
    # next epoch starts (persistent worker pools can't serve two
    # epochs at once)
    _PF_REAP_S = 2.0

    def _reap_orphan_feeders(self):
        """Join feeder threads abandoned by earlier epochs. Only a
        PERSISTENT shm worker pool makes the wait semantically
        required: its run_epoch busy-flag is held until the orphan's
        in-flight fetch completes and its drain runs, and starting the
        next epoch before that raises 'already serving an iterator'.
        Everything else (thread/single-process pipelines, owned pools)
        has no exclusivity at stake — just prune finished daemons
        without blocking the training thread."""
        if not self._pf_orphans:
            return
        must_wait = (self.persistent_workers and self.num_workers > 0
                     and self.use_shared_memory)
        deadline = time.monotonic() + (30.0 if must_wait else 0.0)
        alive = []
        for t in self._pf_orphans:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                alive.append(t)
        self._pf_orphans = alive

    def _device_prefetch_iter(self, depth):
        """Device-feed stage: a background thread pulls HOST batches
        from the underlying pipeline, copies each to `device` (on the
        card through `_PinnedStage`), and parks it in a bounded buffer
        — the copy of batch i+1..i+depth rides under the consumer's
        compute on batch i. Batch order is the single FIFO queue's
        order (never reordered, never dropped); abandoning the iterator
        mid-epoch (break/GC) stops the feeder thread and closes the
        inner pipeline."""
        if self.num_workers > 0 and self.use_shared_memory:
            inner = self._multiprocess_iter(to_device=False)
        else:
            # the feed thread already backgrounds the fetch; a second
            # producer thread (_threaded_iter) would buy nothing
            inner = self._iter_batches(to_device=False)
        if self.device.type == "cuda":
            stage = _PinnedStage(self.device)
            place, ready = stage, stage.ready
        else:
            place = (lambda b: _to_device(b, self.device))
            ready = (lambda b: b)
        q = queue.Queue(maxsize=max(1, depth))
        stop = threading.Event()
        sentinel = object()
        failure = []

        def feeder():
            try:
                for b in inner:
                    nb = _host_nbytes(b)
                    t0 = time.perf_counter()
                    d = place(b)
                    us = int((time.perf_counter() - t0) * 1e6)
                    _monitor.stat_add("io/h2d_us", us)
                    _monitor.stat_add("io/device_prefetch/bytes", nb)
                    _flight.record("io_h2d", us=us, bytes=nb)
                    while not stop.is_set():
                        try:
                            q.put(d, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                failure.append(e)
            finally:
                try:
                    inner.close()
                except Exception:
                    pass
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=feeder, daemon=True,
                             name="paddle-io-device-feed")
        _flight.record("io_device_prefetch", phase="start", depth=depth)
        t.start()
        try:
            first = True
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    # the consumer outran the feeder — each stall is a
                    # step that WAITED on input (the signal the depth
                    # knob is tuned against). The first get of an
                    # epoch always finds an empty queue (the feeder
                    # just started) — counting it would give the
                    # signal a floor of one stall per epoch that no
                    # depth could tune away.
                    if not first:
                        _monitor.stat_add("io/device_prefetch/stalls",
                                          1)
                    item = q.get()
                first = False
                _monitor.stat_set("io/device_prefetch/depth", q.qsize())
                if item is sentinel:
                    if failure:
                        raise failure[0]
                    return
                yield ready(item)
        finally:
            stop.set()
            # unblock a feeder parked on q.put, then reap it — with a
            # BOUND: a feeder mid-fetch (slow __getitem__, blocked
            # stream) can't observe stop until its item completes, and
            # abandoning an iterator must not hang the main thread on
            # it (the daemon thread exits at its next stop check). A
            # survivor is parked for _reap_orphan_feeders: the next
            # epoch must wait for it before reusing persistent pools.
            deadline = time.monotonic() + self._PF_REAP_S
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
            if t.is_alive():
                self._pf_orphans.append(t)
            _flight.record("io_device_prefetch", phase="stop",
                           reaped=not t.is_alive())

    def __iter__(self):
        self._reap_orphan_feeders()
        depth = self._device_prefetch_depth()
        if depth > 0:
            yield from self._device_prefetch_iter(depth)
            return
        if self.num_workers <= 0:
            yield from self._iter_batches()
            return
        if self.use_shared_memory:
            yield from self._multiprocess_iter()
            return
        yield from self._threaded_iter()
