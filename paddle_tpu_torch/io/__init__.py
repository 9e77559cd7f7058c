"""paddle_tpu_torch.io — the data pipeline `hapi.Model.fit` drives, the
port of `paddle_tpu/io/__init__.py` (:42-370, 548-680).

    ds = TensorDataset([ids])
    sampler = BatchSampler(ds, shuffle=True, batch_size=32, seed=11,
                           drop_last=True)
    loader = DataLoader(ds, batch_sampler=sampler)       # batches on the card
    loader = DataLoader(ds, batch_size=8, device="cpu")  # ... or on the CPU

The datasets and samplers are the JAX package's, with its numpy logic
carried over line for line, so the same seed gives the same batch order
in both packages: `RandomSampler` and `random_split` draw from numpy's
global RNG, `BatchSampler(seed=s, shuffle=True)` shuffles epoch e with
`RandomState(s + e)`, `DistributedBatchSampler` shuffles with
`RandomState(epoch)`. A `BatchSampler` or `DistributedBatchSampler`
keeps an (epoch, consumed) cursor: `state_dict()` reads it and
`set_state_dict()` makes the next iteration replay that epoch's order
past the consumed batches, which is how a resumed fit fast-forwards.

`DataLoader` runs in the calling process (`num_workers=0`): each batch
is fetched, collated by `default_collate_fn` (or `collate_fn`) into
torch tensors and moved to `device` (None: the card). The JAX
package's worker pool (`io/worker.py`, its shared-memory rings), its
threaded and device prefetchers and the bad-sample policy are not
ported: `num_workers > 0` raises NotImplementedError.

Telemetry (JAX :689-726): each map-style fetch passes the `io_fetch`
chaos site once per sample, and each batch counts `io/batches`,
`io/fetch_us` and the `io/hist/fetch_us` histogram and records an
`io_fetch` flight event (the per-sample batch_size=None path keeps the
chaos site only).
"""
from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from ..core import monitor as _monitor
from ..device import resolve_device
from ..monitor import chaos as _chaos
from ..monitor import flight as _flight

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split", "BatchSampler", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "DistributedBatchSampler", "DataLoader", "default_collate_fn",
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
        consumed batches.
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


def _to_device(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, np.ndarray):
        return _as_tensor(obj).to(dev)
    if isinstance(obj, tuple):
        return tuple(_to_device(o, dev) for o in obj)
    if isinstance(obj, list):
        return [_to_device(o, dev) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    return obj


class DataLoader:
    """reference: fluid/reader.py:146. Batches come from `batch_sampler`
    (else a `BatchSampler(dataset, shuffle, batch_size, drop_last)`; no
    sampler at batch_size=None: one sample at a time), are collated in
    this process and moved to `device` (None: the card; "cpu" keeps
    them on the host). A custom `collate_fn`'s batches are moved too,
    leaf by leaf. `state_dict` / `set_state_dict` carry the batch
    sampler's cursor."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, *, device=None):
        if num_workers not in (0, None):
            raise NotImplementedError(
                f"DataLoader(num_workers={num_workers!r}): the worker pool "
                "(io/worker.py, its shared-memory rings) is not ported "
                "(ROADMAP queue 1 item 5); use num_workers=0")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn
        self.num_workers = 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
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

    def _collate(self, samples):
        return (self.collate_fn or default_collate_fn)(samples)

    def __iter__(self):
        dev = self.device
        if self._iterable_mode:
            it = iter(self.dataset)
            if self.batch_size is None:
                for sample in it:
                    yield _to_device(sample, dev)
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield _to_device(self._collate(batch), dev)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield _to_device(self._collate(self._fetch([i])), dev)
        else:
            for indices in self.batch_sampler:
                t0 = time.perf_counter()
                batch = _to_device(self._collate(self._fetch(indices)), dev)
                us = int((time.perf_counter() - t0) * 1e6)
                _monitor.stat_add("io/batches", 1)
                _monitor.stat_add("io/fetch_us", us)
                _monitor.hist_observe("io/hist/fetch_us", us)
                _flight.record("io_fetch", n=len(indices), us=us)
                yield batch

    def _fetch(self, indices):
        """The samples at `indices`, each through the `io_fetch` chaos
        site (the in-process loader: worker None)."""
        out = []
        for i in indices:
            if _chaos._armed:
                _chaos.hit("io_fetch", worker=None)
            out.append(self.dataset[i])
        return out
