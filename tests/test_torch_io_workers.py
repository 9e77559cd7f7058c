"""The port's DataLoader worker pool (`paddle_tpu_torch.io.worker`: forked
workers over shared-memory rings, the restart and bad-sample policy, the
device-feed stage) held against the JAX package's, on the CPU.

The same numpy datasets go through `paddle_tpu.io.DataLoader` and
`paddle_tpu_torch.io.DataLoader(device="cpu")` in this one process, and
the batches must be equal element for element and in order (no
tolerance): the cases of `tests/test_dataloader_mp.py`, the policy cases
of `tests/test_chaos.py` (with equal `io/bad_samples` and
`io/workers/restarts` counts), the device-prefetch cases of
`tests/test_pipeline_dispatch.py` (forced on with `prefetch_to_device`),
`_auto_num_workers`' clamping, and a ring written by one package's
`ShmRing` and read by the other's. Integer batches are compared by value:
the JAX package gives int32 where the port keeps int64.
"""
import multiprocessing as mp
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.core import monitor as jcmon
from paddle_tpu.io import worker as jworker
from paddle_tpu.monitor import chaos as jchaos
from paddle_tpu.monitor import flight as jflight

import paddle_tpu_torch.io as pio
from paddle_tpu_torch.core import monitor as pcmon
from paddle_tpu_torch.io import worker as pworker
from paddle_tpu_torch.monitor import chaos as pchaos
from paddle_tpu_torch.monitor import flight as pflight

PKGS = {"jax": (jio, jcmon, jchaos, jflight),
        "port": (pio, pcmon, pchaos, pflight)}


def _loader(pkg, ds, **kw):
    io = PKGS[pkg][0]
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return io.DataLoader(ds, **kw)


def _np(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if hasattr(obj, "_value"):
        return np.asarray(obj._value)
    if isinstance(obj, (tuple, list)):
        return tuple(_np(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    return np.asarray(obj)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    else:
        assert got.shape == want.shape
        if want.dtype == np.float32:
            assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _epoch(loader):
    return [_np(b) for b in loader]


def _both(ds_fn, **kw):
    """(port batches, JAX batches) of one epoch of `ds_fn()`."""
    return _epoch(_loader("port", ds_fn(), **kw)), \
        _epoch(_loader("jax", ds_fn(), **kw))


def _same_epochs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _wait_for(pred, timeout=10.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


class SquareDataset:
    def __init__(self, n=64):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((4,), i, np.float32),
                np.array([i % 7], np.int64))


class ArangeDS:
    """Deterministic (x, idx) pairs; optional bad indices."""

    def __init__(self, n, bad=()):
        self.n, self.bad = n, set(bad)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.bad:
            raise ValueError(f"corrupt record {i}")
        return np.full((3,), i, np.float32), np.int64(i)


class SeqDataset:
    """Batch i is full of the value i."""

    def __init__(self, n=17):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((4, 3), i, np.float32), np.int64(i)


class NestedDataset:
    """dict / list samples with float64 leaves (float32 after collation
    in both packages)."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return {"a": np.float64(i) / 3, "b": np.arange(3) + i,
                "c": [np.full((2,), i, np.float32), i]}


def _stream(pkg, n=20, width=2):
    io = PKGS[pkg][0]

    class Stream(io.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield np.full((width,), i, np.float32)

    return Stream()


# -- batches: the cases of tests/test_dataloader_mp.py ------------------

MAP_CASES = {
    "workers3": (lambda: SquareDataset(64), dict(batch_size=8,
                                                 num_workers=3)),
    "workers2_tail": (lambda: SquareDataset(40), dict(batch_size=6,
                                                      num_workers=2)),
    "drop_last": (lambda: SquareDataset(40), dict(batch_size=6,
                                                  num_workers=2,
                                                  drop_last=True)),
    "batch_size_none": (lambda: SquareDataset(6), dict(batch_size=None,
                                                       num_workers=2)),
    "nested": (NestedDataset, dict(batch_size=4, num_workers=2)),
    "threaded": (lambda: SquareDataset(24), dict(batch_size=4,
                                                 num_workers=2,
                                                 use_shared_memory=False)),
    "prefetch_factor4": (lambda: SquareDataset(40),
                         dict(batch_size=4, num_workers=2,
                              prefetch_factor=4)),
    "prefetch_to_device": (lambda: SeqDataset(16),
                           dict(batch_size=2, num_workers=2,
                                prefetch_to_device=2)),
    "auto_workers": (lambda: SquareDataset(24), dict(batch_size=4,
                                                     num_workers=-1)),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_map_batches_match_jax(case, monkeypatch):
    monkeypatch.setenv("PADDLE_IO_WORKERS", "3")
    ds_fn, kw = MAP_CASES[case]
    got, want = _both(ds_fn, **kw)
    _same_epochs(got, want)
    single = _epoch(_loader("port", ds_fn(), **dict(kw, num_workers=0)))
    _same_epochs(got, single)


@pytest.mark.parametrize("knob", ["FLAGS_dataloader_zero_copy",
                                  "PADDLE_IO_OVERLAP_DECODE"])
def test_transport_knobs_off_match_jax(knob, monkeypatch):
    monkeypatch.setenv(knob, "0")
    got, want = _both(lambda: SquareDataset(24), batch_size=4,
                      num_workers=2)
    _same_epochs(got, want)


def test_shuffled_sampler_order_matches_jax():
    def run(pkg):
        io = PKGS[pkg][0]
        ds = SquareDataset(48)
        bs = io.BatchSampler(ds, shuffle=True, batch_size=8, seed=3)
        dl = _loader(pkg, ds, batch_sampler=bs, num_workers=3)
        return [_epoch(dl) for _ in range(2)]

    got, want = run("port"), run("jax")
    for g, w in zip(got, want):
        _same_epochs(g, w)
    assert not np.array_equal(got[0][0][0], got[1][0][0])


def test_persistent_workers_two_epochs_and_early_break():
    out = {}
    for pkg in PKGS:
        dl = _loader(pkg, SquareDataset(32), batch_size=4, num_workers=2,
                     persistent_workers=True)
        try:
            it = iter(dl)
            first = _np(next(it))
            it.close()  # early exit: the rings are drained
            out[pkg] = [first] + [b for _ in range(2) for b in _epoch(dl)]
        finally:
            dl._mp_loader.shutdown()
    _same_epochs(out["port"], out["jax"])
    assert len(out["port"]) == 17


def test_concurrent_iterators_nonpersistent():
    out = {}
    for pkg in PKGS:
        dl = _loader(pkg, SquareDataset(16), batch_size=4, num_workers=2)
        out[pkg] = [(_np(a), _np(b)) for a, b in zip(dl, dl)]
    assert len(out["port"]) == 4
    for (a, b), (ja, _) in zip(out["port"], out["jax"]):
        _same(a, b)
        _same(a, ja)


def test_iterable_batches_match_jax():
    for kw in (dict(batch_size=4, drop_last=True), dict(batch_size=3),
               dict(batch_size=None)):
        got = _epoch(_loader("port", _stream("port"), num_workers=2, **kw))
        want = _epoch(_loader("jax", _stream("jax"), num_workers=2, **kw))
        assert len(got) == len(want) > 0
        _same_epochs(got, want)


def test_iterable_persistent_two_epochs():
    counts = {}
    for pkg in PKGS:
        dl = _loader(pkg, _stream(pkg, 8), batch_size=2, num_workers=2,
                     persistent_workers=True)
        try:
            counts[pkg] = [len(_epoch(dl)) for _ in range(2)]
        finally:
            dl._mp_loader.shutdown()
    assert counts["port"] == counts["jax"] == [4, 4]


def test_worker_init_fn_runs_in_each_child(tmp_path):
    for pkg in PKGS:
        marker = tmp_path / pkg
        marker.mkdir()

        def init_fn(worker_id, d=str(marker)):
            open(os.path.join(d, f"worker_{worker_id}.ran"), "w").close()

        dl = _loader(pkg, SquareDataset(16), batch_size=4, num_workers=2,
                     worker_init_fn=init_fn)
        assert len(_epoch(dl)) == 4
        assert sorted(os.listdir(marker)) == ["worker_0.ran",
                                              "worker_1.ran"]


class BadAt5:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros((2,), np.float32)


def test_worker_exception_propagates_as_jax():
    msgs = {}
    for pkg in PKGS:
        dl = _loader(pkg, BadAt5(), batch_size=2, num_workers=2)
        with pytest.raises(RuntimeError, match="boom at 5") as e:
            _epoch(dl)
        msgs[pkg] = str(e.value).splitlines()[0]
    assert msgs["port"] == msgs["jax"] == \
        "DataLoader worker raised ValueError:"


class FlakyDataset:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if os.environ.get("PD_FLAKY_FAIL") == "1" and i == 3:
            raise ValueError("flaky")
        return np.zeros((2,), np.float32)


def test_persistent_pool_rebuilt_after_error(monkeypatch):
    for pkg in PKGS:
        dl = _loader(pkg, FlakyDataset(), batch_size=2, num_workers=2,
                     persistent_workers=True)
        monkeypatch.setenv("PD_FLAKY_FAIL", "1")
        with pytest.raises(RuntimeError, match="flaky"):
            _epoch(dl)
        monkeypatch.setenv("PD_FLAKY_FAIL", "0")
        try:
            assert len(_epoch(dl)) == 4   # pool rebuilt, clean epoch
        finally:
            dl._mp_loader.shutdown()


class ProbeDataset:
    def __init__(self, pkg):
        self.pkg = pkg

    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = PKGS[self.pkg][0].get_worker_info()
        assert info is not None and info.num_workers == 2
        return np.array([info.id, info.seed - info.id], np.int64)


def test_get_worker_info_in_child():
    out = {}
    for pkg in PKGS:
        dl = _loader(pkg, ProbeDataset(pkg), batch_size=4, num_workers=2)
        out[pkg] = [_np(b) for b in dl]
        assert PKGS[pkg][0].get_worker_info() is None   # main process
    # batch k comes from worker k % 2, whose seed is base_seed + id
    for pkg, batches in out.items():
        assert [int(b[0, 0]) for b in batches] == [0, 1], pkg
        assert len({int(v) for b in batches for v in b[:, 1]}) == 1
    assert "get_worker_info" in pio.__all__


def _worker_seeds(_):
    return (np.random.randint(0, 2 ** 31),
            int(torch.randint(0, 2 ** 31, (1,))),
            torch.get_num_threads())


class SeedProbe:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.array(_worker_seeds(i), np.int64)


def test_worker_seeds_numpy_and_torch_and_runs_one_thread():
    """Each worker seeds numpy's global RNG (as JAX's do) and torch's
    CPU default generator with base_seed + id, and runs torch on one
    thread."""
    np.random.seed(11)
    a = _epoch(_loader("port", SeedProbe(), batch_size=2, num_workers=2))
    np.random.seed(11)
    b = _epoch(_loader("port", SeedProbe(), batch_size=2, num_workers=2))
    np.random.seed(11)
    j = _epoch(_loader("jax", SeedProbe(), batch_size=2, num_workers=2))
    _same_epochs(a, b)
    # the numpy draws are JAX's (same base seed from the same global RNG)
    for got, want in zip(a, j):
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert all(int(v) == 1 for batch in a for v in batch[:, 2])
    assert a[0][0, 1] != a[1][0, 1]   # workers 0 and 1 draw apart


# -- the policy: tests/test_chaos.py:299-418, 601 -----------------------

def _policy_run(pkg, ds, stats, chaos_rule=None, **kw):
    """(values of y over one epoch, {stat: delta})."""
    _, cmon, chaos, _ = PKGS[pkg]
    before = {s: cmon.stat_get(s) for s in stats}
    kw.setdefault("prefetch_to_device", 0)
    if chaos_rule is not None:
        ctx = chaos.inject(*chaos_rule[:2], **chaos_rule[2])
    else:
        ctx = warnings.catch_warnings()
    with ctx:
        dl = _loader(pkg, ds, **kw)
        ys = [int(v) for _, y in dl for v in np.atleast_1d(_np(y))]
    return ys, {s: cmon.stat_get(s) - before[s] for s in stats}


POLICY_CASES = {
    # after=16, times=1: each forked worker (20 samples of the 40)
    # crashes once near the end of its share; the restarted worker has
    # fewer than 16 left, so it cannot re-trip: 2 restarts
    "crash_restarts_keep_order": (
        lambda: ArangeDS(40), ("io_fetch", "crash", dict(after=16, times=1)),
        dict(batch_size=2, num_workers=2), list(range(40)),
        {"io/workers/restarts": 2}),
    "skip_single_process": (
        lambda: ArangeDS(10, bad=(3,)), None,
        dict(batch_size=2, on_bad_sample="skip"),
        [i for i in range(10) if i != 3], {"io/bad_samples": 1}),
    # batch [4, 5] fails entirely -> dropped whole; [6, 7] loses one
    "skip_multiprocess_whole_batch": (
        lambda: ArangeDS(12, bad=(4, 5, 6)), None,
        dict(batch_size=2, num_workers=2, on_bad_sample="skip"),
        [0, 1, 2, 3, 7, 8, 9, 10, 11], {"io/bad_samples": 3}),
    "injected_bad_sample": (
        lambda: ArangeDS(10), ("io_fetch", "bad_sample",
                               dict(after=4, times=1)),
        dict(batch_size=2, on_bad_sample="skip"),
        [0, 1, 2, 3, 5, 6, 7, 8, 9], {"io/bad_samples": 1}),
    # each forked worker counts its own fetches: the third of worker 0
    # (index 4) and of worker 1 (index 6) are the injected bad samples
    "injected_bad_sample_in_worker": (
        lambda: ArangeDS(12), ("io_fetch", "bad_sample",
                               dict(after=2, times=1)),
        dict(batch_size=2, num_workers=2, on_bad_sample="skip"),
        [0, 1, 2, 3, 5, 7, 8, 9, 10, 11], {"io/bad_samples": 2}),
    "skip_batch_size_none": (
        lambda: ArangeDS(6, bad=(2,)), None,
        dict(batch_size=None, on_bad_sample="skip"),
        [0, 1, 3, 4, 5], {"io/bad_samples": 1}),
    "skip_batch_size_none_workers": (
        lambda: ArangeDS(6, bad=(2,)), None,
        dict(batch_size=None, num_workers=2, on_bad_sample="skip"),
        [0, 1, 3, 4, 5], {"io/bad_samples": 1}),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_jax(case):
    ds_fn, rule, kw, want_ys, want_stats = POLICY_CASES[case]
    got = _policy_run("port", ds_fn(), want_stats, rule, **kw)
    ref = _policy_run("jax", ds_fn(), want_stats, rule, **kw)
    assert got == ref
    assert got == (want_ys, want_stats)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_crash_restart_event_and_budget(pkg):
    _, cmon, chaos, flight = PKGS[pkg]
    t0 = time.time()
    with chaos.inject("io_fetch", "crash", after=16, times=1):
        dl = _loader(pkg, ArangeDS(40), batch_size=2, num_workers=2,
                     prefetch_to_device=0)
        _epoch(dl)
    ev = [e for e in flight.tail() if e.get("kind") == "io_worker_restart"
          and e.get("ts", 0) >= t0]
    assert sorted((e["worker"], e["why"], e["restarts_left"])
                  for e in ev) == [(0, "died", 1), (1, "died", 1)]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_crash_without_restart_budget_fails_fast(pkg):
    chaos = PKGS[pkg][2]
    t0 = time.monotonic()
    with chaos.inject("io_fetch", "crash", after=4, times=1):
        dl = _loader(pkg, ArangeDS(40), batch_size=2, num_workers=2,
                     worker_restarts=0, prefetch_to_device=0)
        with pytest.raises(RuntimeError, match="died unexpectedly"):
            _epoch(dl)
    assert time.monotonic() - t0 < 30.0
    assert _wait_for(lambda: not mp.active_children(), timeout=5.0)


def test_wedged_worker_restarts_on_timeout(monkeypatch):
    monkeypatch.setenv("PADDLE_IO_WORKER_TIMEOUT_S", "0.8")
    out = {}
    for pkg in PKGS:
        _, cmon, chaos, _ = PKGS[pkg]
        r0 = cmon.stat_get("io/workers/restarts")
        with chaos.inject("io_fetch", "stall", after=16, times=1, secs=60):
            dl = _loader(pkg, ArangeDS(40), batch_size=2, num_workers=2,
                         prefetch_to_device=0)
            out[pkg] = [int(np.atleast_1d(_np(y))[0]) for _, y in dl]
        assert cmon.stat_get("io/workers/restarts") > r0
    assert out["port"] == out["jax"] == list(range(0, 40, 2))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_bad_sample_policy_errors_and_warnings(pkg, monkeypatch):
    io, _, chaos, _ = PKGS[pkg]
    with pytest.raises(ValueError, match="corrupt record"):
        _epoch(_loader(pkg, ArangeDS(10, bad=(3,)), batch_size=2,
                       prefetch_to_device=0))
    with pytest.raises(ValueError):
        _loader(pkg, ArangeDS(4), on_bad_sample="explode")
    with pytest.warns(RuntimeWarning, match="no effect on an "
                                            "IterableDataset"):
        _loader(pkg, _stream(pkg), batch_size=1, on_bad_sample="skip")
    monkeypatch.setenv("PADDLE_IO_ON_BAD_SAMPLE", "drop")
    dl = _loader(pkg, ArangeDS(4), batch_size=2, prefetch_to_device=0)
    with pytest.warns(RuntimeWarning, match="PADDLE_IO_ON_BAD_SAMPLE"):
        assert dl._bad_sample_policy() == "raise"
    monkeypatch.setenv("PADDLE_IO_ON_BAD_SAMPLE", "skip")
    assert dl._bad_sample_policy() == "skip"
    monkeypatch.setenv("PADDLE_IO_WORKER_RESTARTS", "5")
    assert dl._worker_restart_budget() == 5
    assert _loader(pkg, ArangeDS(4), worker_restarts=-1) \
        ._worker_restart_budget() == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_crash_fault_raises_outside_a_worker(pkg):
    """In process (num_workers=0) the crash fault raises instead of
    os._exit, and the skip policy does not swallow it."""
    chaos = PKGS[pkg][2]
    for policy in ("raise", "skip"):
        with chaos.inject("io_fetch", "crash", times=1):
            dl = _loader(pkg, ArangeDS(6), batch_size=2,
                         prefetch_to_device=0, on_bad_sample=policy)
            with pytest.raises(chaos.ChaosInjected, match="outside an mp"):
                _epoch(dl)


# -- the device-feed stage: tests/test_pipeline_dispatch.py:605-824 -----

def test_device_prefetch_order_content_epochs_and_depths():
    base = _epoch(_loader("port", SeqDataset(), batch_size=4,
                          prefetch_to_device=0))
    for depth in (1, 2, 3):
        for pkg in PKGS:
            dl = _loader(pkg, SeqDataset(), batch_size=4,
                         prefetch_to_device=depth)
            for _ in range(2):   # a fresh feeder thread each epoch
                _same_epochs(_epoch(dl), base)


def test_device_prefetch_early_exit_stops_feeder():
    dl = _loader("port", SeqDataset(40), batch_size=2, prefetch_to_device=2)
    it = iter(dl)
    next(it)
    next(it)
    it.close()

    def feeders():
        return any("device-feed" in t.name for t in threading.enumerate())

    assert _wait_for(lambda: not feeders(), timeout=5.0)
    assert len(list(dl)) == 20


def test_device_prefetch_counters_and_flight_events():
    deltas, kinds = {}, {}
    stats = ("io/device_prefetch/bytes", "io/batches")
    for pkg in PKGS:
        _, cmon, _, flight = PKGS[pkg]
        t0 = time.time()
        before = {s: cmon.stat_get(s) for s in stats}
        h0 = cmon.stat_get("io/h2d_us")
        assert len(_epoch(_loader(pkg, SeqDataset(8), batch_size=2,
                                  prefetch_to_device=2))) == 4
        assert cmon.stat_get("io/h2d_us") >= h0
        deltas[pkg] = {s: cmon.stat_get(s) - before[s] for s in stats}
        kinds[pkg] = sorted({e["kind"] for e in flight.tail()
                             if e.get("ts", 0) >= t0
                             and e["kind"].startswith("io_")})
    # 4 batches x (x: 2x4x3 f32 = 96 B, y: 2 int64 = 16 B)
    assert deltas["port"] == deltas["jax"] == \
        {"io/device_prefetch/bytes": 4 * (96 + 16), "io/batches": 4}
    assert kinds["port"] == kinds["jax"] == ["io_device_prefetch",
                                             "io_fetch", "io_h2d"]


def _collate_pair(samples):
    xs, ys = zip(*samples)
    return np.stack(xs), np.stack(ys)


def test_device_prefetch_custom_collate_and_workers_zero_copy_off(
        monkeypatch):
    """A custom collate's batches through the stage (the JAX package
    hands them back raw, the port as tensors: equal values), over
    workers with zero-copy transport on and off."""
    for zero_copy in ("1", "0"):
        monkeypatch.setenv("FLAGS_dataloader_zero_copy", zero_copy)
        for kw in (dict(num_workers=0), dict(num_workers=2)):
            got, want = _both(lambda: SeqDataset(8), batch_size=2,
                              collate_fn=_collate_pair,
                              prefetch_to_device=2, **kw)
            _same_epochs(got, want)
            assert [int(y[0]) for _, y in got] == [0, 2, 4, 6]


class Boom:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i >= 4:
            raise RuntimeError("boom at index 4")
        return np.zeros((2,), np.float32)


@pytest.mark.parametrize("workers", [0, 2])
def test_device_prefetch_propagates_producer_error(workers):
    for pkg in PKGS:
        dl = _loader(pkg, Boom(), batch_size=2, num_workers=workers,
                     prefetch_to_device=2)
        with pytest.raises(RuntimeError, match="boom"):
            _epoch(dl)


class Slow:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        if i >= 2:
            time.sleep(0.4)
        return np.zeros((2,), np.float32)


def test_device_prefetch_abandon_does_not_wait_on_slow_fetch():
    dl = _loader("port", Slow(), batch_size=1, prefetch_to_device=1)
    it = iter(dl)
    next(it)
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 4.0


class F64:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.full((3,), float(i))


def test_device_prefetch_preserves_the_float_cast():
    plain = _epoch(_loader("port", F64(), batch_size=2,
                           prefetch_to_device=0))
    pre = _epoch(_loader("port", F64(), batch_size=2, prefetch_to_device=2))
    mpre = _epoch(_loader("port", F64(), batch_size=2, num_workers=2,
                          prefetch_to_device=2))
    want = _epoch(_loader("jax", F64(), batch_size=2, prefetch_to_device=2))
    for batches in (plain, pre, mpre):
        _same_epochs(batches, want)
        assert all(b.dtype == np.float32 for b in batches)


class SlowPersist:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i >= 1:
            time.sleep(0.6)
        return np.full((2,), i, np.float32)


def test_device_prefetch_abandon_then_reiterate_persistent_workers(
        monkeypatch):
    monkeypatch.setattr(pio.DataLoader, "_PF_REAP_S", 0.2)
    dl = _loader("port", SlowPersist(), batch_size=1, num_workers=1,
                 persistent_workers=True, prefetch_to_device=1)
    try:
        it = iter(dl)
        next(it)
        it.close()   # the feeder is likely mid-pop: an orphan
        got = [int(b[0, 0]) for b in _epoch(dl)]
    finally:
        dl._mp_loader.shutdown()
    assert got == [0, 1, 2, 3, 4, 5]


def test_device_prefetch_depth_precedence(monkeypatch):
    for pkg in PKGS:
        dl = _loader(pkg, SeqDataset(), batch_size=4)
        assert dl._device_prefetch_depth() == 0    # the CPU's default
        monkeypatch.setenv("PADDLE_IO_DEVICE_PREFETCH", "3")
        assert dl._device_prefetch_depth() == 3
        monkeypatch.setenv("PADDLE_IO_DEVICE_PREFETCH", "0")
        assert dl._device_prefetch_depth() == 0
        monkeypatch.setenv("PADDLE_IO_DEVICE_PREFETCH", "x")
        assert dl._device_prefetch_depth() == 0
        dl = _loader(pkg, SeqDataset(), batch_size=4, prefetch_to_device=5)
        assert dl._device_prefetch_depth() == 5    # the argument wins
        monkeypatch.delenv("PADDLE_IO_DEVICE_PREFETCH")


# -- sizing and the ring ------------------------------------------------

def test_auto_workers_env_clamped(monkeypatch):
    for io in (jio, pio):
        monkeypatch.setenv("PADDLE_IO_WORKERS", "0")
        assert io._auto_num_workers() == 1
        assert io._resolve_num_workers(-1) == 1
        assert io._resolve_num_workers(0) == 0
        monkeypatch.setenv("PADDLE_IO_WORKERS", "5")
        assert io._resolve_num_workers("auto") == 5
        monkeypatch.setenv("PADDLE_IO_WORKERS", "many")
        assert io._auto_num_workers() == max(1, min(os.cpu_count(), 16))
        monkeypatch.delenv("PADDLE_IO_WORKERS")
        assert io._auto_num_workers() == max(1, min(os.cpu_count(), 16))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_ring_written_by_one_package_is_read_by_the_other(writer):
    """The port's csrc/shm_ring.cc keeps the JAX ring's layout: one
    package creates a ring and pushes a zero-copy framed batch, a
    stacked batch and an EOF marker; the other opens it and reads them
    back."""
    w, r = (pworker, jworker) if writer == "port" else (jworker, pworker)
    name = f"/pdtpu_test_{os.getpid()}_{writer}"
    ring_w = w.ShmRing(name, 4, 1 << 16, create=True)
    ring_r = r.ShmRing(name, 4, 1 << 16, create=False)
    try:
        batch = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
                 "y": [np.int64(7), "tag"]}
        w._push_batch(ring_w, batch)
        samples = [(np.full((2, 2), i, np.float32), np.int64(i))
                   for i in range(3)]
        assert w._try_push_stacked(ring_w, samples)
        ring_w.push(w._EOF)
        got = r._decode_view(ring_r.pop_view(1000))
        np.testing.assert_array_equal(got["x"], batch["x"])
        assert got["y"][0] == 7 and got["y"][1] == "tag"
        xs, ys = r._decode_view(ring_r.pop_view(1000))
        np.testing.assert_array_equal(xs, np.stack([s[0] for s in samples]))
        np.testing.assert_array_equal(ys, [0, 1, 2])
        del got, xs, ys
        assert bytes(ring_r.pop_view(1000)) == r._EOF
        ring_r.release_view()
        assert ring_r.pop_view(0) is None
    finally:
        ring_r.close()
        ring_w.close()


def test_shm_room_is_checked_before_forking(monkeypatch):
    """The rings must fit the shared-memory filesystem: a pool that does
    not fit raises OSError naming both sizes, and the DataLoader falls
    back to the thread prefetcher with the JAX package's warning."""
    monkeypatch.setattr(pworker, "ring_bytes", lambda s, b: 1 << 62)
    with pytest.raises(OSError, match="shared-memory rings need"):
        pworker.MultiprocessLoader(SquareDataset(8), pio._np_collate, 2, 2,
                                   1, None, 0, False)
    dl = _loader("port", SquareDataset(8), batch_size=4, num_workers=2)
    with pytest.warns(RuntimeWarning, match="multiprocess DataLoader "
                                            "unavailable"):
        got = _epoch(dl)
    _same_epochs(got, _epoch(_loader("port", SquareDataset(8),
                                     batch_size=4)))
    assert pworker.ring_bytes.__name__ == "<lambda>"
    monkeypatch.undo()
    assert pworker.ring_bytes(2, 100) == 64 + 2 * (64 + 128)


def test_np_collate_keeps_torch_samples():
    samples = [(torch.full((2,), float(i)), torch.tensor(i)) for i in range(3)]
    x, y = pio._np_collate(samples)
    assert isinstance(x, np.ndarray) and x.dtype == np.float32
    np.testing.assert_array_equal(y, [0, 1, 2])
    bf = pio._np_collate([torch.ones(2, dtype=torch.bfloat16)] * 2)
    assert isinstance(bf, torch.Tensor) and bf.dtype == torch.bfloat16
    ds = pio.TensorDataset([torch.arange(12.0).reshape(6, 2),
                            torch.arange(6)])
    got = _epoch(_loader("port", ds, batch_size=2, num_workers=2))
    _same_epochs(got, _epoch(_loader("port", ds, batch_size=2)))


def test_threaded_prefetcher_raises_the_producer_error():
    """use_shared_memory=False: the port raises the producer thread's
    error on the consumer side; the JAX package's epoch ends early at
    it instead (ROADMAP queue 3 #41)."""
    dl = _loader("port", Boom(), batch_size=2, num_workers=2,
                 use_shared_memory=False)
    with pytest.raises(RuntimeError, match="boom at index 4"):
        _epoch(dl)
    jdl = _loader("jax", Boom(), batch_size=2, num_workers=2,
                  use_shared_memory=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert len(_epoch(jdl)) == 2


class Pair:
    """A container the loader does not walk: its arrays must not alias
    the ring once handed out."""

    def __init__(self, x, y):
        self.x, self.y = x, y


def _collate_obj(samples):
    xs, ys = zip(*samples)
    return Pair(np.stack(xs), np.stack(ys))


def test_custom_container_is_detached_from_the_ring():
    """A custom collate's batch is detached from its slot whatever its
    container (the JAX package's `_detach_views`): held batches keep
    their values after the workers reuse the slots."""
    for pkg in PKGS:
        held = list(_loader(pkg, SeqDataset(16), batch_size=2,
                            num_workers=2, collate_fn=_collate_obj))
        assert [int(b.y[0]) for b in held] == list(range(0, 16, 2))
        for k, b in enumerate(held):
            np.testing.assert_array_equal(
                b.x, np.stack([np.full((4, 3), 2 * k + j, np.float32)
                               for j in range(2)]))
