"""The port's data pipeline (`paddle_tpu_torch.io`) held against the JAX
package's `paddle_tpu.io`, on the CPU.

The samplers carry the JAX package's numpy logic, so the same seed must
give the same indices exactly (no tolerance): `BatchSampler(seed=...)`
over 3 epochs, the global-RNG samplers after the same `np.random.seed`,
`DistributedBatchSampler` per rank and epoch, and the fast-forward of a
restored cursor. Collated batches must equal JAX's element for element.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio

import paddle_tpu_torch.io as pio


def _indices(sampler, epochs=3):
    return [[list(b) for b in sampler] for _ in range(epochs)]


@pytest.mark.parametrize("shuffle,drop_last,batch_size,n",
                         [(True, True, 8, 48), (True, False, 5, 23),
                          (False, False, 4, 10), (False, True, 3, 10)])
def test_batch_sampler_order_matches_jax_over_3_epochs(shuffle, drop_last,
                                                       batch_size, n):
    ds = list(range(n))
    kw = dict(shuffle=shuffle, batch_size=batch_size, drop_last=drop_last,
              seed=11 if shuffle else None)
    js, ps = jio.BatchSampler(ds, **kw), pio.BatchSampler(ds, **kw)
    got, want = _indices(ps), _indices(js)
    assert got == want
    assert len(ps) == len(js)
    if shuffle:
        assert got[0] != got[1]          # reshuffled each epoch


def test_global_rng_samplers_match_jax():
    ds = list(range(17))
    for make in (lambda m: m.RandomSampler(ds),
                 lambda m: m.RandomSampler(ds, replacement=True,
                                           num_samples=9),
                 lambda m: m.WeightedRandomSampler([1, 2, 3, 4, 0.5], 12),
                 lambda m: m.SequenceSampler(ds)):
        np.random.seed(3)
        want = list(make(jio))
        np.random.seed(3)
        got = list(make(pio))
        assert got == want
    np.random.seed(5)
    want = [s.indices for s in jio.random_split(ds, [0.5, 0.5])]
    np.random.seed(5)
    got = [s.indices for s in pio.random_split(ds, [0.5, 0.5])]
    assert got == want


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle):
    ds = list(range(21))
    for rank in range(3):
        js = jio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle)
        ps = pio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle)
        for epoch in range(3):
            js.set_epoch(epoch)
            ps.set_epoch(epoch)
            assert list(ps) == list(js)
        assert len(ps) == len(js)


@pytest.mark.parametrize("consumed", [0, 2, 5])
def test_fast_forward_matches_jax_and_the_uninterrupted_order(consumed):
    ds = list(range(48))
    kw = dict(shuffle=True, batch_size=8, drop_last=True, seed=11)
    full = _indices(pio.BatchSampler(ds, **kw), epochs=3)
    js, ps = jio.BatchSampler(ds, **kw), pio.BatchSampler(ds, **kw)
    for s in (js, ps):
        s.set_state_dict({"epoch": 1, "consumed": consumed})
    got = [list(b) for b in ps]
    assert got == [list(b) for b in js]
    assert got == full[1][consumed:]
    # the epoch after the fast-forwarded one is whole again
    assert [list(b) for b in ps] == full[2]
    d = pio.DistributedBatchSampler(ds, 4, num_replicas=2, rank=1,
                                    shuffle=True)
    d.set_state_dict({"epoch": 2, "consumed": consumed})
    d2 = pio.DistributedBatchSampler(ds, 4, num_replicas=2, rank=1,
                                     shuffle=True)
    d2.set_epoch(2)
    assert list(d) == list(d2)[consumed:]


def test_dataloader_batches_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(23, 3).astype(np.float32)
    y = rng.randint(0, 5, (23, 1)).astype(np.int64)
    jds = jio.TensorDataset([paddle.to_tensor(x), paddle.to_tensor(y)])
    pds = pio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    kw = dict(shuffle=True, batch_size=5, drop_last=False, seed=2)
    jl = jio.DataLoader(jds, batch_sampler=jio.BatchSampler(jds, **kw))
    pl = pio.DataLoader(pds, batch_sampler=pio.BatchSampler(pds, **kw),
                        device="cpu")
    assert len(pl) == len(jl) == 5
    for _ in range(2):
        jb, pb = list(jl), list(pl)      # whole epochs: both advance
        assert len(jb) == len(pb)
        for (jx, jy), (px, py) in zip(jb, pb):
            assert px.dtype == torch.float32 and py.dtype == torch.int64
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx._value))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy._value))


def test_default_collate_matches_jax_on_nested_samples():
    samples = [({"a": np.float64(i), "b": np.arange(3) + i}, [i, 2.5 * i])
               for i in range(4)]
    want = jio.default_collate_fn(samples)
    got = pio.default_collate_fn(samples)
    assert got[0]["a"].dtype == torch.float32    # float64 -> float32
    np.testing.assert_array_equal(got[0]["a"].numpy(),
                                  np.asarray(want[0]["a"]._value))
    np.testing.assert_array_equal(got[0]["b"].numpy(),
                                  np.asarray(want[0]["b"]._value))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w._value))


def test_dataloader_state_dict_round_trip():
    ds = pio.TensorDataset([torch.arange(48)])
    kw = dict(shuffle=True, batch_size=8, drop_last=True, seed=11)
    a = pio.DataLoader(ds, batch_sampler=pio.BatchSampler(ds, **kw),
                       device="cpu")
    it = iter(a)
    first = [next(it)[0].tolist() for _ in range(3)]
    state = a.state_dict()
    assert state == {"batch_sampler": {"epoch": 0, "consumed": 3,
                                       "seed": 11}}
    rest = [b[0].tolist() for b in it]
    b = pio.DataLoader(ds, batch_sampler=pio.BatchSampler(ds, **kw),
                       device="cpu")
    b.set_state_dict(state)
    assert [x[0].tolist() for x in b] == rest
    assert len(first) + len(rest) == 6


def test_dataloader_refuses_workers_and_defaults_to_the_card(monkeypatch):
    """Workers are served (num_workers=1 and -1, the batches those of
    num_workers=0); the loader's device is the card unless "cpu" is
    asked for; an IterableDataset pipeline has no cursor."""
    ds = pio.TensorDataset([torch.arange(4)])
    want = [b[0].tolist() for b in pio.DataLoader(ds, batch_size=2,
                                                  device="cpu")]
    monkeypatch.setenv("PADDLE_IO_WORKERS", "2")
    for n, w in ((1, 1), (-1, 2)):
        dl = pio.DataLoader(ds, batch_size=2, num_workers=n, device="cpu")
        assert dl.num_workers == w
        assert [b[0].tolist() for b in dl] == want == [[0, 1], [2, 3]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pio.DataLoader(ds)
    it = pio.DataLoader(pio.IterableDataset(), device="cpu")
    with pytest.raises(TypeError):
        it.state_dict()


def test_datasets_match_jax():
    a = [(i, 10 * i) for i in range(5)]
    b = [(-i,) for i in range(4)]
    assert list(pio.ComposeDataset([a, b])[k] for k in range(4)) == \
        list(jio.ComposeDataset([a, b])[k] for k in range(4))
    assert len(pio.ComposeDataset([a, b])) == 4
    assert [x for x in pio.ChainDataset([[1, 2], [3]])] == [1, 2, 3]
    sub = pio.Subset(a, [4, 0])
    assert [sub[0], sub[1]] == [a[4], a[0]] and len(sub) == 2
    loader = pio.DataLoader([1.0, 2.0, 3.0], batch_size=None, device="cpu")
    assert [t.tolist() for t in loader] == [[1.0], [2.0], [3.0]]
