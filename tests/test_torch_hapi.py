"""The port's `hapi.Model` held against the JAX package's, on the CPU: a
small BERT (2 layers, hidden 64, 2 heads, vocab 512, S 32, f32, dropout
0) with the same weights (`convert.load_reference_state_dict`) is
fitted by both `Model.fit`s over the same seeded `BatchSampler` order
(24 rows, batches of 4: 6 steps an epoch, 2 epochs) with AdamW under
LinearWarmup(4) + CosineAnnealingDecay, the LR callback stepping it by
batch. The network wraps `BertForPretraining` so that a per-row
`scale` multiplies the MLM logits: 1 everywhere (an exact no-op) except
in the non-finite cases, where one row is NaN.

Tolerances:

  * per-step losses within 1e-5 relative (measured <= 3e-7: the
    packages sum in another order);
  * final parameters within 1e-5 absolute, 1% of the peak learning
    rate (measured <= 2.1e-7 in the plain fit, 1.4e-6 under gradient
    merge, where AdamW's normalised step turns a gradient element near
    zero and a rounding apart into a visible difference), except
    the attention's key bias (the middle third of each `qkv_bias`):
    softmax is invariant to it, so its true gradient is 0 and both
    packages' gradients are rounding noise, which AdamW normalises into
    steps of up to lr each. It is held within the peak learning rate
    times the optimizer steps (1.2e-2 over 12 steps; measured 1.9e-4);
  * step counts, learning rates and which steps were skipped or run:
    exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu.hapi import flops as jflops
from paddle_tpu.hapi import summary as jsummary
import paddle_tpu.metric as jmetric
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.text.models import bert as jbert

import paddle_tpu_torch.io as pio
import paddle_tpu_torch.metric as pmetric
import paddle_tpu_torch.optimizer as poptim
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.hapi import Model as PModel
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.hapi import flops as pflops
from paddle_tpu_torch.hapi import summary as psummary
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.text.models import bert as pbert

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           ffn_hidden=128, max_seq_len=32, dropout=0.0)
N, S, B = 24, 32, 4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


class JNet(paddle.nn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, tt, scale):
        logits, nsp = self.m(ids, token_type_ids=tt)
        return logits * scale.reshape([-1, 1, 1]), nsp


class PNet(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, tt, scale):
        logits, nsp = self.m(ids, token_type_ids=tt)
        return logits * scale.reshape(-1, 1, 1), nsp


def _data(poison_row=None, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (N, S)).astype(np.int64)
    tt = rng.randint(0, 2, (N, S)).astype(np.int64)
    labels = ids.copy()
    labels[rng.rand(N, S) < 0.3] = -1
    scale = np.ones((N,), np.float32)
    if poison_row is not None:
        scale[poison_row] = np.nan
    return ids, tt, scale, labels


def _jloss(logits, nsp, labels):
    return JF.cross_entropy(logits, labels, ignore_index=-1)


def _ploss(logits, nsp, labels):
    return PF.cross_entropy(logits, labels, ignore_index=-1)


def _sched(mod):
    return mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(1e-3, 12), 4,
                               0.0, 1e-3)


class _Losses:
    """A callback class per package that records every batch's loss."""

    @staticmethod
    def make(base):
        class Rec(base):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs["loss"]))

        return Rec()


class Pair:
    """The same fit in both packages."""

    def __init__(self, poison_row=None, metrics=False):
        paddle.seed(0)
        self.jnet = JNet(jbert.BertForPretraining(jbert.BertConfig(**CFG)))
        self.pnet = PNet(pbert.BertForPretraining(pbert.BertConfig(**CFG),
                                                  device="cpu"))
        load_reference_state_dict(self.pnet, {
            k: np.asarray(v._value)
            for k, v in self.jnet.state_dict().items()})
        self.arrays = _data(poison_row)
        self.jopt = joptim.AdamW(learning_rate=_sched(joptim),
                                 parameters=self.jnet.parameters(),
                                 weight_decay=0.01)
        self.popt = poptim.AdamW(learning_rate=_sched(poptim),
                                 parameters=self.pnet.parameters(),
                                 weight_decay=0.01)
        self.jm = JModel(self.jnet).prepare(
            self.jopt, _jloss, jmetric.Accuracy() if metrics else None)
        self.pm = PModel(self.pnet).prepare(
            self.popt, _ploss, pmetric.Accuracy() if metrics else None)

    def loaders(self, seed=11):
        jds = jio.TensorDataset([paddle.to_tensor(a) for a in self.arrays])
        pds = pio.TensorDataset([torch.from_numpy(a) for a in self.arrays])
        kw = dict(shuffle=True, batch_size=B, drop_last=True, seed=seed)
        return (jio.DataLoader(jds, batch_sampler=jio.BatchSampler(jds, **kw)),
                pio.DataLoader(pds, batch_sampler=pio.BatchSampler(pds, **kw),
                               device="cpu"))

    def fit(self, epochs=2, jcallbacks=(), pcallbacks=(), **kw):
        jl, pl = self.loaders()
        jrec, prec = _Losses.make(jcb.Callback), _Losses.make(pcb.Callback)
        self.jm.fit(jl, epochs=epochs, verbose=0,
                    callbacks=[jrec, *jcallbacks], **kw)
        self.pm.fit(pl, epochs=epochs, verbose=0,
                    callbacks=[prec, *pcallbacks], **kw)
        return np.array(jrec.losses), np.array(prec.losses)

    def check_losses(self, jl, pl):
        assert len(pl) == len(jl)
        assert (np.isfinite(pl) == np.isfinite(jl)).all()
        ok = np.isfinite(jl)
        np.testing.assert_allclose(pl[ok], jl[ok], rtol=LOSS_RTOL)

    def check_params(self):
        jsd = {k: np.asarray(v._value)
               for k, v in self.jnet.state_dict().items()}
        lr_sum = 1e-3 * max(self.popt._step_count, 1)
        E = CFG["hidden_size"]
        for name, p in self.pnet.named_parameters():
            d = np.abs(p.detach().numpy() - jsd[name])
            if name.endswith("qkv_bias"):
                # the key bias: a zero gradient, rounding noise in both
                assert float(d[E:2 * E].max()) <= lr_sum, name
                d = np.concatenate([d[:E], d[2 * E:]])
            assert float(d.max()) <= PARAM_ATOL, (name, float(d.max()))
        assert self.popt._step_count == self.jopt._step_count
        assert self.popt.get_lr() == self.jopt.get_lr()


def test_fit_matches_jax():
    pair = Pair()
    jl, pl = pair.fit()
    assert len(pl) == 12
    pair.check_losses(jl, pl)
    pair.check_params()
    assert pl[-1] < pl[0]


def test_fit_accumulate_grad_batches_2_matches_jax():
    pair = Pair()
    jl, pl = pair.fit(accumulate_grad_batches=2)
    pair.check_losses(jl, pl)
    pair.check_params()
    assert pair.popt._step_count == 6


@pytest.mark.parametrize("k", [2, 4])
def test_fit_steps_per_dispatch_matches_jax(k):
    """K=2 splits each epoch's 6 batches into 3 calls of a 2-wide step;
    K=4 into one 4-wide call and a ragged 2 run batch by batch through
    the K=1 sibling, which shares the state."""
    pair = Pair()
    jl, pl = pair.fit(steps_per_dispatch=k)
    pair.check_losses(jl, pl)
    pair.check_params()
    assert pair.pm._compiled_step._steps_per_dispatch == k
    assert (pair.pm._tail_step is not None) == (k == 4)


def test_fit_guard_nonfinite_matches_jax():
    pair = Pair(poison_row=5)
    jl, pl = pair.fit(guard_nonfinite=True)
    assert int((~np.isfinite(pl)).sum()) == 2     # once an epoch
    pair.check_losses(jl, pl)
    pair.check_params()


def test_fit_terminate_on_nan_stops_like_jax():
    pair = Pair(poison_row=5)
    with pytest.warns(RuntimeWarning, match="terminate_on_nan"):
        jl, pl = pair.fit(guard_nonfinite=True, terminate_on_nan=1)
    assert len(pl) == len(jl) < 6 and not np.isfinite(pl[-1])
    pair.check_losses(jl, pl)
    pair.check_params()
    assert pair.pm.stop_training and pair.pm._nonfinite_stopped


def test_evaluate_and_predict_match_jax():
    pair = Pair(metrics=True)
    pair.fit(epochs=1)
    jl, pl = pair.loaders()
    jr, pr = pair.jm.evaluate(jl), pair.pm.evaluate(pl)
    np.testing.assert_allclose(pr["loss"], jr["loss"], rtol=LOSS_RTOL)
    assert abs(pr["acc"] - jr["acc"]) <= 1.0 / (N * S)   # one token
    ids, tt, scale, _ = pair.arrays
    jds = jio.TensorDataset([paddle.to_tensor(a) for a in (ids, tt, scale)])
    pds = pio.TensorDataset([torch.from_numpy(a) for a in (ids, tt, scale)])
    jp = pair.jm.predict(jds, batch_size=8, stack_outputs=True)
    pp = pair.pm.predict(pds, batch_size=8, stack_outputs=True)
    assert [a.shape for a in pp] == [a.shape for a in jp] \
        == [(N, S, CFG["vocab_size"]), (N, 2)]
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_train_batch_loss_probe_does_not_update():
    pair = Pair()
    ids, tt, scale, labels = (a[:B] for a in pair.arrays)
    before = [p.detach().clone() for p in pair.pnet.parameters()]
    lp = pair.pm.train_batch([torch.from_numpy(ids), torch.from_numpy(tt),
                              torch.from_numpy(scale)],
                             [torch.from_numpy(labels)], update=False)
    lj = pair.jm.train_batch([paddle.to_tensor(a) for a in (ids, tt, scale)],
                             [paddle.to_tensor(labels)], update=False)
    np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL)
    assert all(torch.equal(a, b) for a, b in
               zip(before, pair.pnet.parameters()))
    assert pair.pm._compiled_step is None and pair.popt._step_count == 0
    # update=True steps once, and equals JAX's step
    lp = pair.pm.train_batch([torch.from_numpy(ids), torch.from_numpy(tt),
                              torch.from_numpy(scale)],
                             [torch.from_numpy(labels)])
    lj = pair.jm.train_batch([paddle.to_tensor(a) for a in (ids, tt, scale)],
                             [paddle.to_tensor(labels)])
    np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL)
    assert pair.popt._step_count == 1


def test_save_load_round_trip_and_jax_checkpoints(tmp_path):
    pair = Pair()
    pair.fit(epochs=1)
    pair.pm.save(str(tmp_path / "p"))
    pair.jm.save(str(tmp_path / "j"))
    other = Pair()
    other.pm.load(str(tmp_path / "p"))
    for (n, a), b in zip(pair.pnet.named_parameters(),
                         other.pnet.parameters()):
        assert torch.equal(a, b), n
    sa, sb = pair.popt.state_dict(), other.popt.state_dict()
    assert set(sa) == set(sb) and sb["@step"] == 6
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb[k]), k
    assert sb["LR_Scheduler"] == sa["LR_Scheduler"]
    # the JAX Model's .pdparams carries the same names and loads
    third = Pair()
    third.pm.load(str(tmp_path / "j"), reset_optimizer=True)
    jsd = {k: np.asarray(v._value) for k, v in pair.jnet.state_dict().items()}
    for n, p in third.pnet.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), jsd[n])


def test_early_stopping_matches_jax():
    pair = Pair()
    kw = dict(monitor="loss", patience=1, min_delta=100.0)
    jl, pl = pair.fit(epochs=5, jcallbacks=[jcb.EarlyStopping(**kw)],
                      pcallbacks=[pcb.EarlyStopping(**kw)])
    assert len(pl) == len(jl) == 12              # stopped after epoch 2
    pair.check_losses(jl, pl)
    assert pair.pm.stop_training


def test_fit_over_a_dataset_and_a_failing_step_raises():
    """A Dataset is loaded on the network's device; a step that raises
    is not demoted to another path: the error reaches the caller.
    `num_workers` reaches the DataLoader fit builds: fed by 2 worker
    processes, the same 2 steps give the same parameters, bit for
    bit."""
    pair = Pair()
    pds = pio.TensorDataset([torch.from_numpy(a) for a in pair.arrays])
    pair.pm.fit(pds, batch_size=B, epochs=1, shuffle=False, verbose=0,
                num_iters=2)
    assert pair.popt._step_count == 2

    def bad_loss(*args):
        raise RuntimeError("a broken loss")

    pair.pm.prepare(pair.popt, bad_loss)
    pair.pm._compiled_step = None
    with pytest.raises(RuntimeError, match="a broken loss"):
        pair.pm.fit(pds, batch_size=B, epochs=1, verbose=0)
    fed = Pair()
    fed.pm.fit(pds, batch_size=B, epochs=1, shuffle=False, verbose=0,
               num_iters=2, num_workers=2)
    assert fed.popt._step_count == 2
    want = dict(pair.pnet.named_parameters())
    for name, p in fed.pnet.named_parameters():
        assert torch.equal(p, want[name]), name


def test_summary_and_flops_on_lenet_match_jax(capsys):
    """`summary` / `flops` / `Model.summary` (and the root's `paddle.summary`
    / `paddle.flops`) give the JAX package's totals on LeNet: 61,610
    parameters, all trainable, and its Conv2D / Linear FLOPs at 1 x 28²
    and 4 x 28² (the convolutions counted without the batch, the Linear
    rows with it: ROADMAP queue 3 #38); a frozen parameter leaves the
    trainable count; the network's training mode is restored."""
    import paddle_tpu_torch
    from paddle_tpu.vision.models import LeNet as JLeNet
    from paddle_tpu_torch.vision.models import LeNet as PLeNet

    paddle.seed(0)
    jnet, pnet = JLeNet(), PLeNet(device="cpu")
    want = jsummary(jnet)
    assert psummary(pnet) == PModel(pnet).summary() == \
        paddle_tpu_torch.summary(pnet) == want == \
        {"total_params": 61610, "trainable_params": 61610}
    assert "Total params: 61,610" in capsys.readouterr().out
    for shape in ([1, 1, 28, 28], [4, 1, 28, 28]):
        assert pflops(pnet, shape) == paddle_tpu_torch.flops(pnet, shape) \
            == jflops(jnet, shape)
    assert pflops(pnet, [1, 1, 28, 28]) == 682512
    assert pnet.training
    pnet.fc[0].weight.requires_grad_(False)
    jnet.fc[0].weight.trainable = False
    assert psummary(pnet) == jsummary(jnet)
    assert psummary(pnet)["trainable_params"] == 61610 - 120 * 400
