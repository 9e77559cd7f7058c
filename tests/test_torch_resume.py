"""Kill-and-resume of the port's `hapi.Model.fit` on the CPU, the
counterpart of tests/test_elastic.py:873-942: a fit that checkpoints
every step is SIGKILLed mid-epoch once a snapshot is on disk; its
relaunch with the same PADDLE_JOB_ID resumes from that snapshot, and the
stitched run must equal an uninterrupted one bit for bit: every step's
loss (`float.hex()`), and at the end the parameters, the optimizer's
slots (moments, beta powers, master weights), its step count and the
learning rate.

Two configurations, each holding the pieces of the snapshot to account:

  * `bert`: a small BERT (2 layers, hidden 64, vocab 512, S 32) in bf16
    O2 with f32 master weights, dropout 0.1 (so the dropout generator's
    state matters), AdamW under LinearWarmup + cosine, a seeded
    BatchSampler (24 rows, batches of 4, 2 epochs) and
    accumulate_grad_batches=2; the kill lands after microstep 7, inside
    a merge window and one batch into the second epoch;
  * `dp`: the same BERT in f32 without dropout on 2 gloo ranks, where
    `Model` builds a `DistributedTrainStepCompiler`, under
    PADDLE_COMM_COMPRESS=int8:ef (so each rank's error-feedback
    residual matters); each rank writes its own rank file.

Negative controls relaunch from a copy of the same killed run's
snapshots with one piece left out of the restore (the slots, the master
weights, the scheduler state, the cursor, the generator state, the merge
buffers, the residual): each must break the equality, which shows the
piece is needed.

This file is also the worker: run as a script, it does one fit (the env
below says which), logging "<global step> <loss hex>" per step, fsynced.
"""
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           ffn_hidden=128, max_seq_len=32)
N, S, B, EPOCHS = 24, 32, 4, 2
STEPS = N // B * EPOCHS
STALL_AT = 7
BERT_OMIT = ("slots", "master", "sched", "cursor", "rng", "accum")


# -- the worker ------------------------------------------------------------
def _omitting(piece):
    """Make CheckpointManager.restore leave `piece` out (a negative
    control)."""
    from paddle_tpu_torch.incubate.checkpoint import elastic

    real = elastic.CheckpointManager.restore

    def restore(self):
        state = real(self)
        if state is None:
            return None
        if piece == "slots":
            state["opt_slots"] = {}
        elif piece == "master":
            state["opt_slots"] = {
                n: {k: v for k, v in sl.items() if k != "master_weight"}
                for n, sl in state["opt_slots"].items()}
        elif piece == "sched":
            state["opt_meta"]["lr_sched"] = None
        elif piece == "cursor":
            self.cursor = dict(self.cursor, epoch=0, step_in_epoch=0)
        elif piece == "rng":
            state["rng"] = {}
        elif piece == "accum":
            state["opt_accum"] = None
        elif piece == "residual":
            state["opt_comm"] = None
        return state

    elastic.CheckpointManager.restore = restore


def _fit(kind):
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import BatchSampler, DataLoader, TensorDataset
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.text.models.bert import (BertConfig,
                                                   BertForPretraining)

    torch.set_num_threads(1)
    if os.environ.get("RESUME_OMIT"):
        _omitting(os.environ["RESUME_OMIT"])
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    log_path = os.environ["ELASTIC_LOSS_LOG"]
    stall_at = int(os.environ.get("ELASTIC_STALL_AT", "-1"))
    bert = kind == "bert"
    net = BertForPretraining(BertConfig(dropout=0.1 if bert else 0.0, **CFG),
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    if bert:
        net = amp.decorate(net, level="O2", dtype="bfloat16")
    rng = np.random.RandomState(3)
    ids = rng.randint(0, CFG["vocab_size"], (N, S)).astype(np.int64)
    tt = np.zeros((N, S), np.int64)
    ds = TensorDataset([torch.from_numpy(ids), torch.from_numpy(tt),
                        torch.from_numpy(ids)])
    loader = DataLoader(ds, batch_sampler=BatchSampler(
        ds, shuffle=True, batch_size=B, drop_last=True, seed=11),
        device="cpu")
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, STEPS), 4, 0.0,
                            1e-3)
    opt = AdamW(learning_rate=sched, parameters=net.parameters(),
                weight_decay=0.01, multi_precision=bert)
    model = Model(net).prepare(
        opt, lambda logits, nsp, labels: F.cross_entropy(logits, labels))

    class LossLog(Callback):
        """Runs before the training-state saver (fit appends it last), so
        the manager's global step is the completed count before this
        step."""

        def on_train_batch_end(self, step, logs=None):
            mgr = self.model._ckpt_manager
            g = mgr.global_step
            if rank == 0:
                with open(log_path, "a") as f:
                    f.write(f"{g} {float(logs['loss']).hex()}\n")
                    f.flush()
                    os.fsync(f.fileno())
            if g == stall_at:
                # parked: the parent SIGKILLs once step g's snapshot is on
                # disk
                mgr.flush()
                while True:
                    time.sleep(0.5)

    model.fit(loader, epochs=EPOCHS, verbose=0, resume="auto",
              accumulate_grad_batches=2 if bert else 1,
              callbacks=[LossLog()])
    final = os.environ.get("RESUME_FINAL")
    if final and rank == 0:
        framework.save({
            "params": dict(net.state_dict()),
            "slots": opt._slot_state(list(net.named_parameters())),
            "step_count": opt._step_count, "lr": opt.get_lr()}, final)


def _dp_rank():
    _fit("dp")


def _main():
    kind = os.environ["RESUME_KIND"]
    if kind == "bert":
        _fit("bert")
        return 0
    from paddle_tpu_torch.distributed import spawn

    os.environ["PADDLE_COMM_COMPRESS"] = "int8:ef:block=128"
    spawn(_dp_rank, nprocs=2, device="cpu")
    return 0


# -- the tests -------------------------------------------------------------
def _env(tmp, log, kind, ckpt, stall_at=None, omit=None, final=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", RESUME_KIND=kind,
               PADDLE_CKPT_DIR=str(ckpt), PADDLE_JOB_ID="resume_job",
               PADDLE_CKPT_SAVE_STEPS="1", ELASTIC_LOSS_LOG=str(tmp / log))
    if stall_at is not None:
        env["ELASTIC_STALL_AT"] = str(stall_at)
    if omit is not None:
        env["RESUME_OMIT"] = omit
    if final is not None:
        env["RESUME_FINAL"] = str(tmp / final)
    return env


def _run(env):
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr.decode()[-3000:]


def _parse_log(path):
    out = {}
    with open(path) as f:
        for line in f:
            g, h = line.split()
            out[int(g)] = h
    return out


def _snapshot_dir(ckpt):
    return os.path.join(str(ckpt), "resume_job", "train_state")


def _killed_run(tmp, kind, ranks):
    """Run a fit that parks after logging step STALL_AT and SIGKILL its
    process group once step STALL_AT's manifest and every rank file are
    on disk; its log."""
    ckpt = tmp / "victim_ckpt"
    env = _env(tmp, "victim.log", kind, ckpt, stall_at=STALL_AT)
    victim = subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True)
    step_dir = os.path.join(_snapshot_dir(ckpt), f"step_{STALL_AT}")
    wanted = ["manifest.json"] + [f"state_rank{r}.pd" for r in range(ranks)]
    log = tmp / "victim.log"
    deadline = time.monotonic() + 240
    try:
        while time.monotonic() < deadline:
            if victim.poll() is not None:
                out = victim.stdout.read().decode(errors="replace")
                pytest.fail(f"worker exited early:\n{out[-3000:]}")
            if (all(os.path.exists(os.path.join(step_dir, w))
                    for w in wanted)
                    and log.exists() and STALL_AT in _parse_log(log)):
                break
            time.sleep(0.1)
        else:
            pytest.fail("worker never reached the stall point")
        os.killpg(victim.pid, signal.SIGKILL)  # no cleanup, no flush
    finally:
        if victim.poll() is None:
            os.killpg(victim.pid, signal.SIGKILL)
        victim.wait(30)
        victim.stdout.close()
    part1 = _parse_log(log)
    assert max(part1) == STALL_AT
    return part1, ckpt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per configuration: the uninterrupted run's losses and final state,
    and the killed run's log and snapshot directory (kept pristine;
    each relaunch resumes from a copy)."""
    from paddle_tpu_torch import framework

    out = {}
    for kind, ranks in (("bert", 1), ("dp", 2)):
        tmp = tmp_path_factory.mktemp(kind)
        _run(_env(tmp, "ref.log", kind, tmp / "ref_ckpt", final="ref.pd"))
        ref = _parse_log(tmp / "ref.log")
        assert sorted(ref) == list(range(STEPS))
        part1, ckpt = _killed_run(tmp, kind, ranks)
        out[kind] = dict(tmp=tmp, ref=ref, part1=part1, ckpt=ckpt,
                         final=framework.load(str(tmp / "ref.pd")))
    return out


def _resume(run, kind, name, omit=None):
    """Relaunch from a copy of the killed run's snapshots; (stitched
    losses, resumed-run losses, final state)."""
    from paddle_tpu_torch import framework

    tmp = run["tmp"]
    ckpt = tmp / f"{name}_ckpt"
    shutil.copytree(run["ckpt"], ckpt)
    _run(_env(tmp, f"{name}.log", kind, ckpt, omit=omit,
              final=f"{name}.pd"))
    part2 = _parse_log(tmp / f"{name}.log")
    stitched = dict(run["part1"])
    stitched.update(part2)
    return stitched, part2, framework.load(str(tmp / f"{name}.pd"))


def _same_state(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_state(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("kind", ["bert", "dp"])
def test_sigkill_mid_fit_resume_bit_identical(runs, kind):
    run = runs[kind]
    stitched, part2, final = _resume(run, kind, "resumed")
    # the relaunch replays from the last durable boundary
    assert min(part2) == STALL_AT
    assert sorted(stitched) == list(range(STEPS))
    for g in set(run["part1"]) & set(part2):
        assert run["part1"][g] == part2[g], f"step {g} diverged on resume"
    assert stitched == run["ref"]
    assert _same_state(final, run["final"])
    slots = final["slots"]
    if kind == "bert":
        assert all("master_weight" in sl for n, sl in slots.items()
                   if final["params"][n].dtype == torch.bfloat16)
    assert final["step_count"] == (STEPS // 2 if kind == "bert" else STEPS)


@pytest.mark.parametrize("kind,omit", [("bert", p) for p in BERT_OMIT]
                         + [("dp", "residual")])
def test_resume_without_a_piece_breaks_bit_identity(runs, kind, omit):
    run = runs[kind]
    stitched, part2, final = _resume(run, kind, f"omit_{omit}", omit=omit)
    assert part2                      # the relaunch trained
    assert stitched != run["ref"] or not _same_state(final, run["final"])


def test_embedding_backward_sums_each_id_in_f32_in_a_fixed_order():
    """The port's embedding gradient, a segment sum over the stably
    sorted ids (what keeps BERT-base's token-type gradient, 16384 rows
    of one id, the same in every process on the card), equals PyTorch's
    own in f32, and for bf16 weights the f32 sum rounded once."""
    from paddle_tpu_torch.nn import functional as PF

    g = torch.Generator().manual_seed(0)
    for vocab, shape in ((2, (8, 64)), (512, (4, 32)), (7, (3, 5))):
        ids = torch.randint(0, vocab, shape, generator=g)
        if vocab == 2:
            ids.zero_()                 # one id for every row
        up = torch.randn(*shape, 16, generator=g)
        w = torch.randn(vocab, 16, generator=g)
        want = torch.zeros(vocab, 16).index_add_(0, ids.reshape(-1),
                                                 up.reshape(-1, 16))
        for dtype in (torch.float32, torch.bfloat16):
            grads = []
            for _ in range(2):
                leaf = w.to(dtype, copy=True).requires_grad_()
                PF.embedding(ids, leaf).backward(up.to(dtype))
                grads.append(leaf.grad)
            assert grads[0].dtype == dtype
            assert torch.equal(grads[0], grads[1])
            if dtype == torch.float32:
                ref = w.detach().clone().requires_grad_()
                torch.nn.functional.embedding(ids, ref).backward(up)
                assert torch.equal(grads[0], ref.grad)
                assert torch.equal(grads[0], want)
            else:
                assert torch.equal(grads[0], torch.zeros(
                    vocab, 16).index_add_(0, ids.reshape(-1), up.to(
                        dtype).float().reshape(-1, 16)).to(dtype))


if __name__ == "__main__":
    sys.exit(_main())
