"""The port's data-parallel path held against the JAX package's, on the
CPU: the port's ranks are processes (`distributed.spawn`, gloo, a
`file://` store), the JAX package's are the shards of a `dp` mesh over
`jax.devices()[:W]` (the test platform has 8 CPU devices).

The rank functions below are module-level and import no JAX: a spawned
rank imports this file and nothing of `paddle_tpu`. JAX runs only in
the test functions, in the pytest process. Each spawn runs every case
of its group once (module-scoped fixtures), so the file starts three
process groups.

Tolerances, each with its reason:

  * `all_reduce_flat`, int8 and fp8, W 2 and 4: every element within
    one phase-2 scale of its block (max|block| / 127 for int8, / 448
    for fp8, of JAX's reduced output). JAX's compiled island contracts
    the phase-1 dequantize-and-sum into FMAs (and multiplies by
    f32(1/127) for the scale), the port rounds each step, so a reduced
    value can sit an ulp away and round to the neighbouring code. The
    share of bit-identical elements is asserted to stay above a floor
    (measured: int8 86% at W 2, 54% at W 4; fp8 34%, 23%). Under error
    feedback a flipped code changes the residual, so later repeats may
    differ by one code too, within the same bound.
  * fp32: summation order only (gloo's ring vs XLA's psum): 1e-6 x the
    largest |sum|.
  * the train step (2-layer f32 GPT, AdamW lr 1e-3, 2-4 optimizer
    steps): losses within 1e-5 relative (measured <= 3e-7); without
    quantization (None, "fp32") parameters within 1e-4 absolute,
    test_torch_train.py's f32 tolerance (measured 4.5e-5). Under int8:ef
    the same 1e-4 holds for all but one element in 1e4 (measured: none
    past 1.6e-5 in int8ef and 6.2e-6 in merge2_scaler; 3 of 79,360
    past 1e-4 in dispatch2). Those few are gradient elements one code
    away from JAX's (see above), whose Adam steps can move up to about
    2 lr: each is held within 2 lr (measured 3.2e-4). A wrong reduction
    moves far more elements than that. The comm/all_reduce counters and
    the residual's shape are exact.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import compress as comp
from paddle_tpu_torch.distributed import spawn

SPECS = ("int8:block=128", "int8:ef:block=128", "fp8:block=128", "fp32")
N_FLAT = 2048
REPEATS = 8
COMM_KEYS = ("comm/all_reduce/calls", "comm/all_reduce/bytes",
             "comm/all_reduce/wire_bytes")
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            ffn_hidden=128, max_seq_len=64, dropout=0.0)
LR = 1e-3
# name -> (comm_compress, TrainStepCompiler kwargs, calls); the batch of
# a call is B 4 x S 32 globally (2 x 32 a rank), K x that under
# steps_per_dispatch = K
TRAIN_CASES = {
    "none": (None, {}, 3),
    "fp32": ("fp32", {}, 3),
    "int8ef": ("int8:ef:block=128", {}, 3),
    "merge2_scaler": ("int8:ef:block=128", dict(accumulate_steps=2), 4),
    "dispatch2": ("int8:ef:block=128", dict(steps_per_dispatch=2), 2),
}


def _data(W):
    return np.random.RandomState(0).randn(W, N_FLAT).astype(np.float32)


def _poison_data(W):
    """_data with a NaN and an Inf in the last rank's contribution."""
    d = _data(W)
    d[-1, 3] = np.nan
    d[-1, 700] = np.inf
    return d


def _counters():
    return np.array([monitor.stat_get(k) for k in COMM_KEYS], np.int64)


# -- rank functions (spawned; no JAX) --------------------------------------
def _allreduce_rank(out_dir, W):
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce, get_rank

    r = get_rank()
    res = {}
    for spec in SPECS:
        cfg = comp.parse_spec(spec)
        x = torch.from_numpy(_data(W)[r].copy())
        resid = torch.zeros_like(x) if cfg.ef else None
        outs = []
        for _ in range(REPEATS):
            out, resid = comp.all_reduce_flat(x, group=None, cfg=cfg,
                                              residual=resid)
            outs.append(out.numpy())
        res[spec] = np.stack(outs)
        if cfg.ef:
            res[spec + "/residual_shape"] = np.array(resid.shape)
    # a NaN and an Inf in one rank's gradient, int8:ef, twice
    cfg = comp.parse_spec("int8:ef:block=128")
    x = torch.from_numpy(_poison_data(W)[r].copy())
    resid = torch.zeros_like(x)
    outs, bad = [], []
    for _ in range(2):
        out, resid = comp.all_reduce_flat(x, group=None, cfg=cfg,
                                          residual=resid)
        outs.append(out.numpy())
        bad.append(int((~torch.isfinite(resid)).sum()))
    res["poison/out"], res["poison/residual_nonfinite"] = np.stack(outs), bad
    # the per-call compress= path: 1000 elements (padded to 1024),
    # SUM and AVG quantized; MAX and an integer SUM on the plain wire
    v = np.random.RandomState(1 + r).randn(10, 100).astype(np.float32)
    before = _counters()
    t = torch.from_numpy(v.copy())
    all_reduce(t, compress="int8:block=128")
    res["call/int8"] = t.numpy()
    res["call/int8_counters"] = _counters() - before
    t = torch.from_numpy(v.copy())
    all_reduce(t, op=ReduceOp.AVG, compress="int8:block=128")
    res["call/int8_avg"] = t.numpy()
    t = torch.from_numpy(v.copy())
    before = _counters()
    all_reduce(t, op=ReduceOp.MAX, compress="int8:block=128")
    res["call/max"] = t.numpy()
    res["call/max_counters"] = _counters() - before
    ti = torch.arange(6, dtype=torch.int32) + r
    all_reduce(ti, compress="int8")
    res["call/int_sum"] = ti.numpy()
    # all_gather, broadcast, barrier and their counters
    from paddle_tpu_torch.distributed import all_gather, barrier, broadcast

    keys = ("comm/all_gather/bytes", "comm/broadcast/bytes",
            "comm/barrier/calls")
    before = [monitor.stat_get(k) for k in keys]
    parts = all_gather([], torch.full((3,), float(r)))
    res["call/all_gather"] = torch.stack(parts).numpy()
    b = torch.full((2,), float(r))
    res["call/broadcast"] = broadcast(b, src=W - 1).numpy()
    barrier()
    res["call/other_counters"] = np.array(
        [monitor.stat_get(k) - v for k, v in zip(keys, before)])
    res["jax_loaded"] = np.array(
        [m.split(".")[0] in ("jax", "paddle_tpu") for m in sys.modules])
    np.savez(os.path.join(out_dir, f"allreduce_r{r}.npz"), **res)


def _port_model(flat):
    """The port's 2-layer GPT with the weights of a flat numpy tree
    ("wte", "blocks.qkv_w", ...)."""
    from paddle_tpu_torch.convert import load_reference_params
    from paddle_tpu_torch.text.models import gpt as port_gpt

    tree = {"blocks": {}}
    for k, a in flat.items():
        if k.startswith("blocks."):
            tree["blocks"][k[len("blocks."):]] = a
        else:
            tree[k] = a
    m = port_gpt.GPTForCausalLM(port_gpt.GPTConfig(remat=False, **TINY),
                                device="cpu")
    return load_reference_params(m, tree)


def _batches(n, k=1, seed=5):
    rng = np.random.RandomState(seed)
    shape = (k, 4, 32) if k > 1 else (4, 32)
    return [(rng.randint(0, 128, shape).astype(np.int32),
             rng.randint(0, 128, shape).astype(np.int32)) for _ in range(n)]


def _train_rank(out_dir, tree_npz):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    r = get_rank()
    res = {}
    flat = dict(np.load(tree_npz))

    def build(spec, **kw):
        m = _port_model(flat)
        opt = AdamW(LR, parameters=m.named_parameters(), weight_decay=0.01)
        if spec is True:
            return m, DistributedTrainStepCompiler(m, opt, **kw)
        return m, DistributedTrainStepCompiler(m, opt, comm_compress=spec,
                                               **kw)

    for name, (spec, kw, calls) in TRAIN_CASES.items():
        kw = dict(kw)
        if name == "merge2_scaler":
            kw["grad_scaler"] = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                               incr_every_n_steps=2)
        m, step = build(spec, **kw)
        before = _counters()
        losses = [step(*b).numpy() for b in _batches(
            calls, kw.get("steps_per_dispatch", 1))]
        res[f"{name}/losses"] = np.array(losses)
        res[f"{name}/counters"] = _counters() - before
        res[f"{name}/residual_shape"] = np.array(
            [step._comm_state["residual"].numel()]
            if "residual" in step._comm_state else [])
        for n, p in m.gpt.named_parameters():
            res[f"{name}/param/{n}"] = p.detach().numpy()
    # PADDLE_COMM_COMPRESS drives a compiler built without the argument
    os.environ["PADDLE_COMM_COMPRESS"] = "int8:ef:block=128"
    m, step = build(True)
    res["env/losses"] = np.array([step(*b).numpy() for b in _batches(3)])
    res["env/residual_shape"] = np.array(
        [step._comm_state["residual"].numel()])
    # a parameter with a dist_spec: an env spec disables itself...
    m, step = build(True)
    m.gpt.wte.dist_spec = ("mp", None)
    step(*_batches(1)[0])
    res["env_bad_layout/disabled"] = np.array(
        [step._compress is None and step._comm_state == {}])
    del os.environ["PADDLE_COMM_COMPRESS"]
    # ...an explicit one raises, on every rank, before any collective
    m, step = build("int8:ef")
    m.gpt.wte.dist_spec = ("mp", None)
    try:
        step(*_batches(1)[0])
        res["explicit_bad_layout/raised"] = np.array([False])
    except ValueError as e:
        res["explicit_bad_layout/raised"] = np.array(["dist_spec" in str(e)])
    np.savez(os.path.join(out_dir, f"train_r{r}.npz"), **res)


def _failing_rank(out_dir):
    from paddle_tpu_torch.distributed import barrier, get_rank

    if get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    barrier()        # rank 0 waits here for a peer that never comes


def _spawn(fn, args, W, tmp):
    spawn(fn, args=args, nprocs=W, device="cpu",
          init_method=f"file://{tmp}/store_{fn.__name__}_{W}",
          join=False).join(timeout=240)


def _load(tmp, stem, W):
    return [dict(np.load(os.path.join(tmp, f"{stem}_r{r}.npz")))
            for r in range(W)]


# -- the allreduce ---------------------------------------------------------
@pytest.fixture(scope="module")
def allreduce_runs(tmp_path_factory):
    out = {}
    for W in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"allreduce{W}"))
        _spawn(_allreduce_rank, (tmp, W), W, tmp)
        out[W] = _load(tmp, "allreduce", W)
    return out


def _jax_mesh(W, axis="dp"):
    import jax

    from paddle_tpu.distributed import build_mesh

    return build_mesh({axis: W}, devices=jax.devices()[:W])


def _jax_all_reduce_flat(W, spec):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_tpu.distributed import compress as jcomp
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh, cfg = _jax_mesh(W), jcomp.parse_spec(spec)
    sh = NamedSharding(mesh, P("dp"))
    g = jax.device_put(_data(W), sh)
    res = jax.device_put(np.zeros((W, N_FLAT), np.float32), sh)

    def island(x, r):
        out, nr = jcomp.all_reduce_flat(
            x[0], "dp", W, cfg, residual=(r[0] if cfg.ef else None))
        return out, (nr[None] if nr is not None else r)

    f = jax.jit(mesh_mod.shard_map_compat(
        island, mesh, (P("dp"), P("dp")), (P(), P("dp"))))
    outs = []
    for _ in range(REPEATS):
        out, res = f(g, res)
        outs.append(np.asarray(out))
    return np.stack(outs)


# bit-identical share floors (measured 0.86 / 0.54 int8, 0.34 / 0.23 fp8
# on the first repeat)
SHARE_FLOOR = {"int8": 0.4, "fp8": 0.15}


def _within_one_scale(got, want, block, qmax):
    """Every element within one phase-2 scale of its block of `want`."""
    w = want.reshape(-1, block)
    scale = np.abs(w).max(axis=1, keepdims=True) / qmax
    err = np.abs(got.reshape(-1, block) - w)
    assert (err <= scale * (1 + 1e-6)).all(), float((err / scale).max())


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("W", [2, 4])
def test_all_reduce_flat_matches_jax(allreduce_runs, W, spec):
    want = _jax_all_reduce_flat(W, spec)
    runs = allreduce_runs[W]
    assert not any(r["jax_loaded"].any() for r in runs)   # ranks: no JAX
    for r in range(1, W):          # every rank rebuilt the same vector
        np.testing.assert_array_equal(runs[r][spec], runs[0][spec])
    got = runs[0][spec]
    cfg = comp.parse_spec(spec)
    if cfg.mode == "fp32":
        tol = 1e-6 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        return
    if cfg.ef:
        np.testing.assert_array_equal(runs[0][spec + "/residual_shape"],
                                      [N_FLAT])
    qmax = 127.0 if cfg.mode == "int8" else 448.0
    for i in range(REPEATS):
        _within_one_scale(got[i], want[i], 128, qmax)
    assert (got[0] == want[0]).mean() >= SHARE_FLOOR[cfg.mode]
    # the sum it approximates
    true = _data(W).sum(0)
    assert np.abs(got[0] - true).max() <= 0.05 * np.abs(true).max()


@pytest.mark.parametrize("W", [2, 4])
def test_error_feedback_debiases_repeated_reduce(allreduce_runs, W):
    """Reducing the same payload repeatedly, the mean of the EF outputs
    converges to the true sum, while without EF the same biased output
    repeats (tests/test_comm_compress.py:202)."""
    true = _data(W).sum(0)
    plain = allreduce_runs[W][0]["int8:block=128"]
    ef = allreduce_runs[W][0]["int8:ef:block=128"]
    assert np.array_equal(plain[0], plain[-1])
    err_plain = np.abs(plain.mean(0) - true).max()
    err_ef = np.abs(ef.mean(0) - true).max()
    assert err_ef < 0.25 * err_plain, (err_ef, err_plain)


@pytest.mark.parametrize("W", [2, 4])
def test_nonfinite_gradient_comes_out_finite_and_poisons_the_residual(
        allreduce_runs, W):
    """A NaN and an Inf in one rank's contribution, int8:ef, in both
    packages: phase 1 turns the Inf's block into NaN (scale inf, 0 *
    inf), phase 2 requantizes a NaN block to scale 1 and codes 0, so the
    reduced gradient is FINITE, with zeros where the blocks were: a
    non-finite guard that reads it never trips. The residual keeps the
    non-finite values, and the next call zeroes those blocks again."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_tpu.distributed import compress as jcomp
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh, cfg = _jax_mesh(W), jcomp.parse_spec("int8:ef:block=128")
    sh = NamedSharding(mesh, P("dp"))
    g = jax.device_put(_poison_data(W), sh)
    res = jax.device_put(np.zeros((W, N_FLAT), np.float32), sh)

    def island(x, r):
        out, nr = jcomp.all_reduce_flat(x[0], "dp", W, cfg, residual=r[0])
        return out, nr[None]

    f = jax.jit(mesh_mod.shard_map_compat(
        island, mesh, (P("dp"), P("dp")), (P(), P("dp"))))
    want, bad = [], []
    for _ in range(2):
        out, res = f(g, res)
        want.append(np.asarray(out))
        bad.append(int((~np.isfinite(np.asarray(res))).sum()))
    runs = allreduce_runs[W]
    got = runs[0]["poison/out"]
    for i in range(2):
        assert np.isfinite(want[i]).all() and np.isfinite(got[i]).all()
        np.testing.assert_array_equal(got[i] == 0, want[i] == 0)
        _within_one_scale(got[i], want[i], 128, 127.0)
    assert (got[0] == 0).sum() >= 128          # the Inf's whole block
    port_bad = np.sum([r["poison/residual_nonfinite"] for r in runs], 0)
    np.testing.assert_array_equal(port_bad, bad)
    assert bad[1] >= bad[0] > 0


def test_all_reduce_compress_matches_jax(allreduce_runs):
    """`all_reduce(compress=)` at W 2 against the JAX package's in-trace
    `all_reduce(compress=)`: the quantized SUM and AVG within one phase-2
    scale, the same wire bytes; MAX and an integer SUM take the plain
    wire (wire_bytes == bytes)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_tpu.core import monitor as jmon
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed import collective as JC
    from paddle_tpu.distributed import mesh as mesh_mod
    from paddle_tpu.distributed import set_mesh

    W = 2
    runs = allreduce_runs[W]
    v = np.stack([np.random.RandomState(1 + r).randn(10, 100)
                  .astype(np.float32) for r in range(W)])
    mesh = _jax_mesh(W)
    prev = mesh_mod.get_mesh()
    set_mesh(mesh)
    try:
        def island(x):
            t = Tensor(x[0], _internal=True)
            JC.all_reduce(t, compress="int8:block=128")
            return t._value

        before = jmon.stat_get("comm/all_reduce/wire_bytes")
        want = np.asarray(jax.jit(mesh_mod.shard_map_compat(
            island, mesh, (P("dp"),), P()))(
                jax.device_put(v, NamedSharding(mesh, P("dp")))))
        jwire = jmon.stat_get("comm/all_reduce/wire_bytes") - before
    finally:
        set_mesh(prev)
    got = runs[0]["call/int8"]
    np.testing.assert_array_equal(runs[1]["call/int8"], got)
    flat = np.zeros(1024, np.float32)
    flat[:1000] = want.reshape(-1)
    g = np.zeros(1024, np.float32)
    g[:1000] = got.reshape(-1)
    _within_one_scale(g, flat, 128, 127.0)
    calls, nbytes, wire = runs[0]["call/int8_counters"]
    assert (calls, nbytes, wire) == (1, 4000, jwire) and wire == 1024 + 64
    # AVG is the SUM divided by W (a true division; exact for W = 2)
    np.testing.assert_array_equal(runs[0]["call/int8_avg"], got / 2)
    np.testing.assert_array_equal(runs[0]["call/max"], v.max(0))
    calls, nbytes, wire = runs[0]["call/max_counters"]
    assert (calls, nbytes, wire) == (1, 4000, 4000)
    np.testing.assert_array_equal(runs[0]["call/int_sum"],
                                  2 * np.arange(6) + 1)


@pytest.mark.parametrize("W", [2, 4])
def test_all_gather_broadcast_barrier(allreduce_runs, W):
    for r in allreduce_runs[W]:
        np.testing.assert_array_equal(
            r["call/all_gather"], np.repeat(np.arange(W, dtype=np.float32)
                                            [:, None], 3, 1))
        np.testing.assert_array_equal(r["call/broadcast"], [W - 1] * 2)
        # all_gather counts the whole gathered list (W x 12 B)
        np.testing.assert_array_equal(r["call/other_counters"],
                                      [12 * W, 8, 1])


# -- the train step --------------------------------------------------------
def _jax_models():
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.inference.serving.model_runner import extract_params
    from paddle_tpu.text.models import gpt as jax_gpt

    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(
        use_flash_attention=False, remat=False, **TINY))
    params, _ = extract_params(jm)
    tree = jax.tree_util.tree_map(np.asarray, params)
    flat = {}
    for k, v in tree.items():
        if k == "blocks":
            flat.update({f"blocks.{n}": a for n, a in v.items()})
        else:
            flat[k] = v
    return jm, flat


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train"))
    _, flat = _jax_models()
    tree_npz = os.path.join(tmp, "tree.npz")
    np.savez(tree_npz, **flat)
    _spawn(_train_rank, (tmp, tree_npz), 2, tmp)
    return _load(tmp, "train", 2)


def _jax_train(name):
    import jax

    from jax.sharding import PartitionSpec as P

    import paddle_tpu as paddle
    import paddle_tpu.amp as jax_amp
    import paddle_tpu.optimizer as jax_optim
    from paddle_tpu.core import monitor as jmon
    from paddle_tpu.distributed import mesh as mesh_mod
    from paddle_tpu.inference.serving.model_runner import extract_params
    from paddle_tpu.jit.distributed import DistributedTrainStepCompiler

    spec, kw, calls = TRAIN_CASES[name]
    kw = dict(kw)
    if name == "merge2_scaler":
        kw["grad_scaler"] = jax_amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                               incr_every_n_steps=2)
    jm, _ = _jax_models()
    # JAX's GPT tags some weights with model-parallel specs (wte:
    # ('mp', None)), which its compressed step refuses as a hybrid
    # layout even on a dp-only mesh: the pure data-parallel layout the
    # port runs is every parameter replicated
    for p in jm.parameters():
        p.dist_spec = None
    opt = jax_optim.AdamW(LR, parameters=jm.parameters(), weight_decay=0.01)
    # the data axis is not called "dp": JAX's GPT constrains its
    # activations to "dp", which the compressed step's shard_map island
    # (manual over the data axis) refuses
    mesh = _jax_mesh(2, "data")
    prev = mesh_mod.get_mesh()
    keys = COMM_KEYS
    before = np.array([jmon.stat_get(k) for k in keys], np.int64)
    try:
        step = DistributedTrainStepCompiler(
            jm, opt, mesh=mesh, batch_specs=[P("data"), P("data")],
            comm_compress=spec, **kw)
        losses = [np.asarray(step(*map(paddle.to_tensor, b))._value)
                  for b in _batches(calls, kw.get("steps_per_dispatch", 1))]
    finally:
        mesh_mod.set_mesh(prev)
    counters = np.array([jmon.stat_get(k) for k in keys], np.int64) - before
    res = step._comm_state.get("residual") if step._comm_state else None
    params, _ = extract_params(jm)
    flat = {}
    for k, v in jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), params).items():
        if k == "blocks":
            flat.update({f"blocks.{n}": a for n, a in v.items()})
        else:
            flat[k] = v
    return np.array(losses), counters, res, flat


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_step_matches_jax(train_runs, name):
    spec, kw, calls = TRAIN_CASES[name]
    r0, r1 = train_runs
    losses, counters, res, params = _jax_train(name)
    quantized = spec is not None and "int8" in spec
    steps = calls * kw.get("steps_per_dispatch", 1)
    got = r0[f"{name}/losses"]
    assert got.shape == losses.shape
    np.testing.assert_array_equal(r1[f"{name}/losses"], got)   # pmean
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    far, total = 0, 0
    for n, want in params.items():
        p0 = r0[f"{name}/param/{n}"]
        np.testing.assert_array_equal(r1[f"{name}/param/{n}"], p0)
        d = np.abs(p0 - want)
        if quantized:
            # a code flip moves one element's Adam steps by up to ~2 lr
            np.testing.assert_array_less(d, 2 * LR, err_msg=n)
            far += int((d > 1e-4).sum())
            total += d.size
        else:
            np.testing.assert_allclose(p0, want, rtol=0, atol=1e-4,
                                       err_msg=n)
    # the flipped codes are a few elements in 1e4; the rest hold the
    # f32 tolerance
    assert far <= 1e-4 * total, (far, total)
    # the JAX package prices a program build once; the port a microstep
    if spec is None:
        assert not counters.any() and not r0[f"{name}/counters"].any()
    else:
        per = r0[f"{name}/counters"] // steps
        np.testing.assert_array_equal(per * steps, r0[f"{name}/counters"])
        np.testing.assert_array_equal(per, counters)
    if res is not None:
        assert res.shape == (2,) + tuple(r0[f"{name}/residual_shape"])
    else:
        assert r0[f"{name}/residual_shape"].size == 0


def test_int8_ef_wire_is_under_three_tenths_of_fp32(train_runs):
    r0 = train_runs[0]
    calls_i, bytes_i, wire_i = r0["int8ef/counters"]
    calls_f, bytes_f, wire_f = r0["fp32/counters"]
    assert calls_i == calls_f == 3 and bytes_i == bytes_f == wire_f
    assert wire_i / wire_f <= 0.3, wire_i / wire_f
    l_f, l_i = r0["fp32/losses"], r0["int8ef/losses"]
    assert np.all(np.abs(l_f - l_i) <= 2e-2 * np.maximum(1.0, np.abs(l_f)))
    assert l_i[-1] < l_i[0] and l_f[-1] < l_f[0]


def test_env_spec_drives_a_compiler_built_without_the_argument(train_runs):
    r0 = train_runs[0]
    np.testing.assert_array_equal(r0["env/losses"], r0["int8ef/losses"])
    np.testing.assert_array_equal(r0["env/residual_shape"],
                                  r0["int8ef/residual_shape"])


def test_bad_layout_raises_for_explicit_spec_and_disables_env(train_runs):
    for r in train_runs:
        assert r["env_bad_layout/disabled"].all()
        assert r["explicit_bad_layout/raised"].all()


def test_one_rank_disables_compression(monkeypatch):
    """W = 1 (no process group): compression is off, the batch is not
    split, and the step equals the base TrainStepCompiler's."""
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    monkeypatch.delenv("PADDLE_COMM_COMPRESS", raising=False)
    _, flat = _jax_models()
    losses = []
    for cls, kw in ((DistributedTrainStepCompiler,
                     dict(comm_compress="int8:ef")), (TrainStepCompiler, {})):
        m = _port_model(flat)
        opt = AdamW(LR, parameters=m.named_parameters(), weight_decay=0.01)
        step = cls(m, opt, **kw)
        before = _counters()
        losses.append([float(step(*b)) for b in _batches(2)])
        assert not (_counters() - before).any()
        if cls is DistributedTrainStepCompiler:
            assert step._compress is None and step._comm_state == {}
    assert losses[0] == losses[1]


def test_a_failing_rank_stops_the_others_and_raises(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exit codes"):
        _spawn(_failing_rank, (str(tmp_path),), 2, str(tmp_path))
    assert time.perf_counter() - t0 < 120
