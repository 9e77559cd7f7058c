"""The port's ERNIE (BASELINE config 5) held against the JAX package's,
on the CPU, at a small size: vocab 128, hidden 32, 4 layers, 4 heads,
ffn 64, S 16, B 4, f32, dropout 0. The same numpy weights (the JAX
model's, carried by `convert`) and batches go through both packages.

  * mp 1, one process: the loss within 1e-5 relative and every
    gradient within 1e-4 x its max|g| (summation order only); two AdamW
    steps through `DistributedTrainStepCompiler(mesh=)` on {"dp": 1,
    "pp": 1, "mp": 1} against JAX's on the same mesh; two
    `PipelineParallel.train_batch` calls with `accumulate_steps` 4
    against JAX's micro-batch path; O2's parameter and activation
    dtypes (the LayerNorm scales stay f32 and promote the residual
    stream to f32 on both sides).
  * mp 2, two gloo ranks on the CPU (`distributed.spawn(device="cpu")`,
    a `file://` store), each `fleet.init` with mp_degree 2, against
    JAX's ERNIE on a {"dp": 1, "pp": 1, "mp": 2} mesh over
    `jax.devices()[:2]`: two AdamW steps (lr 1e-3, weight decay 0.01),
    the losses within 1e-5 relative and the parameters gathered from
    the two ranks within 1e-5 of JAX's. The exception, held within
    lr x steps: the key bias, whose true gradient is 0 (a bias on k
    adds one constant to a softmax row), so Adam turns the rounding
    noise of its gradient into steps of up to lr in either package.
    ClipGradByGlobalNorm(0.05), whose norm sums the shards' squares over
    the mp group, is held under SGD(0.1) (Adam's update is nearly blind
    to a uniform scale of the gradients): the same tolerances, and the
    clip is shown active (JAX's unclipped SGD run ends elsewhere). Negative controls: a contiguous cut of the qkv weight (rank
    0 would hold all of q and half of k) and a step that reduces over
    the world instead of the mesh's dp group each break the loss parity
    by far more than the tolerance.

The rank functions are module-level and import no JAX: a spawned rank
imports this file and nothing of `paddle_tpu`.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
           ffn_hidden=64, max_seq_len=16, dropout=0.0)
B, S = 4, 16
LR, WD = 1e-3, 0.01
STEPS = 2
CLIP = 0.05
SGD_LR = 0.1
F32_REL = 1e-5
F32_GRAD = 1e-4
PARAM_TOL = 1e-5


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (B, S)).astype(np.int64),
            rng.randint(0, 128, (B, S)).astype(np.int64))


def _port_cfg():
    from paddle_tpu_torch.text.models.ernie import ErnieConfig

    return ErnieConfig(**CFG)


def _port_model(flat=None, mp_group=None):
    """The port's ERNIE on the CPU, with the full weights `flat` (cut to
    this rank's shards at mp > 1) when given."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.text.models.ernie import ErnieForPretraining

    m = ErnieForPretraining(_port_cfg(), device="cpu", mp_group=mp_group)
    if flat is not None:
        convert.load_sharded_state_dict(m, flat)
    return m


def _key_bias(name, arr):
    """The k third of a qkv bias (full layout): True where the entry is
    a key bias."""
    mask = np.zeros(arr.shape, bool)
    if name.endswith("qkv.bias"):
        h = arr.shape[0] // 3
        mask[h:2 * h] = True
    return mask


# -- rank functions (spawned; no JAX) --------------------------------------
def _mp_rank(out_dir, flat_npz):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet, get_rank, mesh
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW

    r = get_rank()
    flat = dict(np.load(flat_npz))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    res = {"mode": np.array(hcg.get_parallel_mode()),
           "mp_rank": np.array(hcg.get_model_parallel_rank()),
           "mesh": np.array(list(mesh.get_mesh().shape.values()))}
    ids, labels = _batch()

    def run(tag, model, clip=None, **kw):
        if clip is None:
            opt = AdamW(LR, parameters=model.named_parameters(),
                        weight_decay=WD)
        else:
            opt = SGD(SGD_LR, parameters=model.named_parameters(),
                      grad_clip=clip)
        if "group" not in kw:
            kw["mesh"] = mesh.get_mesh()
        step = DistributedTrainStepCompiler(model, opt, **kw)
        res[f"{tag}/losses"] = np.array(
            [float(step(ids, labels)) for _ in range(STEPS)])
        for n, t in convert.gather_state_dict(model).items():
            res[f"{tag}/param/{n}"] = t.numpy()

    model = _port_model(flat)
    res["n_head"] = np.array(model.ernie._layers[1].n_head)
    res["qkv_shape"] = np.array(model.ernie._layers[1].qkv.weight.shape)
    run("mp2", model)
    run("mp2_clip", _port_model(flat), clip=ClipGradByGlobalNorm(CLIP))
    # negative control: the qkv weight and bias cut contiguously
    bad = _port_model(flat)
    with torch.no_grad():
        for name, p in bad.named_parameters():
            if "qkv" in name:
                p.copy_(torch.from_numpy(mp_layers.shard(
                    flat[name], p.mp_split[0], 1, 2, r)))
    run("contiguous_qkv", bad)
    # negative control: the step reduces over the world, not the dp group
    run("world_group", _port_model(flat), group=None)
    # TensorParallel makes the replicated parameters agree: rank 1's
    # perturbed LayerNorm scale becomes rank 0's
    wrapped = _port_model(flat)
    ln = wrapped.ernie._layers[1].ln1.weight
    with torch.no_grad():
        ln.add_(float(r))
    tp = fleet.distributed_model(wrapped)
    res["wrapper"] = np.array(type(tp).__name__)
    res["ln_after_wrap"] = ln.detach().numpy().copy()
    # built from one seed, the mp 2 model is the seed's logical model
    seeded = _port_model()
    for n, t in convert.gather_state_dict(seeded).items():
        res[f"seeded/param/{n}"] = t.numpy()
    # any tensors laid out as the parameters (an optimizer's master
    # weights, say) gather the same way
    negated = {n: -p for n, p in seeded.named_parameters()}
    for n, t in convert.gather_state_dict(seeded, negated).items():
        res[f"negated/param/{n}"] = t.numpy()
    np.savez(os.path.join(out_dir, f"mp_r{r}.npz"), **res)


def _spawn(fn, args, W, tmp):
    spawn(fn, args=args, nprocs=W, device="cpu",
          init_method=f"file://{tmp}/store_{fn.__name__}_{W}",
          join=False).join(timeout=300)


# -- the JAX side ------------------------------------------------------------
def _jax_model(o2=False):
    import paddle_tpu as paddle
    from paddle_tpu import amp as jamp
    from paddle_tpu.text.models import ernie as jernie

    paddle.seed(0)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**CFG))
    if o2:
        jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
    return jm


def _flat(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _jax_loss_grads(jm, ids, labels):
    import paddle_tpu as paddle

    for p in jm.parameters():
        p.clear_grad()
    loss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    loss.backward()
    return float(np.asarray(loss._value)), {
        n: np.asarray(p.grad._value, np.float32)
        for n, p in jm.named_parameters()}


_JAX_RUNS = {}


def _jax_train(mp, clip=None, sgd=None):
    """JAX's ERNIE, two AdamW steps (SGD(0.1) under a clip, or with
    `sgd`) through its compiled step on a {"dp": 1, "pp": 1, "mp": mp}
    mesh: (losses, {name: f32 params}); each configuration runs once a
    module."""
    sgd = clip is not None if sgd is None else sgd
    if (mp, clip, sgd) not in _JAX_RUNS:
        _JAX_RUNS[mp, clip, sgd] = _jax_train_once(mp, clip, sgd)
    return _JAX_RUNS[mp, clip, sgd]


def _jax_train_once(mp, clip, sgd):
    import jax

    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as joptim
    from paddle_tpu.distributed import build_mesh, mesh as mesh_mod
    from paddle_tpu.jit.distributed import DistributedTrainStepCompiler

    jm = _jax_model()
    clip = None if clip is None else jnn.ClipGradByGlobalNorm(clip)
    if sgd:
        opt = joptim.SGD(SGD_LR, parameters=jm.parameters(), grad_clip=clip)
    else:
        opt = joptim.AdamW(LR, parameters=jm.parameters(), weight_decay=WD,
                           grad_clip=clip)
    mesh = build_mesh({"dp": 1, "pp": 1, "mp": mp}, jax.devices()[:mp])
    prev = mesh_mod.get_mesh()
    try:
        step = DistributedTrainStepCompiler(jm, opt, loss_fn=None,
                                            mesh=mesh)
        ids, labels = _batch()
        losses = [float(np.asarray(step(paddle.to_tensor(ids),
                                        paddle.to_tensor(labels))._value))
                  for _ in range(STEPS)]
    finally:
        mesh_mod.set_mesh(prev)
    return np.array(losses), {k: np.asarray(v, np.float32)
                              for k, v in _flat(jm).items()}


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


def _params_close(got, want, tol=PARAM_TOL):
    """Every parameter within `tol`, the key bias within lr x steps."""
    assert set(got) == set(want)
    for n, w in want.items():
        g = np.asarray(got[n], np.float32)
        assert g.shape == w.shape, n
        kb = _key_bias(n, w)
        err = np.abs(g - w)
        assert float(err[~kb].max(initial=0.0)) <= tol, (n, err.max())
        assert float(err[kb].max(initial=0.0)) <= LR * STEPS, n


@pytest.fixture(scope="module")
def jax_ernie():
    jm = _jax_model()
    return jm, _flat(jm)


@pytest.fixture(scope="module")
def mp_runs(tmp_path_factory, jax_ernie):
    tmp = str(tmp_path_factory.mktemp("ernie_mp"))
    flat_npz = os.path.join(tmp, "flat.npz")
    np.savez(flat_npz, **jax_ernie[1])
    _spawn(_mp_rank, (tmp, flat_npz), 2, tmp)
    return [dict(np.load(os.path.join(tmp, f"mp_r{r}.npz")))
            for r in range(2)]


def _run(res, tag):
    return res[f"{tag}/losses"], {k[len(tag) + 7:]: v for k, v in res.items()
                                  if k.startswith(f"{tag}/param/")}


# -- mp 1 -----------------------------------------------------------------
def test_parameter_names_shapes_and_specs_match_jax(jax_ernie):
    jm, flat = jax_ernie
    pm = _port_model(flat)
    own = dict(pm.named_parameters())
    assert set(own) == set(flat) and len(own) == 4 + 12 * CFG[
        "num_layers"] + 4
    for n, p in jm.named_parameters():
        assert tuple(own[n].shape) == tuple(flat[n].shape), n
        spec = getattr(p, "dist_spec", None)
        assert getattr(own[n], "dist_spec", None) == (
            None if spec is None else tuple(spec)), n
        assert getattr(own[n], "pp_stage", None) == p.pp_stage, n
        np.testing.assert_array_equal(own[n].detach().numpy(), flat[n])


def test_loss_and_every_gradient_match_jax(jax_ernie):
    jm, flat = jax_ernie
    pm = _port_model(flat)
    for seed in (0, 1):
        ids, labels = _batch(seed)
        lj, gj = _jax_loss_grads(jm, ids, labels)
        named = list(pm.named_parameters())
        loss = pm(ids, labels)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        lp = float(loss.detach())
        assert abs(lp - lj) <= F32_REL * abs(lj), (lp, lj)
        for (n, _), g in zip(named, grads):
            _close(g.numpy(), gj[n], F32_GRAD, n)


def test_logits_match_jax_without_labels(jax_ernie):
    import paddle_tpu as paddle

    jm, flat = jax_ernie
    ids, _ = _batch(2)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    got = _port_model(flat)(ids)
    assert tuple(got.shape) == (B, S, CFG["vocab_size"])
    _close(got.detach().numpy(), want, F32_REL, "logits")


def test_o2_keeps_jax_dtypes():
    """amp.decorate O2 on both: the same parameters bf16 (the LayerNorm
    scales and shifts stay f32), and every stage's output f32, because
    the embedding LayerNorm's f32 scale promotes the bf16 embedding sum;
    the losses within 1e-3 relative."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import amp

    jm = _jax_model(o2=True)
    flat = _flat(jm)
    pm = amp.decorate(_port_model({k: np.asarray(v, np.float32)
                                   for k, v in flat.items()}),
                      level="O2", dtype="bfloat16")
    for n, p in pm.named_parameters():
        want = "bfloat16" if flat[n].dtype.name == "bfloat16" else "float32"
        assert str(p.dtype) == f"torch.{want}", n
        if want == "bfloat16":
            np.testing.assert_array_equal(
                p.detach().view(torch.int16).numpy(),
                flat[n].view(np.int16), err_msg=n)
    ids, labels = _batch()
    x_j, x_p = paddle.to_tensor(ids), torch.from_numpy(ids)
    for (lj, _, _), (lp, _, _) in zip(jm.ernie.run_function,
                                      pm.ernie.run_function):
        x_j, x_p = lj(x_j), lp(x_p)
        assert str(x_j.dtype) == "float32" and x_p.dtype == torch.float32
    lj = float(np.asarray(jm(paddle.to_tensor(ids),
                             paddle.to_tensor(labels))._value))
    lp = float(pm(ids, labels).detach())
    assert abs(lp - lj) <= 1e-3 * abs(lj), (lp, lj)


def test_two_steps_through_the_mesh_compiler_match_jax(jax_ernie):
    from paddle_tpu_torch.distributed import build_mesh, get_mesh, set_mesh
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    jl, jp = _jax_train(1)
    pm = _port_model(jax_ernie[1])
    opt = AdamW(LR, parameters=pm.named_parameters(), weight_decay=WD)
    mesh = build_mesh({"dp": 1, "pp": 1, "mp": -1})
    assert mesh.shape == {"dp": 1, "pp": 1, "mp": 1}
    try:
        step = DistributedTrainStepCompiler(pm, opt, mesh=mesh)
        assert get_mesh() is mesh
        ids, labels = _batch()
        losses = [float(step(ids, labels)) for _ in range(STEPS)]
    finally:
        set_mesh(None)
    np.testing.assert_allclose(losses, jl, rtol=F32_REL)
    assert losses[1] < losses[0]
    _params_close({n: p.detach().numpy() for n, p in pm.named_parameters()},
                  jp)


def test_pipeline_parallel_train_batch_matches_jax(jax_ernie):
    """`accumulate_steps` 4: B 4 cut into 4 micro-batches of 1, the
    gradients of loss / 4 summed, then one AdamW step; two calls."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as jfleet
    import paddle_tpu.optimizer as joptim

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    jm = _jax_model()
    js = jfleet.DistributedStrategy()
    js.pipeline_configs = {"accumulate_steps": 4}
    jpp = jfleet.meta_parallel.PipelineParallel(jm.ernie, None, js)
    jopt = joptim.AdamW(LR, parameters=jm.parameters(), weight_decay=WD)
    pm = _port_model(jax_ernie[1])
    ps = fleet.DistributedStrategy()
    ps.pipeline_configs = {"accumulate_steps": 4}
    ppp = fleet.meta_parallel.PipelineParallel(pm.ernie, None, ps)
    popt = AdamW(LR, parameters=pm.named_parameters(), weight_decay=WD)
    for seed in (0, 1):
        ids, labels = _batch(seed)
        lj = float(np.asarray(jpp.train_batch(
            (paddle.to_tensor(ids), paddle.to_tensor(labels)),
            jopt)._value))
        lp = ppp.train_batch((ids, labels), popt)
        assert lp.dtype == torch.float32 and lp.dim() == 0
        assert abs(float(lp) - lj) <= F32_REL * abs(lj), (float(lp), lj)
    _params_close({n: p.detach().numpy() for n, p in pm.named_parameters()},
                  {k: np.asarray(v, np.float32) for k, v in _flat(jm).items()})
    ev = ppp.eval_batch((ids, labels))
    want = np.asarray(jpp.eval_batch((paddle.to_tensor(ids),
                                      paddle.to_tensor(labels)))._value)
    _close(ev.numpy(), want, F32_REL, "eval_batch")


# -- mp 2 over two gloo ranks ---------------------------------------------
def test_mp2_ranks_see_the_hybrid_layout(mp_runs, jax_ernie):
    want = jax_ernie[1]["ernie._layers.1.ln1.weight"]
    for r, res in enumerate(mp_runs):
        assert str(res["wrapper"]) == "TensorParallel"
        np.testing.assert_array_equal(res["ln_after_wrap"], want)
        assert str(res["mode"]) == "tensor_parallel"
        assert int(res["mp_rank"]) == r
        assert res["mesh"].tolist() == [1, 1, 1, 2, 1]
        assert int(res["n_head"]) == CFG["num_heads"] // 2
        assert res["qkv_shape"].tolist() == [32, 48]


@pytest.mark.parametrize("clip", [None, CLIP])
def test_mp2_training_matches_jax(mp_runs, clip):
    """JAX's ERNIE on a {"dp": 1, "pp": 1, "mp": 2} mesh against the two
    ranks: losses, and every parameter gathered from the ranks."""
    tag = "mp2" if clip is None else "mp2_clip"
    jl, jp = _jax_train(2, clip)
    for res in mp_runs:
        losses, params = _run(res, tag)
        np.testing.assert_allclose(losses, jl, rtol=F32_REL)
        _params_close(params, jp)
    if clip is not None:
        unclipped, _ = _jax_train(2, sgd=True)
        assert abs(unclipped[1] - jl[1]) > 1e-3   # the clip was active


def test_mp2_matches_mp1(mp_runs):
    """JAX's mp 1 step is the same mathematics as its mp 2 step."""
    jl, jp = _jax_train(1)
    losses, params = _run(mp_runs[0], "mp2")
    np.testing.assert_allclose(losses, jl, rtol=F32_REL)
    _params_close(params, jp)


def test_mp2_model_from_a_seed_is_the_seeds_logical_model(mp_runs):
    full = {n: p.detach().numpy() for n, p in _port_model().named_parameters()}
    for res in mp_runs:
        got = {k[len("seeded/param/"):]: v for k, v in res.items()
               if k.startswith("seeded/param/")}
        assert set(got) == set(full)
        for n, v in full.items():
            np.testing.assert_array_equal(got[n], v, err_msg=n)


def test_mp2_gather_takes_tensors_laid_out_as_the_parameters(mp_runs):
    for res in mp_runs:
        got = {k[len("negated/param/"):]: v for k, v in res.items()
               if k.startswith("negated/param/")}
        assert got and set(got) == {k[len("seeded/param/"):] for k in res
                                    if k.startswith("seeded/param/")}
        for n, v in got.items():
            np.testing.assert_array_equal(v, -res[f"seeded/param/{n}"],
                                          err_msg=n)


@pytest.mark.parametrize("tag", ["contiguous_qkv", "world_group"])
def test_mp2_negative_controls_break_parity(mp_runs, tag):
    jl, _ = _jax_train(2)
    worst = max(float(np.max(np.abs(_run(res, tag)[0] - jl) / np.abs(jl)))
                for res in mp_runs)
    assert worst > 100 * F32_REL, (tag, worst)
