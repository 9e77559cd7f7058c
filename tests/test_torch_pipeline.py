"""The port's pipeline parallelism over processes (pp > 1) held against
the JAX package's pipelined paths, on the CPU.

  * `collective.send` / `recv` / `isend` / `irecv` between two gloo
    ranks: f32, bf16 and int64 tensors of several shapes both ways,
    several sends in flight arriving in order, the comm/send and
    comm/recv counters; in one process they raise.
  * `microbatch` / `unmicrobatch` equal JAX's, its error included.
  * The schedules against autodiff: a stack of tanh(x @ W + b) stages
    (JAX's `test_1f1b_gradients_match_autodiff_exactly`) at S 2 and 4
    over S ranks, M 4: every stage's parameter gradients and stage 0's
    input gradient within 1e-5 relative of `jax.grad` through JAX's
    `gpipe_loop`; GPipe and 1F1B equal bit for bit; 1F1B's stash on
    stage 0 at most S micro-batches, GPipe's M.
  * ERNIE (tests/test_torch_ernie.py's config, B 8) through
    `PipelineParallel.train_batch` (`accumulate_steps` 4, two steps)
    against JAX's on a pp mesh of CPU devices: at pp 2 ("F-then-B" and
    "1F1B", AdamW), at dp 2 x pp 2 (AdamW) and at mp 2 x pp 2
    (SGD(0.1) under ClipGradByGlobalNorm(0.05), shown active): losses
    within 1e-5 relative, every parameter gathered from the ranks within
    1e-5 (the key bias, whose true gradient is 0, within lr x steps);
    the two schedules bit for bit; `eval_batch`; each rank's parameter
    names the exact subset of JAX's for its stage.
  * ERNIE at pp 2 equal, bit for bit, to the port's own pp 1
    micro-batch path from the same weights (the same arithmetic).
  * Negative controls, each breaking parity: a schedule that drops the
    last micro-batch's backward, a clip that omits the pp group.

GPT's pp stages, the GradScaler's joint skip and the tied `wte`'s
negative control are in tests/test_torch_pipeline_gpt.py.

The rank functions are module-level and import no JAX: a spawned rank
imports this file and nothing of `paddle_tpu`. Each rank count is one
module-scoped spawn that runs every configuration of that count.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
           ffn_hidden=64, max_seq_len=16, dropout=0.0)
B, S = 8, 16
ACC = 4
LR, WD = 1e-3, 0.01
STEPS = 2
CLIP = 0.05
SGD_LR = 0.1
F32_REL = 1e-5
PARAM_TOL = 1e-5
TANH = dict(M=4, mb=2, h=4)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (B, S)).astype(np.int64),
            rng.randint(0, 128, (B, S)).astype(np.int64))


def _tanh_data(stages):
    rng = np.random.RandomState(stages)
    h, n = TANH["h"], TANH["M"] * TANH["mb"]
    return (rng.randn(stages, h, h).astype(np.float32),
            rng.randn(stages, h).astype(np.float32),
            rng.randn(n, h).astype(np.float32))


def _key_bias(name, arr):
    mask = np.zeros(arr.shape, bool)
    if name.endswith("qkv.bias"):
        h = arr.shape[0] // 3
        mask[h:2 * h] = True
    return mask


# -- rank functions (spawned; no JAX) --------------------------------------
def _reset():
    from paddle_tpu_torch.distributed import fleet, mesh

    mesh.set_mesh(None)
    fleet._fleet_state.update(initialized=False, strategy=None, hcg=None,
                              role_maker=None)


def _p2p(res):
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed import collective, get_rank

    r = get_rank()
    peer = 1 - r
    rng = np.random.RandomState(11)
    sent = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
            torch.from_numpy(rng.randn(7).astype(np.float32)).to(
                torch.bfloat16),
            torch.from_numpy(rng.randint(-9, 9, (2, 3, 4))),
            torch.from_numpy(rng.randn(4, 1).astype(np.float32)),
            torch.from_numpy(rng.randn(1).astype(np.float32))]
    keys = [f"comm/{op}/{k}" for op in ("send", "recv")
            for k in ("calls", "bytes")]
    before = {k: monitor.stat_get(k) for k in keys}
    got = []
    for sender in (0, 1):               # both ways
        if r == sender:
            tasks = [collective.isend(t, peer) for t in sent[:4]]
            collective.send(sent[4], peer)
            for t in tasks:
                t.wait()
        else:
            bufs = [torch.empty_like(t) for t in sent]
            tasks = [collective.irecv(b, peer) for b in bufs[:2]]
            for t in tasks:
                t.wait()
            out = [collective.recv(b, peer) for b in bufs[2:]]
            assert out[0] is bufs[2]
            got = bufs
    for i, (a, b) in enumerate(zip(sent, got)):
        res[f"p2p/equal/{i}"] = np.array(
            a.dtype == b.dtype and torch.equal(a, b))
    for k in keys:
        res[f"p2p/{k}"] = np.array(monitor.stat_get(k) - before[k])
    res["p2p/bytes"] = np.array(sum(t.numel() * t.element_size()
                                    for t in sent))


def _tanh(res, stages):
    """The tanh stack over `stages` ranks, both schedules."""
    from paddle_tpu_torch.distributed import build_mesh, pipeline, set_mesh

    _reset()
    m = set_mesh(build_mesh({"pp": stages}))
    g = m.group(("pp",))
    w, b, x = _tanh_data(stages)
    for sched in pipeline.SCHEDULES:
        W = torch.tensor(w[g.rank], requires_grad=True)
        Bb = torch.tensor(b[g.rank], requires_grad=True)
        X = torch.tensor(x, requires_grad=True)
        ps = pipeline.PipelineSchedule(
            lambda t: torch.tanh(t @ W + Bb), g,
            loss_fn=lambda y, _: (y * y).sum())
        loss = ps.train(X, torch.zeros(x.shape[0]), TANH["M"], sched)
        tag = f"tanh{stages}/{sched}"
        res[f"{tag}/loss"] = loss.numpy()
        res[f"{tag}/w"] = W.grad.numpy()
        res[f"{tag}/b"] = Bb.grad.numpy()
        res[f"{tag}/x"] = (X.grad if X.grad is not None
                           else torch.zeros_like(X)).numpy()
        res[f"{tag}/stash"] = np.array(ps.max_stash)
    _reset()


def _ernie(res, tag, flat, hybrid, mode="1F1B", clip=None, sgd=False,
           patch=None):
    """ERNIE through fleet.distributed_model's PipelineParallel: two
    train_batch steps, then the gathered parameters, eval_batch and
    this rank's parameter names."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.text.models.ernie import (ErnieConfig,
                                                    ErnieForPretraining)

    _reset()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(hybrid)
    strategy.pipeline_configs = {"accumulate_steps": ACC,
                                 "schedule_mode": mode}
    fleet.init(is_collective=True, strategy=strategy)
    model = ErnieForPretraining(ErnieConfig(**CFG), device="cpu")
    convert.load_sharded_state_dict(model, flat)
    pp = fleet.distributed_model(model.ernie)
    res[f"{tag}/wrapper"] = np.array(type(pp).__name__)
    hcg = fleet.get_hybrid_communicate_group()
    res[f"{tag}/hcg"] = np.array([
        hcg.get_stage_id(), hcg.is_first_stage(), hcg.is_last_stage(),
        hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()])
    res[f"{tag}/names"] = np.array(sorted(
        n for n, _ in model.named_parameters()))
    params = model.named_parameters()
    if sgd or clip is not None:
        opt = SGD(SGD_LR, parameters=params,
                  grad_clip=None if clip is None
                  else ClipGradByGlobalNorm(clip))
    else:
        opt = AdamW(LR, parameters=params, weight_decay=WD)
    undo = patch(model) if patch is not None else None
    ids, labels = _batch()
    res[f"{tag}/losses"] = np.array(
        [float(pp.train_batch((ids, labels), opt)) for _ in range(STEPS)])
    if undo is not None:
        undo()
    for n, t in convert.gather_state_dict(model).items():
        res[f"{tag}/param/{n}"] = t.numpy()
    res[f"{tag}/eval"] = pp.eval_batch((ids, labels)).numpy()
    _reset()


def _drop_last_backward(model):
    from paddle_tpu_torch.distributed import pipeline

    real = pipeline.schedule_order

    def order(schedule, num_stages, stage, num_micro):
        return [o for o in real(schedule, num_stages, stage, num_micro)
                if o != ("B", num_micro - 1)]

    pipeline.schedule_order = order

    def undo():
        pipeline.schedule_order = real

    return undo


def _clip_without_pp(model):
    """The clip sees no pp group: each stage clips by its own norm."""
    params = list(model.parameters())
    groups = [p.pp_group for p in params]
    for p in params:
        del p.pp_group

    def undo():
        for p, g in zip(params, groups):
            p.pp_group = g

    return undo


def _rank2(out_dir, flat_npz):
    from paddle_tpu_torch.distributed import get_rank

    flat = dict(np.load(flat_npz))
    res = {}
    _p2p(res)
    _tanh(res, 2)
    pp2 = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 2}
    _ernie(res, "pp2_fthenb", flat, pp2, mode="F-then-B")
    _ernie(res, "pp2_1f1b", flat, pp2, mode="1F1B")
    _ernie(res, "pp2_clip", flat, pp2, clip=CLIP)
    _ernie(res, "neg_drop_last_backward", flat, pp2, clip=CLIP,
           patch=_drop_last_backward)
    _ernie(res, "neg_clip_without_pp", flat, pp2, clip=CLIP,
           patch=_clip_without_pp)
    np.savez(os.path.join(out_dir, f"r2_{get_rank()}.npz"), **res)


def _rank4(out_dir, flat_npz):
    from paddle_tpu_torch.distributed import get_rank

    flat = dict(np.load(flat_npz))
    res = {}
    _tanh(res, 4)
    _ernie(res, "dp2pp2", flat, {"dp_degree": 2, "mp_degree": 1,
                                 "pp_degree": 2})
    _ernie(res, "mp2pp2_clip", flat, {"dp_degree": 1, "mp_degree": 2,
                                      "pp_degree": 2}, clip=CLIP)
    np.savez(os.path.join(out_dir, f"r4_{get_rank()}.npz"), **res)


def _spawn(fn, args, W, tmp):
    spawn(fn, args=args, nprocs=W, device="cpu",
          init_method=f"file://{tmp}/store_{fn.__name__}_{W}",
          join=False).join(timeout=300)


# -- the JAX side ------------------------------------------------------------
def _jax_ernie():
    import paddle_tpu as paddle
    from paddle_tpu.text.models import ernie as jernie

    paddle.seed(0)
    return jernie.ErnieForPretraining(jernie.ErnieConfig(**CFG))


def _flat(jm):
    return {k: np.asarray(v._value, np.float32)
            for k, v in jm.state_dict().items()}


_JAX = {}


def _jax_pp(axes, clip=None, sgd=False):
    """JAX's ERNIE through its PipelineParallel.train_batch on a mesh
    over `axes` (None: no mesh, the dygraph path): (losses, flat
    parameters)."""
    key = (tuple(sorted((axes or {}).items())), clip, sgd)
    if key not in _JAX:
        _JAX[key] = _jax_pp_once(axes, clip, sgd)
    return _JAX[key]


def _jax_pp_once(axes, clip, sgd):
    import jax

    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as jfleet
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as joptim
    from paddle_tpu.distributed import build_mesh
    from paddle_tpu.distributed import mesh as mesh_mod

    prev = mesh_mod.get_mesh()
    try:
        if axes:
            n = int(np.prod(list(axes.values())))
            mesh_mod.set_mesh(build_mesh(axes, jax.devices()[:n]))
        jm = _jax_ernie()
        js = jfleet.DistributedStrategy()
        js.pipeline_configs = {"accumulate_steps": ACC}
        jpp = jfleet.meta_parallel.PipelineParallel(jm.ernie, None, js)
        if sgd or clip is not None:
            opt = joptim.SGD(SGD_LR, parameters=jm.parameters(),
                             grad_clip=None if clip is None
                             else jnn.ClipGradByGlobalNorm(clip))
        else:
            opt = joptim.AdamW(LR, parameters=jm.parameters(),
                               weight_decay=WD)
        ids, labels = (paddle.to_tensor(t) for t in _batch())
        losses = [float(np.asarray(jpp.train_batch((ids, labels),
                                                   opt)._value))
                  for _ in range(STEPS)]
        assert (jpp._compiled_step is not None) == bool(axes)
    finally:
        mesh_mod.set_mesh(prev)
    return np.array(losses), _flat(jm)


def _jax_eval(flat):
    """JAX's PipelineParallel.eval_batch of ERNIE holding `flat`, off
    any mesh (after its compiled pp step JAX's own eval_batch raises:
    ROADMAP queue 3 #26)."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as jfleet

    em = _jax_ernie()
    em.set_state_dict(flat)
    ids, labels = (paddle.to_tensor(t) for t in _batch())
    return np.asarray(jfleet.meta_parallel.PipelineParallel(
        em.ernie).eval_batch((ids, labels))._value)


def _jax_tanh(stages):
    """jax.grad through JAX's gpipe_loop of the tanh stack's mean
    micro-batch loss: (loss, w grads, b grads, input grads)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed.pipeline import gpipe_loop, microbatch

    w, b, x = _tanh_data(stages)
    M = TANH["M"]

    def stage_fn(p, sx):
        return jnp.tanh(sx @ p["w"] + p["b"])

    def loss(params, xs):
        y = gpipe_loop(stage_fn, params, microbatch(xs, M), stages,
                       state_spec=(None,))
        return jnp.sum(y * y) / M

    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    val, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    return (float(val), np.asarray(gp["w"]), np.asarray(gp["b"]),
            np.asarray(gx))


@pytest.fixture(scope="module")
def jax_flat():
    return _flat(_jax_ernie())


@pytest.fixture(scope="module")
def runs2(tmp_path_factory, jax_flat):
    tmp = str(tmp_path_factory.mktemp("pp2"))
    flat_npz = os.path.join(tmp, "flat.npz")
    np.savez(flat_npz, **jax_flat)
    _spawn(_rank2, (tmp, flat_npz), 2, tmp)
    return [dict(np.load(os.path.join(tmp, f"r2_{r}.npz")))
            for r in range(2)]


@pytest.fixture(scope="module")
def runs4(tmp_path_factory, jax_flat):
    tmp = str(tmp_path_factory.mktemp("pp4"))
    flat_npz = os.path.join(tmp, "flat.npz")
    np.savez(flat_npz, **jax_flat)
    _spawn(_rank4, (tmp, flat_npz), 4, tmp)
    return [dict(np.load(os.path.join(tmp, f"r4_{r}.npz")))
            for r in range(4)]


def _run(res, tag):
    pre = f"{tag}/param/"
    return res[f"{tag}/losses"], {k[len(pre):]: v for k, v in res.items()
                                  if k.startswith(pre)}


def _params_close(got, want, tol=PARAM_TOL, lr_steps=LR * STEPS):
    """Every parameter within `tol`, the key bias within lr x steps."""
    assert set(got) == set(want)
    for n, w in want.items():
        g = np.asarray(got[n], np.float32)
        assert g.shape == w.shape, n
        kb = _key_bias(n, w)
        err = np.abs(g - w)
        assert float(err[~kb].max(initial=0.0)) <= tol, (n, err.max())
        assert float(err[kb].max(initial=0.0)) <= lr_steps, n


def _worst_param_gap(got, want):
    return max(float(np.abs(np.asarray(got[n], np.float32) - w)[
        ~_key_bias(n, w)].max(initial=0.0)) for n, w in want.items())


# -- point to point ------------------------------------------------------------
def test_p2p_both_ways_in_order_and_counted(runs2):
    for res in runs2:
        for i in range(5):
            assert bool(res[f"p2p/equal/{i}"]), i
        nbytes = int(res["p2p/bytes"])
        assert int(res["p2p/comm/send/calls"]) == 5
        assert int(res["p2p/comm/recv/calls"]) == 5
        assert int(res["p2p/comm/send/bytes"]) == nbytes
        assert int(res["p2p/comm/recv/bytes"]) == nbytes


def test_p2p_in_one_process_raises():
    from paddle_tpu_torch.distributed import collective

    for fn in (collective.send, collective.recv, collective.isend,
               collective.irecv):
        with pytest.raises(NotImplementedError, match="no peer"):
            fn(torch.zeros(2), 1)


def test_microbatch_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.distributed import pipeline as jpipe
    from paddle_tpu_torch.distributed import pipeline

    x = np.arange(48, dtype=np.float32).reshape(8, 3, 2)
    for m in (1, 2, 4, 8):
        want = np.asarray(jpipe.microbatch(jnp.asarray(x), m))
        got = pipeline.microbatch(torch.from_numpy(x), m)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            pipeline.unmicrobatch(got).numpy(),
            np.asarray(jpipe.unmicrobatch(jnp.asarray(want))))
    with pytest.raises(ValueError) as jerr:
        jpipe.microbatch(jnp.asarray(x), 3)
    with pytest.raises(ValueError) as perr:
        pipeline.microbatch(torch.from_numpy(x), 3)
    assert str(perr.value) == str(jerr.value)


def test_schedule_orders():
    from paddle_tpu_torch.distributed import pipeline

    for S_ in (1, 2, 4):
        for s in range(S_):
            for M in (1, 4, 6):
                for sched in pipeline.SCHEDULES:
                    order = pipeline.schedule_order(sched, S_, s, M)
                    assert sorted(order) == sorted(
                        [("F", i) for i in range(M)]
                        + [("B", i) for i in range(M)])
                    assert [i for k, i in order if k == "B"] == list(
                        range(M))
                    live = peak = 0
                    for k, _ in order:
                        live += 1 if k == "F" else -1
                        peak = max(peak, live)
                    assert peak == (M if sched == "gpipe"
                                    else min(S_ - s, M))
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        pipeline.schedule_order("zero-bubble", 2, 0, 4)


# -- the schedules against autodiff -------------------------------------------
@pytest.mark.parametrize("stages", [2, 4])
def test_schedules_match_jax_autodiff(stages, runs2, runs4):
    runs = runs2 if stages == 2 else runs4
    loss, gw, gb, gx = _jax_tanh(stages)
    for r, res in enumerate(runs):
        tag = f"tanh{stages}"
        for sched in ("gpipe", "1f1b"):
            t = f"{tag}/{sched}"
            assert abs(float(res[f"{t}/loss"]) - loss) <= F32_REL * abs(
                loss)
            np.testing.assert_allclose(res[f"{t}/w"], gw[r],
                                       rtol=F32_REL, atol=1e-6)
            np.testing.assert_allclose(res[f"{t}/b"], gb[r],
                                       rtol=F32_REL, atol=1e-6)
            if r == 0:
                np.testing.assert_allclose(res[f"{t}/x"], gx,
                                           rtol=F32_REL, atol=1e-6)
        for part in ("loss", "w", "b", "x"):
            np.testing.assert_array_equal(res[f"{tag}/gpipe/{part}"],
                                          res[f"{tag}/1f1b/{part}"])
        assert int(res[f"{tag}/gpipe/stash"]) == TANH["M"]
        assert int(res[f"{tag}/1f1b/stash"]) == min(stages - r, TANH["M"])
    assert int(runs[0][f"tanh{stages}/1f1b/stash"]) <= stages


# -- ERNIE through PipelineParallel --------------------------------------------
def _stage_names(flat, stage, stages=2):
    """JAX's names of stage `stage` under Paddle's segmentation of
    ERNIE's 6 layer entries."""
    n = CFG["num_layers"] + 2
    lo, hi = n * stage // stages, n * (stage + 1) // stages
    return sorted(k for k in flat if lo <= int(k.split(".")[2]) < hi)


@pytest.mark.parametrize("tag,dims", [
    ("pp2_1f1b", (1, 2, 1, 1, 1)), ("dp2pp2", (2, 2, 1, 1, 1)),
    ("mp2pp2_clip", (1, 2, 1, 2, 1))])
def test_hybrid_group_and_wrapper_match_jax_on_every_rank(runs2, runs4,
                                                          tag, dims):
    """Each rank's stage, first / last stage, dp and mp rank against
    JAX's topology of the same layout, and `distributed_model`'s
    wrapper."""
    import paddle_tpu.distributed.fleet as jfleet

    topo = jfleet.CommunicateTopology(
        ["data", "pipe", "sharding", "model", "sep"], dims)
    runs = runs2 if int(np.prod(dims)) == 2 else runs4
    for r, res in enumerate(runs):
        c = topo.get_coord(r)
        assert res[f"{tag}/hcg"].tolist() == [
            c.pipe, c.pipe == 0, c.pipe == dims[1] - 1, c.data, c.model]
        assert str(res[f"{tag}/wrapper"]) == "PipelineParallel"


def test_ernie_pp2_matches_jax(runs2, jax_flat):
    jl, jp = _jax_pp({"pp": 2})
    jev = _jax_eval(jp)
    for r, res in enumerate(runs2):
        assert str(res["pp2_1f1b/wrapper"]) == "PipelineParallel"
        assert res["pp2_1f1b/names"].tolist() == _stage_names(jax_flat, r)
        for tag in ("pp2_fthenb", "pp2_1f1b"):
            losses, params = _run(res, tag)
            np.testing.assert_allclose(losses, jl, rtol=F32_REL)
            _params_close(params, jp)
            np.testing.assert_allclose(res[f"{tag}/eval"], jev,
                                       rtol=F32_REL, atol=1e-5)
    assert runs2[0]["pp2_1f1b/names"].tolist() + runs2[1][
        "pp2_1f1b/names"].tolist() == sorted(jax_flat)


def test_ernie_pp2_equals_the_pp1_micro_batch_path_bit_for_bit(runs2,
                                                               jax_flat):
    """The port's pp 1 `PipelineParallel` (the dygraph micro-batch path,
    the same arithmetic in one process) from the same weights: the same
    losses and parameters, bit for bit."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.ernie import (ErnieConfig,
                                                    ErnieForPretraining)

    model = ErnieForPretraining(ErnieConfig(**CFG), device="cpu")
    convert.load_sharded_state_dict(model, jax_flat)
    ps = fleet.DistributedStrategy()
    ps.pipeline_configs = {"accumulate_steps": ACC}
    pp = fleet.meta_parallel.PipelineParallel(model.ernie, None, ps)
    opt = AdamW(LR, parameters=model.named_parameters(), weight_decay=WD)
    ids, labels = _batch()
    losses = [float(pp.train_batch((ids, labels), opt))
              for _ in range(STEPS)]
    for res in runs2:
        got, params = _run(res, "pp2_1f1b")
        np.testing.assert_array_equal(got, losses)
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(params[n], p.detach().numpy(),
                                          err_msg=n)


def test_ernie_pp2_schedules_bit_identical(runs2):
    for res in runs2:
        a, pa = _run(res, "pp2_fthenb")
        b, pb = _run(res, "pp2_1f1b")
        np.testing.assert_array_equal(a, b)
        for n in pa:
            np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)


def test_ernie_pp2_clip_matches_jax(runs2):
    jl, jp = _jax_pp({"pp": 2}, clip=CLIP)
    for res in runs2:
        losses, params = _run(res, "pp2_clip")
        np.testing.assert_allclose(losses, jl, rtol=F32_REL)
        _params_close(params, jp, lr_steps=np.inf)
    unclipped, _ = _jax_pp({"pp": 2}, sgd=True)
    assert abs(unclipped[1] - jl[1]) > 1e-3          # the clip was active


def test_ernie_dp2_pp2_matches_jax(runs4, jax_flat):
    jl, jp = _jax_pp({"dp": 2, "pp": 2})
    for r, res in enumerate(runs4):
        # fleet's layout: rank = dp * 2 + pp
        assert res["dp2pp2/names"].tolist() == _stage_names(jax_flat, r % 2)
        losses, params = _run(res, "dp2pp2")
        np.testing.assert_allclose(losses, jl, rtol=F32_REL)
        _params_close(params, jp)


def test_ernie_mp2_pp2_clip_matches_jax(runs4, jax_flat):
    jl, jp = _jax_pp({"pp": 2, "mp": 2}, clip=CLIP)
    for r, res in enumerate(runs4):
        # fleet's layout: rank = pp * 2 + mp
        assert res["mp2pp2_clip/names"].tolist() == _stage_names(
            jax_flat, r // 2)
        losses, params = _run(res, "mp2pp2_clip")
        np.testing.assert_allclose(losses, jl, rtol=F32_REL)
        _params_close(params, jp, lr_steps=np.inf)
    unclipped, _ = _jax_pp({"pp": 2}, sgd=True)
    assert abs(unclipped[1] - jl[1]) > 1e-3          # the clip was active


# -- negative controls ---------------------------------------------------------
@pytest.mark.parametrize("tag", ["neg_drop_last_backward",
                                 "neg_clip_without_pp"])
def test_ernie_negative_controls_break_parity(runs2, tag):
    _, jp = _jax_pp({"pp": 2}, clip=CLIP)
    for res in runs2:
        assert _worst_param_gap(_run(res, tag)[1], jp) > 10 * PARAM_TOL
