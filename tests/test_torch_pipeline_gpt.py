"""GPT's pipeline stages and the GradScaler's joint skip, held against
the JAX package on the CPU (the rest of the pipeline slice is in
tests/test_torch_pipeline.py, whose helpers this file shares).

  * GPT (JAX's `test_1f1b_schedule_parity_with_gpipe` config at S 2, M
    4, SGD(0.1)) at pp 2 over two gloo ranks through
    `DistributedTrainStepCompiler(mesh=)` against JAX's `pp_num_stages`
    2 on a `{"pp": 2}` mesh: losses over 3 steps within 1e-5 relative
    and the gathered parameters within 1e-5; each rank's names; gpipe =
    1f1b bit for bit; the tied `wte` equal on both stages after every
    step. The same config in one process against JAX's
    `TrainStepCompiler`; JAX's refusals (dropout > 0 in training,
    `num_layers` not divisible by S).
  * ERNIE at pp 2 with a GradScaler and an inf planted in stage 1's
    gradient: both stages skip the step and the scale halves, then
    train on, as JAX's dygraph path does on one controller (its inf
    planted in the loss).
  * Negative control: a last stage that keeps its own `wte` gradient
    (it skips the tied weight's sum) breaks the loss parity and the tie.

The rank functions are module-level and import no JAX.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import (ACC, B, CFG, F32_REL, LR, PARAM_TOL, S,
                                 SGD_LR, WD, _batch, _flat, _jax_ernie,
                                 _params_close, _reset, _run, _spawn)

GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
               ffn_hidden=64, max_seq_len=16, dropout=0.0,
               use_flash_attention=False, remat=False)
GPT_STEPS = 3


# -- rank functions (spawned; no JAX) --------------------------------------
def _gpt_ids():
    return np.random.RandomState(0).randint(0, 128, (B, S)).astype(np.int64)


def _tree(flat):
    """A GPT parameter tree from its flat npz ("blocks.<name>" keys)."""
    tree = {"blocks": {}}
    for k, v in flat.items():
        if k.startswith("blocks."):
            tree["blocks"][k[len("blocks."):]] = v
        else:
            tree[k] = v
    return tree


def _ernie_scaler(res, flat):
    """pp 2 with a GradScaler: an inf in stage 1's gradient at step 1."""
    from paddle_tpu_torch import amp, convert
    from paddle_tpu_torch.distributed import fleet, get_rank
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.ernie import (ErnieConfig,
                                                    ErnieForPretraining)

    _reset()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": ACC}
    fleet.init(is_collective=True, strategy=strategy)
    model = ErnieForPretraining(ErnieConfig(**CFG), device="cpu")
    convert.load_sharded_state_dict(model, flat)
    pp = fleet.distributed_model(model.ernie)
    opt = AdamW(LR, parameters=model.named_parameters(), weight_decay=WD)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    hook = None
    if get_rank() == 1:
        p = next(model.parameters())
        hook = p.register_hook(lambda g: torch.full_like(g, float("inf")))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids, labels = _batch()
    losses = [float(pp.train_batch((ids, labels), opt, scaler=scaler))]
    res["scaler/unchanged"] = np.array(all(
        torch.equal(p, start[n]) for n, p in model.named_parameters()))
    res["scaler/scale1"] = np.array(scaler._scale)
    if hook is not None:
        hook.remove()
    losses.append(float(pp.train_batch((ids, labels), opt, scaler=scaler)))
    res["scaler/scale2"] = np.array(scaler._scale)
    res["scaler/losses"] = np.array(losses)
    for n, t in convert.gather_state_dict(model).items():
        res[f"scaler/param/{n}"] = t.numpy()
    _reset()


def _gpt(res, tag, tree, schedule, skip_shared=False):
    """GPT at pp 2, M 4, through DistributedTrainStepCompiler(mesh=)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import build_mesh, set_mesh
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    _reset()
    mesh = set_mesh(build_mesh({"pp": 2}))
    cfg = GPTConfig(**GPT_CFG, pp_num_stages=2, pp_microbatches=4,
                    pp_schedule=schedule)
    model = GPTForCausalLM(cfg, device="cpu")
    convert.load_reference_params(model, tree)
    gpt = model.gpt
    if skip_shared and gpt.is_last_stage:
        # the last stage joins the sum (the first would wait for it) and
        # keeps its own gradient
        real = gpt.allreduce_shared_weight_gradients

        def keep_own():
            g = gpt.wte.grad.clone()
            real()
            gpt.wte.grad = g

        gpt.allreduce_shared_weight_gradients = keep_own
    opt = SGD(SGD_LR, parameters=model.named_parameters())
    step = DistributedTrainStepCompiler(model, opt, mesh=mesh)
    ids = _gpt_ids()
    losses, wtes = [], []
    for _ in range(GPT_STEPS):
        losses.append(float(step(ids, ids)))
        if hasattr(gpt, "wte"):
            wtes.append(gpt.wte.detach().numpy().copy())
    res[f"{tag}/losses"] = np.array(losses)
    res[f"{tag}/wte"] = np.array(wtes)
    res[f"{tag}/names"] = np.array(sorted(
        n for n, _ in model.named_parameters()))
    for n, t in convert.gather_state_dict(model).items():
        res[f"{tag}/param/{n}"] = t.numpy()
    _reset()


def _rank2(out_dir, flat_npz, tree_npz):
    from paddle_tpu_torch.distributed import get_rank

    flat = dict(np.load(flat_npz))
    tree = _tree(dict(np.load(tree_npz)))
    res = {}
    _ernie_scaler(res, flat)
    _gpt(res, "gpt_gpipe", tree, "gpipe")
    _gpt(res, "gpt_1f1b", tree, "1f1b")
    _gpt(res, "neg_skip_shared", tree, "gpipe", skip_shared=True)
    np.savez(os.path.join(out_dir, f"g2_{get_rank()}.npz"), **res)


# -- the JAX side ------------------------------------------------------------
_JAX = {}


def _jax_gpt_tree():
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.inference.serving.model_runner import extract_params
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

    paddle.seed(5)
    jm = GPTForCausalLM(GPTConfig(**GPT_CFG))
    params, _ = extract_params(jm)
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_gpt(pp_mesh):
    """JAX's GPT with pp_num_stages 2 and 4 micro-batches from
    `_jax_gpt_tree`'s weights, 3 SGD steps: on a {"pp": 2} mesh through
    its DistributedTrainStepCompiler, or with no mesh through its
    TrainStepCompiler. (losses, parameter tree)."""
    key = ("gpt", pp_mesh)
    if key not in _JAX:
        _JAX[key] = _jax_gpt_once(pp_mesh)
    return _JAX[key]


def _jax_gpt_once(pp_mesh):
    import jax

    import paddle_tpu as paddle
    import paddle_tpu.optimizer as joptim
    from paddle_tpu.distributed import build_mesh
    from paddle_tpu.distributed import mesh as mesh_mod
    from paddle_tpu.inference.serving.model_runner import extract_params
    from paddle_tpu.jit import TrainStepCompiler
    from paddle_tpu.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

    prev = mesh_mod.get_mesh()
    try:
        paddle.seed(5)
        jm = GPTForCausalLM(GPTConfig(**GPT_CFG, pp_num_stages=2,
                                      pp_microbatches=4))
        opt = joptim.SGD(SGD_LR, parameters=jm.parameters())
        if pp_mesh:
            mesh = build_mesh({"pp": 2}, jax.devices()[:2])
            mesh_mod.set_mesh(mesh)
            step = DistributedTrainStepCompiler(jm, opt, mesh=mesh)
        else:
            mesh_mod.set_mesh(None)
            step = TrainStepCompiler(jm, opt)
        ids = paddle.to_tensor(_gpt_ids())
        losses = [float(np.asarray(step(ids, ids)._value))
                  for _ in range(GPT_STEPS)]
    finally:
        mesh_mod.set_mesh(prev)
    params, _ = extract_params(jm)
    return np.array(losses), jax.tree_util.tree_map(np.asarray, params)


def _tree_flat(tree):
    out = {f"blocks.{k}": np.asarray(v, np.float32)
           for k, v in tree["blocks"].items()}
    out.update((k, np.asarray(v, np.float32)) for k, v in tree.items()
               if k != "blocks")
    return out


@pytest.fixture(scope="module")
def jax_flat():
    return _flat(_jax_ernie())


@pytest.fixture(scope="module")
def gpt_tree():
    return _jax_gpt_tree()


@pytest.fixture(scope="module")
def runs2(tmp_path_factory, jax_flat, gpt_tree):
    tmp = str(tmp_path_factory.mktemp("gpt_pp2"))
    flat_npz = os.path.join(tmp, "flat.npz")
    tree_npz = os.path.join(tmp, "tree.npz")
    np.savez(flat_npz, **jax_flat)
    np.savez(tree_npz, **_tree_flat(gpt_tree))
    _spawn(_rank2, (tmp, flat_npz, tree_npz), 2, tmp)
    return [dict(np.load(os.path.join(tmp, f"g2_{r}.npz")))
            for r in range(2)]


# -- the GradScaler ----------------------------------------------------------
def test_ernie_pp2_scaler_skips_on_every_stage(runs2):
    """JAX's dygraph path with a GradScaler on one controller, an inf in
    the first step's loss: the step is skipped, the scale halves, the
    second step trains. The port's two stages, the inf in stage 1's
    gradient only: the same."""
    import paddle_tpu as paddle
    import paddle_tpu.amp as jamp
    import paddle_tpu.distributed.fleet as jfleet
    import paddle_tpu.optimizer as joptim

    jm = _jax_ernie()
    js = jfleet.DistributedStrategy()
    js.pipeline_configs = {"accumulate_steps": ACC}
    jpp = jfleet.meta_parallel.PipelineParallel(jm.ernie, None, js)
    opt = joptim.AdamW(LR, parameters=jm.parameters(), weight_decay=WD)
    scaler = jamp.GradScaler(init_loss_scaling=2.0 ** 10)
    real = jm.ernie._loss_fn
    calls = []

    def planted(logits, label):
        calls.append(1)
        loss = real(logits, label)
        return loss * float("inf") if len(calls) == 1 else loss

    jm.ernie._loss_fn = planted
    ids, labels = (paddle.to_tensor(t) for t in _batch())
    jpp.train_batch((ids, labels), opt, scaler=scaler)
    scale1 = scaler._scale
    l2 = float(np.asarray(jpp.train_batch((ids, labels), opt,
                                          scaler=scaler)._value))
    for res in runs2:
        assert bool(res["scaler/unchanged"])
        assert float(res["scaler/scale1"]) == scale1 == 2.0 ** 9
        assert float(res["scaler/scale2"]) == scaler._scale
        assert abs(float(res["scaler/losses"][1]) - l2) <= F32_REL * l2
        params = {k[len("scaler/param/"):]: v for k, v in res.items()
                  if k.startswith("scaler/param/")}
        _params_close(params, _flat(jm), lr_steps=LR)


# -- GPT -----------------------------------------------------------------------
def test_gpt_pp2_matches_jax(runs2, gpt_tree):
    jl, jtree = _jax_gpt(True)
    want = {f"gpt.{k}": v for k, v in _tree_flat(jtree).items()}
    own = [set(res["gpt_gpipe/names"].tolist()) for res in runs2]
    assert own[0] == {"gpt.wte", "gpt.wpe"} | {
        f"gpt.blocks.{k}" for k in gpt_tree["blocks"]}
    assert own[1] == {"gpt.wte", "gpt.lnf_w", "gpt.lnf_b"} | {
        f"gpt.blocks.{k}" for k in gpt_tree["blocks"]}
    for res in runs2:
        for tag in ("gpt_gpipe", "gpt_1f1b"):
            losses, params = _run(res, tag)
            np.testing.assert_allclose(losses, jl, rtol=F32_REL)
            assert losses[-1] < losses[0]
            assert set(params) == set(want)
            for n, w in want.items():
                np.testing.assert_allclose(params[n], w, rtol=0,
                                           atol=PARAM_TOL, err_msg=n)


def test_gpt_pp2_schedules_bit_identical_and_wte_tied(runs2):
    for res in runs2:
        a, pa = _run(res, "gpt_gpipe")
        b, pb = _run(res, "gpt_1f1b")
        np.testing.assert_array_equal(a, b)
        for n in pa:
            np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)
    for tag in ("gpt_gpipe", "gpt_1f1b"):
        w0, w1 = runs2[0][f"{tag}/wte"], runs2[1][f"{tag}/wte"]
        assert w0.shape[0] == GPT_STEPS
        np.testing.assert_array_equal(w0, w1)


def test_gpt_pp_in_one_process_matches_jax(gpt_tree):
    from paddle_tpu_torch.convert import load_reference_params
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    jl, jtree = _jax_gpt(False)
    jpp, _ = _jax_gpt(True)
    np.testing.assert_allclose(jl, jpp, rtol=F32_REL)
    for sched in ("gpipe", "1f1b"):
        m = GPTForCausalLM(GPTConfig(**GPT_CFG, pp_num_stages=2,
                                     pp_microbatches=4, pp_schedule=sched),
                           device="cpu")
        load_reference_params(m, gpt_tree)
        step = TrainStepCompiler(m, SGD(SGD_LR,
                                        parameters=m.named_parameters()))
        ids = _gpt_ids()
        losses = [float(step(ids, ids)) for _ in range(GPT_STEPS)]
        np.testing.assert_allclose(losses, jl, rtol=F32_REL)
        got = {n[len("gpt."):]: p.detach().numpy()
               for n, p in m.named_parameters()}
        for n, w in _tree_flat(jtree).items():
            np.testing.assert_allclose(got[n], w, rtol=0, atol=PARAM_TOL,
                                       err_msg=n)


def test_gpt_pp_refusals():
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    ids = _gpt_ids()
    m = GPTForCausalLM(GPTConfig(**{**GPT_CFG, "dropout": 0.1},
                                 pp_num_stages=2, pp_microbatches=4),
                       device="cpu")
    with pytest.raises(ValueError, match="dropout=0.0"):
        m(ids, ids)
    m.eval()
    m(ids, ids)                       # no dropout outside training
    m = GPTForCausalLM(GPTConfig(**GPT_CFG, pp_num_stages=3,
                                 pp_microbatches=4), device="cpu")
    with pytest.raises(ValueError, match="not divisible into 3"):
        m(ids, ids)


def test_gpt_skipped_shared_sum_breaks_parity(runs2):
    jl, _ = _jax_gpt(True)
    for res in runs2:
        losses, _ = _run(res, "neg_skip_shared")
        assert float(np.max(np.abs(losses - jl) / jl)) > 10 * F32_REL
    assert not np.array_equal(runs2[0]["neg_skip_shared/wte"],
                              runs2[1]["neg_skip_shared/wte"])
