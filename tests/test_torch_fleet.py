"""The port's fleet layer (`paddle_tpu_torch.distributed.fleet`, `mesh`,
`DataParallel`) held against the JAX package's, on the CPU.

  * The topology's coordinates, rank lists and communication lists, the
    hybrid group's degrees, ranks, parallel mode and group sizes, and
    `SegmentLayers` for every method: equal to JAX's.
  * Each mp layer at mp 1 (one process: the full weight, plain ops):
    forward and every gradient within 1e-5 x max|ref| of JAX's with the
    same numpy weights (summation order only).
  * `fleet.distributed_model` picks JAX's wrapper in every mode, except
    sharding, which the port does not have and refuses.
  * `DataParallel` over two gloo ranks (`distributed.spawn(device=
    "cpu")`): the parameters broadcast from rank 0 at construction, the
    gradients averaged after backward (against the mean of the two
    ranks' gradients, 1e-6 x max|g|), none under `no_sync`; the
    compressed data-parallel wire refuses an mp layer's `dist_spec`.
    Mesh groups over two ranks (one subgroup a line).

The rank functions are module-level and import no JAX.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import fleet, mesh, spawn
from paddle_tpu_torch.distributed.fleet.base import distributed_strategy
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    parallel_layers as ppl)

TOPOLOGIES = [(1, 1, 1, 1, 1), (2, 1, 1, 2, 1), (2, 2, 1, 2, 1),
              (1, 2, 2, 2, 1), (1, 1, 1, 2, 2), (8, 1, 1, 1, 1)]
NAMES = ["data", "pipe", "sharding", "model", "sep"]
REL = 1e-5


def J():
    """The JAX package's modules, imported in the pytest process only."""
    import types

    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as jfleet
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.distributed.fleet.base import (
        distributed_strategy as jstrategy)
    from paddle_tpu.distributed.fleet.meta_parallel import (
        parallel_layers as jpl)

    return types.SimpleNamespace(paddle=paddle, fleet=jfleet, mesh=jmesh,
                                 strategy=jstrategy, pl=jpl)


@pytest.fixture(autouse=True)
def _restore_meshes():
    """Every test starts and leaves both packages without a mesh or a
    fleet."""
    jprev = J().mesh.get_mesh()
    J().mesh.set_mesh(None)
    mesh.set_mesh(None)
    yield
    J().mesh.set_mesh(jprev)
    mesh.set_mesh(None)
    fleet._fleet_state.update(initialized=False, strategy=None, hcg=None,
                              role_maker=None)


# -- topology and groups --------------------------------------------------
@pytest.mark.parametrize("dims", TOPOLOGIES)
def test_topology_matches_jax(dims):
    jt = J().fleet.CommunicateTopology(NAMES, dims)
    pt = fleet.CommunicateTopology(NAMES, dims)
    assert pt.world_size == jt.world_size
    for r in range(jt.world_size):
        assert tuple(pt.get_coord(r)) == tuple(jt.get_coord(r))
        assert pt.coord_to_rank(pt.get_coord(r)) == r
    for name in NAMES:
        assert pt.get_dim(name) == jt.get_dim(name)
        assert pt.get_comm_list(name) == jt.get_comm_list(name)
        for i in range(jt.get_dim(name)):
            assert pt.get_axis_list(name, i) == jt.get_axis_list(name, i)


@pytest.mark.parametrize("dims", TOPOLOGIES)
def test_hybrid_group_matches_jax(dims):
    """Rank 0's view: degrees, ranks, stage, parallel mode, group sizes.
    The port's world is one process, so a larger topology is a dry run
    there (no mesh set), as in the JAX package with too few devices."""
    jh = J().fleet.HybridCommunicateGroup(
        J().fleet.CommunicateTopology(NAMES, dims))
    ph = fleet.HybridCommunicateGroup(fleet.CommunicateTopology(NAMES,
                                                                dims))
    for fn in ("get_parallel_mode", "get_data_parallel_rank",
               "get_data_parallel_world_size", "get_model_parallel_rank",
               "get_model_parallel_world_size", "get_stage_id",
               "get_pipe_parallel_world_size", "is_first_stage",
               "is_last_stage", "get_sharding_parallel_rank",
               "get_sharding_parallel_world_size", "get_sep_parallel_rank",
               "get_sep_parallel_world_size", "get_data_parallel_group_src_rank",
               "get_model_parallel_group_src_rank"):
        assert getattr(ph, fn)() == getattr(jh, fn)(), fn
    if J().mesh.get_mesh() is not None:   # JAX built its mesh (8 devices)
        for fn in ("get_data_parallel_group", "get_model_parallel_group",
                   "get_pipe_parallel_group", "get_sharding_parallel_group",
                   "get_sep_parallel_group", "get_check_parallel_group"):
            assert getattr(ph, fn)().nranks == getattr(jh, fn)().nranks, fn
    topo = ph.topology()
    for name, group in (("data", ph.get_data_parallel_group()),
                        ("model", ph.get_model_parallel_group()),
                        ("pipe", ph.get_pipe_parallel_group())):
        assert group.ranks in topo.get_comm_list(name)
        assert group.process_group is None       # one process
    assert (mesh.get_mesh() is not None) == (topo.world_size == 1)


def test_mesh_layout_lines_and_inference():
    m = mesh.build_mesh({"dp": 2, "pp": 1, "mp": -1}, world_size=8)
    assert m.shape == {"dp": 2, "pp": 1, "mp": 4}
    assert m.ranks.tolist() == np.arange(8).reshape(2, 1, 4).tolist()
    topo = fleet.CommunicateTopology(["data", "pipe", "model"], (2, 1, 4))
    for axis, name in (("dp", "data"), ("mp", "model"), ("pp", "pipe")):
        assert m.lines((axis,)) == topo.get_comm_list(name)
    assert m.lines(("dp", "mp")) == [list(range(8))]
    with pytest.raises(ValueError, match="needs 6 ranks"):
        mesh.build_mesh({"dp": 2, "mp": 3}, world_size=8)
    assert mesh.STANDARD_AXES == J().mesh.STANDARD_AXES
    one = mesh.build_mesh({"dp": 1, "pp": 1, "mp": -1})
    g = mesh.new_group_for_axes(("mp",), mesh=one)
    assert (g.ranks, g.rank, g.nranks, g.process_group) == ([0], 0, 1, None)
    assert one.group(("mp",)) is g               # one group per axes
    assert mesh.get_mesh() is None
    assert mesh.ensure_mesh().shape == {"dp": 1}
    assert mesh.default_mesh() is mesh.get_mesh()


# -- strategy, role maker, RNG ----------------------------------------------
def test_strategy_is_the_jax_closed_schema():
    assert distributed_strategy._FIELDS == J().strategy._FIELDS
    assert distributed_strategy._CONFIG_FIELDS == J().strategy._CONFIG_FIELDS
    assert set(distributed_strategy._UNSUPPORTED) == set(
        J().strategy._UNSUPPORTED)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    s.hybrid_configs = {"pp_degree": 1}
    assert s.hybrid_configs["mp_degree"] == 2       # merged, as in JAX
    with pytest.raises(AttributeError, match="Did you mean 'amp'"):
        s.ampp = True
    with pytest.raises(ValueError, match="unknown config key"):
        s.hybrid_configs = {"mp_degre": 2}
    with pytest.raises(NotImplementedError):
        s.dgc = True
    s.dgc = False
    assert s.dgc is False


def test_role_maker_and_worker_queries():
    rm = fleet.PaddleCloudRoleMaker(is_collective=True)
    assert rm.is_worker() and not rm.is_server() and rm.worker_num() == 1
    with pytest.raises(NotImplementedError, match="parameter-server"):
        fleet.PaddleCloudRoleMaker(is_collective=False)
    with pytest.raises(NotImplementedError):
        fleet.init_server()
    assert fleet.worker_index() == 0 and fleet.worker_num() == 1
    assert fleet.is_first_worker()
    fleet.barrier_worker()


def test_rng_tracker_seeds_and_swaps_the_default_generator():
    tr = ppl.get_rng_state_tracker()
    ppl.model_parallel_random_seed(7, device="cpu")
    assert tr.seeds_ == {7, 7 + 1024 + 1}      # mp rank 0: JAX's seeds
    before = torch.get_rng_state()
    with tr.rng_state():
        a = torch.rand(4)
    assert torch.equal(torch.get_rng_state(), before)   # restored
    with tr.rng_state():
        b = torch.rand(4)                              # the state went on
    want = torch.Generator().manual_seed(7 + 1025)
    assert torch.equal(torch.cat([a, b]), torch.rand(8, generator=want))
    with tr.rng_state("global_seed"):
        g = torch.rand(3)
    assert torch.equal(g, torch.rand(3, generator=torch.Generator()
                                     .manual_seed(7)))
    with pytest.raises(ValueError, match="already exists"):
        tr.add("other", 7, device="cpu")
    with tr.rng_state("no such state"):
        pass


# -- SegmentLayers and PipelineLayer ----------------------------------------
class Embed(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(2))

    def forward(self, x):
        return x + self.w


class Block(Embed):
    pass


class Head(Embed):
    pass


def _descs(lib, n_blocks, classes):
    e, b, h = classes
    return ([lib.LayerDesc(e)] + [lib.LayerDesc(b) for _ in range(n_blocks)]
            + [lib.LayerDesc(h)])


def _jax_classes():
    class JEmbed(J().paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([2])

        def forward(self, x):
            return x + self.w

    return (type("Embed", (JEmbed,), {}), type("Block", (JEmbed,), {}),
            type("Head", (JEmbed,), {}))


@pytest.mark.parametrize("method", ["uniform", "layer:Block", "layer:Head",
                                    "parameters"])
@pytest.mark.parametrize("n_blocks", [1, 4, 7])
@pytest.mark.parametrize("parts", [1, 2, 3])
def test_segment_layers_match_jax(method, n_blocks, parts):
    jd = _descs(J().pl, n_blocks, _jax_classes())
    pd = _descs(ppl, n_blocks, (Embed, Block, Head))
    if len(jd) < parts:
        return
    want = J().pl.SegmentLayers(jd, parts, method).do_segment()
    assert ppl.SegmentLayers(pd, parts, method).do_segment() == want


def test_pipeline_layer_stages_match_jax():
    jl = J().pl.PipelineLayer(_descs(J().pl, 4, _jax_classes()), num_stages=2)
    pl = ppl.PipelineLayer(_descs(ppl, 4, (Embed, Block, Head)),
                           num_stages=2)
    assert pl.segment_parts == jl.segment_parts
    for i in range(6):
        assert pl.get_stage_from_index(i) == jl.get_stage_from_index(i)
    jn = {n: p.pp_stage for n, p in jl.named_parameters()}
    pn = {n: p.pp_stage for n, p in pl.named_parameters()}
    assert pn == jn
    assert ({s: len(v) for s, v in pl.parameters_by_stage.items()}
            == {s: len(v) for s, v in jl.parameters_by_stage.items()})
    assert torch.equal(pl(torch.zeros(2)), torch.full((2,), 6.0))
    # with JAX's weights: `can_pipeline` and `pipelined_forward` are
    # JAX's (the uniform middle micro-batched, in one process)
    from paddle_tpu_torch.convert import load_reference_state_dict
    from paddle_tpu_torch.optimizer import SGD

    def jax_flat(layer):
        return {n: np.asarray(p._value) for n, p in
                layer.named_parameters()}

    load_reference_state_dict(pl, jax_flat(jl))
    for n in (1, 2, 3, 4, 5):
        assert pl.can_pipeline(n) == jl.can_pipeline(n), n
    rng = np.random.RandomState(0)
    x = rng.randn(4, 2).astype(np.float32)
    y = rng.randn(4, 2).astype(np.float32)
    want = np.asarray(jl.pipelined_forward(J().paddle.to_tensor(x), 2,
                                           2)._value)
    np.testing.assert_allclose(
        pl.pipelined_forward(torch.from_numpy(x), 2, 2).detach().numpy(),
        want, rtol=REL, atol=1e-6)
    # train_batch under a pp 2 mesh with every stage in this process:
    # the micro-batch accumulation path against JAX's compiled GPipe
    # step (pipelined_forward, one update), the same mathematics
    import jax

    import paddle_tpu.optimizer as joptim
    from paddle_tpu.distributed import build_mesh as jbuild

    def sq(out, lab):
        return (out - lab) * (out - lab)

    jl2 = J().pl.PipelineLayer(_descs(J().pl, 4, _jax_classes()),
                               num_stages=2, loss_fn=sq)
    pl2 = ppl.PipelineLayer(_descs(ppl, 4, (Embed, Block, Head)),
                            num_stages=2, loss_fn=sq)
    load_reference_state_dict(pl2, jax_flat(jl2))
    js = J().fleet.DistributedStrategy()
    js.pipeline_configs = {"accumulate_steps": 2}
    ps = fleet.DistributedStrategy()
    ps.pipeline_configs = {"accumulate_steps": 2}
    J().mesh.set_mesh(jbuild({"dp": 1, "pp": 2}, jax.devices()[:2]))
    mesh.set_mesh(mesh.Mesh(np.arange(2).reshape(1, 2), ("dp", "pp")))
    jpp = J().fleet.meta_parallel.PipelineParallel(jl2, None, js)
    pp = fleet.meta_parallel.PipelineParallel(pl2, None, ps)
    jopt = joptim.SGD(0.1, parameters=jl2.parameters())
    popt = SGD(0.1, parameters=pl2.named_parameters())
    for _ in range(2):
        lj = float(np.asarray(jpp.train_batch(
            (J().paddle.to_tensor(x), J().paddle.to_tensor(y)),
            jopt)._value))
        lp = pp.train_batch((torch.from_numpy(x), torch.from_numpy(y)),
                            popt)
        assert abs(float(lp) - lj) <= REL * abs(lj), (float(lp), lj)
    assert jpp._compiled_step is not None     # JAX took its GPipe path
    for n, w in jax_flat(jl2).items():
        np.testing.assert_allclose(
            dict(pl2.named_parameters())[n].detach().numpy(), w,
            rtol=REL, atol=1e-6, err_msg=n)


# -- the mp layers at mp 1 ---------------------------------------------------
def _pair(kind, rng):
    """(JAX layer, port layer, JAX-side input, port input) with the
    JAX layer's weights (and a nonzero bias) in the port's."""
    from paddle_tpu_torch.convert import load_reference_state_dict

    J().paddle.seed(3)
    if kind == "vocab":
        jl = J().pl.VocabParallelEmbedding(24, 8)
        pl = ppl.VocabParallelEmbedding(24, 8, device="cpu")
        x = rng.randint(0, 24, (3, 5)).astype(np.int64)
    elif kind.startswith("column"):
        gather = kind == "column_gather"
        jl = J().pl.ColumnParallelLinear(8, 12, gather_output=gather)
        pl = ppl.ColumnParallelLinear(8, 12, gather_output=gather,
                                      device="cpu")
        x = rng.randn(3, 5, 8).astype(np.float32)
    else:
        bias = kind != "row_nobias"
        jl = J().pl.RowParallelLinear(12, 8, has_bias=bias,
                                   input_is_parallel=kind == "row_parallel")
        pl = ppl.RowParallelLinear(12, 8, has_bias=bias,
                                   input_is_parallel=kind == "row_parallel",
                                   device="cpu")
        x = rng.randn(3, 5, 12).astype(np.float32)
    flat = {}
    for n, p in jl.named_parameters():
        v = np.asarray(p._value)
        if n == "bias":
            v = rng.randn(*v.shape).astype(np.float32)
            p._value = J().paddle.to_tensor(v)._value
        flat[n] = v
    load_reference_state_dict(pl, flat)
    return jl, pl, x


@pytest.mark.parametrize("kind", ["vocab", "column_gather", "column_local",
                                  "row", "row_parallel", "row_nobias"])
def test_mp_layer_at_mp1_matches_jax(kind):
    rng = np.random.RandomState(0)
    jl, pl, x = _pair(kind, rng)
    for n, p in pl.named_parameters():
        assert p.dist_spec == (None if getattr(jl, n).dist_spec is None
                               else tuple(getattr(jl, n).dist_spec)), n
    grad_x = kind != "vocab"
    jx = J().paddle.to_tensor(x, stop_gradient=not grad_x)
    px = torch.from_numpy(x).requires_grad_(grad_x)
    jo, po = jl(jx), pl(px)
    c = rng.randn(*jo.shape).astype(np.float32)
    (jo * J().paddle.to_tensor(c)).sum().backward()
    named = list(pl.named_parameters())
    leaves = [p for _, p in named] + ([px] if grad_x else [])
    grads = torch.autograd.grad((po * torch.from_numpy(c)).sum(), leaves)

    def close(got, want, name):
        want = np.asarray(want)
        err = float(np.abs(got.detach().numpy() - want).max())
        assert err <= REL * max(float(np.abs(want).max()), 1e-30), (name, err)

    close(po, np.asarray(jo._value), "out")
    for (n, _), g in zip(named, grads):
        close(g, np.asarray(getattr(jl, n).grad._value), n)
    if grad_x:
        close(grads[-1], np.asarray(jx.grad._value), "x")


def test_parallel_cross_entropy_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, 10).astype(np.float32)
    labels = rng.randint(0, 10, (2, 6)).astype(np.int64)
    labels[0, :2] = -100
    want = np.asarray(J().pl.ParallelCrossEntropy()(
        J().paddle.to_tensor(logits), J().paddle.to_tensor(labels))._value)
    got = ppl.ParallelCrossEntropy()(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    assert tuple(got.shape) == want.shape == (2, 6, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=1e-6)
    assert float(got[0, 0, 0]) == 0.0


def test_shard_and_unshard_are_inverse_and_per_block():
    w = np.arange(4 * 12).reshape(4, 12)
    pieces = [ppl.mp_layers.shard(w, 1, 3, 2, r) for r in range(2)]
    # rank 0 holds the first half of each of the three blocks
    assert pieces[0].tolist() == np.concatenate(
        [w[:, 0:2], w[:, 4:6], w[:, 8:10]], axis=1).tolist()
    np.testing.assert_array_equal(ppl.mp_layers.unshard(pieces, 1, 3), w)
    t = torch.from_numpy(w)
    assert torch.equal(ppl.mp_layers.unshard(
        [ppl.mp_layers.shard(t, 0, 1, 4, r) for r in range(4)], 0, 1), t)
    with pytest.raises(ValueError, match="does not split"):
        ppl.mp_layers.shard(w, 1, 3, 3, 0)


# -- distributed_model ----------------------------------------------------------
@pytest.mark.parametrize("hybrid,pipeline_layer,want", [
    (None, False, "DataParallel"),
    ({"dp_degree": 1}, False, "DataParallel"),
    ({"dp_degree": 1, "mp_degree": 2}, False, "TensorParallel"),
    ({"dp_degree": 1, "pp_degree": 2}, True, "PipelineParallel"),
    ({"dp_degree": 1, "pp_degree": 2}, False, "DataParallel"),
    ({"dp_degree": 1, "pp_degree": 2, "mp_degree": 2}, True,
     "PipelineParallel"),
])
def test_distributed_model_picks_the_jax_wrapper(hybrid, pipeline_layer,
                                                 want):
    def build(lib, classes, flt):
        if hybrid is not None:
            s = flt.DistributedStrategy()
            s.hybrid_configs = hybrid
            flt.init(is_collective=True, strategy=s)
        if pipeline_layer:
            return lib.PipelineLayer(_descs(lib, 2, classes), num_stages=2)
        return classes[1]()

    J().fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    jw = J().fleet.distributed_model(build(J().pl, _jax_classes(), J().fleet))
    pw = fleet.distributed_model(build(ppl, (Embed, Block, Head), fleet))
    J().fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    assert type(jw).__name__ == type(pw).__name__ == want
    assert fleet.is_initialized() == (hybrid is not None)
    x = torch.zeros(2)
    assert torch.equal(pw(x), pw._layers(x))


def test_distributed_model_refuses_sharding():
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    assert fleet.get_hybrid_communicate_group().get_parallel_mode() == \
        "sharding_parallel"
    with pytest.raises(NotImplementedError, match="ShardingParallel"):
        fleet.distributed_model(Block())
    opt = fleet.distributed_optimizer(torch.optim.SGD(Block().parameters(),
                                                      lr=0.1), s)
    assert opt.param_groups[0]["lr"] == 0.1


def test_mesh_compiler_refuses_a_group_too():
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD

    m = Block()
    with pytest.raises(ValueError, match="not both"):
        DistributedTrainStepCompiler(
            m, SGD(0.1, parameters=m.parameters()),
            mesh=mesh.build_mesh({"dp": 1}), group=object())


# -- two gloo ranks -------------------------------------------------------------
def _dp_rank(out_dir):
    from paddle_tpu_torch.distributed import DataParallel, get_rank
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD

    r = get_rank()
    res = {}
    net = Linear(4, 3, device="cpu",
                 generator=torch.Generator().manual_seed(10 + r))
    res["before"] = net.weight.detach().numpy().copy()
    dp = DataParallel(net)
    res["after_wrap"] = net.weight.detach().numpy().copy()
    x = torch.from_numpy(np.random.RandomState(r).randn(5, 4).astype(
        np.float32))
    res["x"] = x.numpy()
    dp(x).square().sum().backward()
    res["grad"] = net.weight.grad.numpy().copy()
    net.weight.grad = None
    with dp.no_sync():
        dp(x).square().sum().backward()
    res["local_grad"] = net.weight.grad.numpy().copy()
    # mesh groups over the two ranks: one subgroup a line
    m = mesh.build_mesh({"dp": 2, "mp": 1})
    g = m.group(("dp",))
    res["dp_ranks"] = np.array(g.ranks)
    res["mp_ranks"] = np.array(m.group(("mp",)).ranks)
    t = torch.tensor([float(r + 1)])
    torch.distributed.all_reduce(t, group=g.process_group)
    res["dp_sum"] = t.numpy()
    # the compressed wire refuses a tensor-parallel layer's dist_spec
    col = ppl.ColumnParallelLinear(4, 4, device="cpu")
    step = DistributedTrainStepCompiler(
        col, SGD(0.1, parameters=col.parameters()),
        loss_fn=lambda out, y: (out - y).square().mean(), mesh=m,
        comm_compress="int8")
    try:
        step(torch.zeros(2, 4), torch.zeros(2, 4))
        res["refused"] = np.array([""])
    except ValueError as e:
        res["refused"] = np.array([str(e)])
    np.savez(os.path.join(out_dir, f"dp_r{r}.npz"), **res)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fleet_dp"))
    spawn(_dp_rank, args=(tmp,), nprocs=2, device="cpu",
          init_method=f"file://{tmp}/store", join=False).join(timeout=240)
    return [dict(np.load(os.path.join(tmp, f"dp_r{r}.npz")))
            for r in range(2)]


def test_data_parallel_broadcasts_and_averages(dp_runs):
    r0, r1 = dp_runs
    assert not np.array_equal(r0["before"], r1["before"])
    for r in dp_runs:
        np.testing.assert_array_equal(r["after_wrap"], r0["before"])
    w = r0["before"]                   # the bias is zeros on both ranks
    local = [2 * r["x"].T @ (r["x"] @ w) for r in dp_runs]
    for r, lg in zip(dp_runs, local):
        np.testing.assert_allclose(r["local_grad"], lg, rtol=1e-5,
                                   atol=1e-6)
    mean = (local[0] + local[1]) / 2
    for r in dp_runs:
        np.testing.assert_allclose(r["grad"], mean, rtol=1e-6,
                                   atol=1e-6 * np.abs(mean).max())
    np.testing.assert_array_equal(r0["grad"], r1["grad"])


def test_mesh_groups_over_two_ranks(dp_runs):
    for r, res in enumerate(dp_runs):
        assert res["dp_ranks"].tolist() == [0, 1]
        assert res["mp_ranks"].tolist() == [r]
        assert res["dp_sum"].tolist() == [3.0]


def test_compressed_wire_refuses_a_tensor_parallel_layout(dp_runs):
    for res in dp_runs:
        assert "dist_spec" in str(res["refused"][0])
