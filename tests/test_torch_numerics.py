"""The port's numerics probe (`paddle_tpu_torch.monitor.numerics`) and
precision audits (`paddle_tpu_torch.analysis.precision`) held against
the JAX package's: stats_tree of the same arrays equals JAX's (absmax
over finite values, smallest nonzero magnitude, non-finite count),
observe() of the same stats writes the same gauges, counters and
findings, PTA092 and PTA093 raise armed and report under
PADDLE_ANALYSIS=1 in JAX's cases; the probe in TrainStepCompiler
writes the numerics/* gauges, and disarmed the step is bit-identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.analysis import precision as jprecision
from paddle_tpu.core import monitor as jcore
from paddle_tpu.monitor import numerics as jnumerics
from paddle_tpu.monitor import sanitize as jsan

from paddle_tpu_torch import amp
from paddle_tpu_torch.analysis import precision
from paddle_tpu_torch.core import monitor as core
from paddle_tpu_torch.monitor import numerics, sanitize


@pytest.fixture(autouse=True)
def _clean():
    for mod in (sanitize, jsan):
        mod.disarm()
        mod.clear_findings()
    numerics.clear()
    jnumerics.clear()
    yield
    for mod in (sanitize, jsan):
        mod.disarm()
        mod.clear_findings()


def _tree(rng):
    a = rng.randn(5, 7).astype(np.float32) * 100
    a[0, 0] = np.inf
    a[1, 2] = -np.inf
    a[2, 3] = np.nan
    b = np.zeros((3,), np.float32)
    c = (rng.rand(4, 4) * 1e-3).astype(np.float16)
    c[0, 0] = 0
    d = np.full((2, 2), np.nan, np.float32)
    tiny = np.array([1e-30, -2e-38, 0.0], np.float32)
    return {"loss": np.float32(3.5) * np.ones((), np.float32),
            "grad": {"w": a, "b": b, "h": c},
            "param": [d, tiny],
            "ints": np.arange(4), "empty": np.zeros((0,), np.float32)}


def test_stats_tree_matches_jax():
    tree = _tree(np.random.RandomState(0))
    got = {k: v.numpy() for k, v in numerics.stats_tree(tree).items()}
    jtree = {"loss": jnp.asarray(tree["loss"]),
             "grad": {k: jnp.asarray(v) for k, v in tree["grad"].items()},
             "param": [jnp.asarray(v) for v in tree["param"]],
             "ints": jnp.asarray(tree["ints"]),
             "empty": jnp.asarray(tree["empty"])}
    want = {k: np.asarray(v) for k, v in
            jnumerics.stats_tree(jtree).items()}
    assert sorted(got) == sorted(want) == [
        "grad/b", "grad/h", "grad/w", "loss", "param/0", "param/1"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["grad/w"][2] == 3 and got["param/0"][0] == 0


def test_stats_tree_of_torch_tensors():
    t = torch.tensor([[0.0, -4.0], [float("inf"), 0.5]],
                     dtype=torch.bfloat16)
    got = numerics.stats_tree({"x": t, "i": torch.arange(3)})
    assert list(got) == ["x"]
    assert got["x"].tolist() == [4.0, 0.5, 1.0]


def _obs_stats(rng):
    return {"loss": np.array([2.0, 0.5, 0.0], np.float32),
            "grad/a": np.array([[7e4, 1e-3, 0], [1.0, 2e-3, 0]],
                               np.float32),
            "grad/b": np.array([5.0, 0.0, 3.0], np.float32),
            "param/c": rng.rand(4, 3).astype(np.float32)}


def test_observe_matches_jax():
    sanitize.configure("numerics:sample=2")
    jsan.configure("numerics:sample=2")
    core.registry.reset_all()
    jcore.registry.reset_all()
    for i in range(5):
        s = _obs_stats(np.random.RandomState(i))
        got = numerics.observe(
            {k: torch.from_numpy(v) for k, v in s.items()}, step=i)
        want = jnumerics.observe(s, step=i)
        assert got == want
    pick = ("numerics/", "analysis/PTA092", "sanitize/findings")

    def stats(reg):
        return {k: v for k, v in reg.snapshot().items()
                if k.startswith(pick)}

    assert stats(core.registry) == stats(jcore.registry)
    assert core.registry.snapshot_histograms()["numerics/hist/absmax"] \
        == jcore.registry.snapshot_histograms()["numerics/hist/absmax"]
    assert [(f.code, f.message) for f in sanitize.findings()] == \
        [(f.code, f.message) for f in jsan.findings()]
    d, jd = numerics.describe(), jnumerics.describe()
    assert d == jd and d["observations"] == 5 and d["sample"] == 2


@pytest.mark.parametrize("dtypes,scaler,mp", [
    ({"w": "float16"}, None, False), ({"w": "float16"}, object(), False),
    ({"w": "float16"}, None, True), ({"w": "bfloat16"}, None, False),
    ({"w": "float32", "v": "float16"}, None, False)])
@pytest.mark.parametrize("mode", ["armed", "analysis", "off"])
def test_pta093_like_jax(dtypes, scaler, mp, mode, monkeypatch):
    if mode == "armed":
        sanitize.configure("numerics")
        jsan.configure("numerics")
    if mode == "analysis":
        monkeypatch.setenv("PADDLE_ANALYSIS", "1")

    def run(fn):
        try:
            return fn(dtypes, scaler, mp, where="step")
        except ValueError as e:
            return str(e)

    assert run(precision.audit_train_precision) == \
        run(jprecision.audit_train_precision)
    assert [(f.code, f.message) for f in sanitize.findings()] == \
        [(f.code, f.message) for f in jsan.findings()]


@pytest.mark.parametrize("dtype,white", [
    ("float16", ["softmax"]), ("float16", ["matmul"]),
    ("bfloat16", ["softmax"]), ("float16", ["exp", "layer_norm"])])
@pytest.mark.parametrize("mode", ["armed", "analysis", "off"])
def test_pta092_like_jax(dtype, white, mode, monkeypatch):
    if mode == "armed":
        sanitize.configure("numerics")
        jsan.configure("numerics")
    if mode == "analysis":
        monkeypatch.setenv("PADDLE_ANALYSIS", "1")

    def run(fn):
        try:
            return fn(dtype, white)
        except ValueError as e:
            return str(e)

    assert run(precision.audit_autocast) == run(jprecision.audit_autocast)
    assert [(f.code, f.message) for f in sanitize.findings()] == \
        [(f.code, f.message) for f in jsan.findings()]
    if mode == "armed" and dtype == "float16" and "matmul" not in white:
        with pytest.raises(ValueError, match="PTA092"):
            with amp.auto_cast(dtype=dtype, custom_white_list=white):
                pass


def test_pta093_in_the_train_step():
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD

    sanitize.configure("numerics")
    net = torch.nn.Linear(4, 2).half()
    step = TrainStepCompiler(net, SGD(0.1, parameters=net.parameters()),
                             lambda o, y: o.float().sum())
    x = torch.ones(3, 4, dtype=torch.float16)
    with pytest.raises(ValueError, match="PTA093"):
        step(x, x)
    assert "PTA093" in {f.code for f in sanitize.findings()}


def _gpt_step(seed=0):
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    m = GPTForCausalLM(GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
        ffn_hidden=64, max_seq_len=16, dropout=0.0), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    return m, TrainStepCompiler(m, AdamW(1e-3, parameters=m.parameters()),
                                accumulate_steps=2, steps_per_dispatch=2)


def test_probe_in_the_train_step_and_bit_identity():
    ids = torch.from_numpy(np.random.RandomState(0)
                           .randint(0, 64, (2, 2, 16)))
    sanitize.configure("numerics:sample=1")
    m, step = _gpt_step()
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    armed = [step(ids, ids).tolist() for _ in range(2)]
    sanitize.disarm()
    m2, plain_step = _gpt_step()
    plain = [plain_step(ids, ids).tolist() for _ in range(2)]
    assert armed == plain
    for (n, p), p2 in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(p, p2), n
    d = numerics.describe()
    assert d["observations"] == 2
    assert set(d["last"]) == {"loss"} | {f"grad/{n}" for n in params} \
        | {f"param/{n}" for n in params}
    # the first dispatch's first microstep saw the initial parameters
    w = "gpt.wte"
    assert core.stat_get(f"numerics/param/{w}/absmax") >= 1
    assert d["last"]["loss"]["absmax"] > 0
    assert not plain_step._numerics_built and step._numerics_built
