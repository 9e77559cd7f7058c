"""The port's public signatures against the JAX package's.

For every module of the port whose path the JAX package also has, each
name the port exports there (`__all__`, else its public `dir()`) that
the JAX module defines too is compared: a function's parameters, or a
class's `__init__`'s. The port's positional parameters (positional-only
and positional-or-keyword) must be a prefix, by name, of the
reference's, so a Paddle-style positional call never lands on another
parameter. Parameters that belong only to the port (`device`,
`generator`, `compress`, ...) are keyword-only. Names the JAX module
takes from another library (`jax.sharding.Mesh`) are not the
reference's own and are skipped. One case per module.

Then the three probes that showed the shift, each against JAX:
`cross_entropy(input, label, weight)`, `Embedding(num, dim,
padding_idx)` and `all_reduce(tensor, op, group, sync_op)`.
"""
import importlib
import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch

_ROOT = os.path.dirname(paddle_tpu_torch.__file__)
_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _port_modules():
    out = []
    for root, dirs, files in os.walk(_ROOT):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("csrc", "__pycache__"))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), _ROOT)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append(".".join(["paddle_tpu_torch"] + parts))
    return out


def _reference_path(mod):
    return "paddle_tpu" + mod[len("paddle_tpu_torch"):]


def _has_reference(mod):
    try:
        return importlib.util.find_spec(_reference_path(mod)) is not None
    except ModuleNotFoundError:
        return False


MODULES = [m for m in _port_modules() if _has_reference(m)]


def _positional(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values() if p.kind in _POS]


def _pairs(port_mod, ref_mod):
    names = getattr(port_mod, "__all__", None) or [
        n for n in dir(port_mod) if not n.startswith("_")]
    for name in names:
        if not hasattr(ref_mod, name):
            continue
        a, b = getattr(port_mod, name), getattr(ref_mod, name)
        if inspect.ismodule(a) or not callable(a) or not callable(b):
            continue
        if not getattr(b, "__module__", "").startswith("paddle_tpu"):
            continue            # the reference took it from a library
        if inspect.isclass(a) != inspect.isclass(b):
            continue
        if inspect.isclass(a):
            a, b = a.__init__, b.__init__
        yield name, a, b


def test_modules_found():
    """The walk sees the port's modules that mirror the reference's,
    the serving package, the monitor planes, the tensor API's op
    modules, `core` and the `nn` layers among them."""
    assert len(MODULES) >= 75
    for m in ("paddle_tpu_torch",
              "paddle_tpu_torch.core.dtype",
              "paddle_tpu_torch.core.engine",
              "paddle_tpu_torch.core.tensor",
              "paddle_tpu_torch.ops",
              "paddle_tpu_torch.ops.creation",
              "paddle_tpu_torch.ops.math",
              "paddle_tpu_torch.ops.logic",
              "paddle_tpu_torch.ops.manipulation",
              "paddle_tpu_torch.ops.linalg",
              "paddle_tpu_torch.ops.search",
              "paddle_tpu_torch.ops.random",
              "paddle_tpu_torch.ops.activation",
              "paddle_tpu_torch.nn",
              "paddle_tpu_torch.nn.param_attr",
              "paddle_tpu_torch.nn.layer.layers",
              "paddle_tpu_torch.nn.layer.activation",
              "paddle_tpu_torch.nn.layer.transformer",
              "paddle_tpu_torch.framework",
              "paddle_tpu_torch.nn.functional",
              "paddle_tpu_torch.inference.serving.router",
              "paddle_tpu_torch.inference.serving.autoscaler",
              "paddle_tpu_torch.monitor.alerts",
              "paddle_tpu_torch.monitor.flight",
              "paddle_tpu_torch.monitor.trace",
              "paddle_tpu_torch.distributed.collective"):
        assert m in MODULES, m


@pytest.mark.parametrize("mod", MODULES)
def test_positional_parameters_are_a_prefix(mod):
    port_mod = importlib.import_module(mod)
    ref_mod = importlib.import_module(_reference_path(mod))
    bad = []
    for name, a, b in _pairs(port_mod, ref_mod):
        pa, pb = _positional(a), _positional(b)
        if pa is None or pb is None:
            continue
        if pb[:len(pa)] != pa:
            bad.append(f"{name}: port {pa} vs reference {pb}")
    assert not bad, "\n".join(bad)


# -- the probes -------------------------------------------------------

def test_probe_weighted_cross_entropy():
    """`cross_entropy(input, label, weight)` with the weight third:
    2.15674 on both sides (the unweighted loss would be 2.08477)."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as PF

    rng = np.random.RandomState(0)
    logits = rng.randn(4, 4).astype(np.float32)
    labels = rng.randint(0, 4, (4,)).astype(np.int64)
    w = np.array([1, 2, 0.5, 3], np.float32)
    want = float(JF.cross_entropy(paddle.to_tensor(logits),
                                  paddle.to_tensor(labels),
                                  paddle.to_tensor(w)).numpy())
    got = float(PF.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(w)))
    assert abs(want - 2.15674) < 1e-5
    assert abs(got - want) < 1e-6
    unweighted = float(PF.cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels)))
    assert abs(unweighted - 2.08477) < 1e-5
    for red in ("sum", "none"):
        jv = JF.cross_entropy(paddle.to_tensor(logits),
                              paddle.to_tensor(labels),
                              paddle.to_tensor(w), reduction=red).numpy()
        pv = PF.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(w), reduction=red).numpy()
        np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="soft_label"):
        PF.cross_entropy(torch.from_numpy(logits),
                         torch.from_numpy(labels), soft_label=True)


def test_probe_embedding_padding_idx():
    """`Embedding(10, 4, 0)`: the third parameter is `padding_idx` on
    both sides — row 0 starts at zero, looks up zeros and takes no
    gradient."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as pnn

    je = jnn.Embedding(10, 4, 0)
    pe = pnn.Embedding(10, 4, 0, device="cpu")
    assert np.all(je.weight.numpy()[0] == 0)
    assert torch.all(pe.weight[0] == 0)
    ids = np.array([[0, 3, 0, 7]], np.int64)
    with torch.no_grad():
        pe.weight.copy_(torch.from_numpy(je.weight.numpy().copy()))
        pe.weight[0] = 1.0          # a nonzero padding row still masks
    jw = je.weight.numpy().copy()
    jw[0] = 1.0
    je.weight.set_value(jw)
    jout = je(paddle.to_tensor(ids)).numpy()
    pout = pe(torch.from_numpy(ids))
    np.testing.assert_array_equal(pout.detach().numpy(), jout)
    assert np.all(jout[0, 0] == 0) and np.all(jout[0, 2] == 0)
    pout.sum().backward()
    assert torch.all(pe.weight.grad[0] == 0)
    assert torch.all(pe.weight.grad[3] == 1)


def test_probe_all_reduce_sync_op(monkeypatch):
    """`all_reduce(t, op, g, True)`: the fourth parameter is `sync_op`
    on both sides, so with PADDLE_COMM_COMPRESS set the call still
    takes the plain wire (`compress` comes fifth, as in the reference).
    The world is faked at 2 ranks with the wire recorded."""
    from paddle_tpu.distributed import collective as jcol
    from paddle_tpu_torch.distributed import collective as pcol

    for fn in (jcol.all_reduce, pcol.all_reduce):
        bound = inspect.signature(fn).bind(
            "t", jcol.ReduceOp.SUM, None, True)
        assert bound.arguments["sync_op"] is True
        assert "compress" not in bound.arguments
    monkeypatch.setenv("PADDLE_COMM_COMPRESS", "int8")
    monkeypatch.setattr(pcol, "group_size", lambda group=None: 2)

    def _no_quantized(*a, **k):
        raise AssertionError("took the compressed wire")

    wire = []
    monkeypatch.setattr(pcol, "_quantized_all_reduce", _no_quantized)
    monkeypatch.setattr(pcol.dist, "all_reduce",
                        lambda t, op, group=None: wire.append(op))
    t = torch.ones(1024)
    out = pcol.all_reduce(t, pcol.ReduceOp.SUM, None, True)
    assert out is t and len(wire) == 1
    # and the compressed wire is still there when asked for by name
    with pytest.raises(AssertionError, match="compressed"):
        pcol.all_reduce(t, pcol.ReduceOp.SUM, None, compress=True)


def test_donate_form_not_semantics():
    """`donate` sits at the reference's position in `LLMEngine` and
    `TrainStepCompiler`; True is what the port always does (in-place
    updates) and False raises by name."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD

    net = Linear(2, 2, device="cpu")
    opt = SGD(0.1, parameters=net.parameters())
    with pytest.raises(NotImplementedError, match="donate"):
        TrainStepCompiler(net, opt, None, False)
    TrainStepCompiler(net, opt, None, True)
    with pytest.raises(NotImplementedError, match="donate"):
        LLMEngine(None, donate=False, device="cpu")
