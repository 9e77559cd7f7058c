"""The port's GPT-2 held against the JAX package's, and the port's
import boundary.

The JAX model's parameter tree goes through numpy into the port
(`paddle_tpu_torch.convert`); the same ids then go through
`_k_gpt_forward` and the port's `GPTForCausalLM.forward` on the CPU.
Tolerance: 1e-5 of the largest logit — f32 throughout, the two differ
only in the summation order of their matrix products and reductions.
"""
import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving.model_runner import extract_params
from paddle_tpu.text.models import gpt as jax_gpt

from paddle_tpu_torch.convert import load_reference_params, params_from_numpy
from paddle_tpu_torch.text.models import gpt as port_gpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            ffn_hidden=128, max_seq_len=64, dropout=0.0)


def _models(init=0.35):
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(
        use_flash_attention=False, initializer_range=init, **TINY))
    jm.eval()
    params, _ = extract_params(jm)
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = port_gpt.GPTForCausalLM(
        port_gpt.GPTConfig(initializer_range=init, **TINY), device="cpu")
    load_reference_params(pm, tree)
    return jm, params, pm


@pytest.mark.parametrize("init", [0.02, 0.35])
def test_logits_match_jax_forward(init):
    _, params, pm = _models(init)
    ids = np.random.RandomState(1).randint(0, 128, (2, 40)).astype(np.int32)
    want = np.asarray(jax_gpt._k_gpt_forward(ids, params, 4, 1e-5, False,
                                             False))
    got = pm(torch.from_numpy(ids)).detach()    # the forward now trains
    assert got.shape == (2, 40, 128) and got.dtype == torch.float32
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the explicit plain path computes the same on the CPU
    c = pm.config
    plain = port_gpt.gpt_forward(torch.from_numpy(ids), pm.gpt.params_tree(),
                                 c.num_heads, c.layer_norm_eps,
                                 use_kernel=False)
    assert torch.equal(plain, got)


def test_parameter_names_and_shapes_match_jax_tree():
    _, params, pm = _models()
    flat = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    own = dict(pm.gpt.named_parameters())
    assert set(flat) == set(own)
    for name, t in flat.items():
        assert tuple(t.shape) == tuple(own[name].shape), name
        assert torch.equal(own[name].detach(), t), name
    assert own["blocks.qkv_w"].shape == (2, 64, 192)   # x @ W, [L, H, 3H]


def test_load_reference_params_rejects_mismatch():
    _, params, pm = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    bad = dict(tree, wte=tree["wte"][:, :32])
    with pytest.raises(ValueError, match="wte"):
        load_reference_params(pm, bad)
    missing = {k: v for k, v in tree.items() if k != "lnf_b"}
    with pytest.raises(ValueError, match="missing"):
        load_reference_params(pm, missing)


def test_init_is_seeded_and_scaled():
    cfg = port_gpt.GPTConfig(initializer_range=0.02, **TINY)

    def build(seed):
        gen = torch.Generator().manual_seed(seed)
        return port_gpt.GPTForCausalLM(cfg, device="cpu", generator=gen)

    a, b, c = build(3), build(3), build(4)
    for (name, pa), (_, pb), (_, pc) in zip(a.gpt.named_parameters(),
                                            b.gpt.named_parameters(),
                                            c.gpt.named_parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.gpt.wte, c.gpt.wte)
    blocks = a.gpt.blocks
    assert torch.equal(blocks["ln1_w"], torch.ones(2, 64))
    assert torch.equal(blocks["qkv_b"], torch.zeros(2, 192))
    # proj_w / fc2_w are drawn at std / sqrt(2L)
    ratio = float(blocks["fc1_w"].detach().std()
                  / blocks["fc2_w"].detach().std())
    assert 1.6 < ratio < 2.4


def test_gelu_is_tanh_and_attention_masks_at_minus_1e30():
    """Two places a straight translation goes wrong: jax.nn.gelu is the
    tanh form, and the causal mask is -1e30, not -inf."""
    x = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(x)), rtol=1e-6, atol=1e-6)
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 7, 64).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_gpt._attention(q, k, v, 4, use_flash=False))
    got = port_gpt._attention(*(torch.from_numpy(a) for a in (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _imports(path):
    """Every module name an `import` in the file names, at any depth."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _port_sources():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                             "chip_mutants.py")]
    for root, _, fs in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    return files


def _foreign(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def test_port_sources_import_no_jax_or_paddle_tpu():
    files = _port_sources()
    assert len(files) > 10
    bad = {os.path.relpath(f, REPO): [n for n in _imports(f) if _foreign(n)]
           for f in files}
    assert not {f: n for f, n in bad.items() if n}


def test_port_import_loads_no_jax_or_paddle_tpu_module():
    """Importing the whole port adds no jax / paddle_tpu module to
    sys.modules (checked in a fresh interpreter, against what it had
    loaded before)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import importlib, pkgutil, paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
        "'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "print(len(new), sorted(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
