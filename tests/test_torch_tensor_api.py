"""The port's public tensor API against the JAX package's.

- The registry gate: every name of the eight JAX `ops` modules'
  `__all__` (`creation`, `math`, `logic`, `manipulation`, `linalg`,
  `search`, `random`, `activation`) is in the port's module of the same
  path, and every name of the JAX root's op surface (`ops.PUBLIC_OPS`,
  the dtypes, `to_tensor`, the autograd switches, `seed` and the rng
  state, the default dtype) is at the port's root, or sits in
  `EXEMPT` with the reason ROADMAP repeats.
- One case per op call (the rows of `tests/torch_op_cases.py`, which
  `chip_smoke.py` also runs on the card): the same numpy inputs (the
  JAX op tests' own arrays, imported from `tests/test_op_coverage.py`
  and `tests/test_op_sweep.py`) through both packages on the CPU, held
  at the case's stated tolerance: integers, bools, indices, sorts and
  `unique` bit for bit; f32 elementwise within 1e-6 (relative, with an
  absolute floor of the same size); transcendentals, reductions and
  statistics within 1e-5; linear algebra within 1e-4, decompositions
  by reconstruction. Dtypes are compared under the port's width policy:
  where JAX (x64 off) gives int32 or float32 for an int64 or float64
  request, the port gives int64 or float64; every other dtype is equal.
- Gradients of the differentiable ones through `torch.autograd` against
  the JAX package's tape (`paddle_tpu.grad`), with the same seeded
  cotangent, within 1e-4 x max|g| (1e-3 for linear algebra).
- Random ops: shape, dtype, range, seeded determinism, the rng state's
  round trip, and moments on 10^5 draws at stated bounds, never values
  (Philox is not threefry: ROADMAP queue 3 #31).
- The autograd switches, `to_tensor`, the default dtype, the in-place
  variants and what torch refuses of them.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch import ops as pops

import torch_op_cases
from test_op_coverage import A, B_, B34, C34, I4, IMG, IMG3D, POS, SPD, SQ, V4
from test_op_sweep import POS34, UNIT34, X34, X234

MODULES = ["creation", "math", "logic", "manipulation", "linalg", "search",
           "random", "activation"]

_CONV = ("ROADMAP queue 1 item 7: the ops/conv leftovers (1-D / 3-D "
         "pooling, transposed convolutions, adaptive max pools, vision "
         "ops) are not ported")
_NORM = ("ROADMAP queue 1 item 7: the ops/norm_ops leftovers (group, "
         "instance, RMS and local response norms, normalize) are not "
         "ported")
_LOSS = ("ROADMAP queue 1 item 7: the ops/loss_ops leftovers (every loss "
         "but cross_entropy and softmax_with_cross_entropy) are not "
         "ported")
EXEMPT = {
    "next_key": ("ROADMAP queue 3 #31: the JAX package's threefry key "
                 "plumbing; a torch generator holds its own state"),
}
for _n in ("adaptive_avg_pool1d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "affine_grid", "avg_pool1d", "avg_pool3d",
           "channel_shuffle", "conv1d_transpose", "conv2d_transpose",
           "conv3d_transpose", "grid_sample", "max_pool1d", "max_pool3d",
           "pixel_shuffle", "pixel_unshuffle"):
    EXEMPT[_n] = _CONV
for _n in ("group_norm", "instance_norm", "local_response_norm",
           "normalize", "rms_norm"):
    EXEMPT[_n] = _NORM
for _n in ("binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_embedding_loss", "cosine_similarity", "ctc_loss",
           "dice_loss", "gaussian_nll_loss", "hinge_embedding_loss",
           "kl_div", "l1_loss", "label_smooth", "log_loss",
           "margin_ranking_loss", "mse_loss", "multi_label_soft_margin_loss",
           "nll_loss", "npair_loss", "poisson_nll_loss", "sigmoid_focal_loss",
           "smooth_l1_loss", "soft_margin_loss", "square_error_cost",
           "triplet_margin_loss", "triplet_margin_with_distance_loss"):
    EXEMPT[_n] = _LOSS

ROOT_EXTRA = ["bfloat16", "float16", "float32", "float64", "int8", "int16",
              "int32", "int64", "uint8", "bool8", "complex64", "complex128",
              "to_tensor", "no_grad", "enable_grad", "set_grad_enabled",
              "is_grad_enabled", "grad", "seed", "get_rng_state",
              "set_rng_state", "set_default_dtype", "get_default_dtype",
              "get_flags", "set_flags"]


_IMPORTED = dict(A=A, B_=B_, B34=B34, C34=C34, I4=I4, IMG=IMG, IMG3D=IMG3D,
                 POS=POS, SPD=SPD, SQ=SQ, V4=V4, POS34=POS34, UNIT34=UNIT34,
                 X34=X34, X234=X234)


@pytest.mark.parametrize("name", torch_op_cases.NAMES)
def test_op_case_inputs_equal_the_jax_tests_arrays(name):
    """`torch_op_cases.inputs()` (the copy chip_smoke reads) rebuilds
    each array the JAX op tests define, bit for bit and in its dtype."""
    assert set(torch_op_cases.NAMES) == set(_IMPORTED)
    got, want = torch_op_cases.inputs()[name], _IMPORTED[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mod", MODULES)
def test_registry_module_names(mod):
    jm = importlib.import_module("paddle_tpu.ops." + mod)
    pm = importlib.import_module("paddle_tpu_torch.ops." + mod)
    missing = [n for n in jm.__all__ if not hasattr(pm, n)
               and n not in EXEMPT]
    assert not missing, missing
    assert all(n in jm.__all__ or n in J.ops.PUBLIC_OPS for n in EXEMPT)


def test_registry_root_surface():
    missing = [n for n in list(J.ops.PUBLIC_OPS) + ROOT_EXTRA
               if not hasattr(P, n) and n not in EXEMPT]
    assert not missing, missing
    # every exemption is still missing: a ported op leaves the list
    assert [n for n in EXEMPT if hasattr(P, n)] == []
    assert P.linalg is pops.linalg
    for n in ("abs", "sum", "max", "min", "all", "any", "round", "pow"):
        assert getattr(P, n) is pops.PUBLIC_OPS[n]


# -- the op table ----------------------------------------------------------

CASES = torch_op_cases.cases(
    A=A, B_=B_, B34=B34, C34=C34, I4=I4, IMG=IMG, IMG3D=IMG3D, POS=POS,
    SPD=SPD, SQ=SQ, V4=V4, POS34=POS34, UNIT34=UNIT34, X34=X34, X234=X234)
TOL = torch_op_cases.TOL
W3 = np.random.RandomState(4).randn(4, 3).astype(np.float32)

_IDS = [c[0] for c in CASES]
assert len(set(_IDS)) == len(_IDS)


def _is_tensor_arg(a):
    return isinstance(a, (np.ndarray, np.generic)) and not isinstance(
        a, (str, bytes))


def _jax_args(args, grad=False):
    out, leaf = [], None
    for a in args:
        if isinstance(a, list) and a and all(_is_tensor_arg(v) for v in a):
            ts = [J.to_tensor(v) for v in a]
            if grad and leaf is None and a[0].dtype.kind == "f":
                ts[0] = leaf = J.to_tensor(a[0], stop_gradient=False)
            out.append(ts)
        elif _is_tensor_arg(a):
            t = J.to_tensor(a, stop_gradient=not (grad and leaf is None
                                                  and a.dtype.kind == "f"))
            if leaf is None and not t.stop_gradient:
                leaf = t
            out.append(t)
        else:
            out.append(a)
    return out, leaf


def _port_args(args, grad=False):
    out, leaf = [], None
    for a in args:
        if isinstance(a, list) and a and all(_is_tensor_arg(v) for v in a):
            ts = [torch.from_numpy(np.array(v)) for v in a]
            if grad and leaf is None and a[0].dtype.kind == "f":
                leaf = ts[0].requires_grad_(True)
            out.append(ts)
        elif _is_tensor_arg(a):
            t = torch.from_numpy(np.array(a))
            if grad and leaf is None and a.dtype.kind == "f":
                t.requires_grad_(True)
                leaf = t
            out.append(t)
        else:
            out.append(a)
    return out, leaf


def _port_kwargs(fn, kwargs):
    kw = dict(kwargs)
    if "device" in inspect.signature(fn).parameters:
        kw["device"] = "cpu"
    return kw


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [x]


_WIDER = {("int32", "int64"), ("float32", "float64")}


def _jnp(v):
    if isinstance(v, J.Tensor):
        return np.asarray(v._value)
    return np.asarray(v)


def _tnp(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _check(got, want, tol, name):
    g, w = _tnp(got), _jnp(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if isinstance(got, torch.Tensor) and isinstance(want, J.Tensor):
        pair = (w.dtype.name, str(got.dtype).replace("torch.", ""))
        assert pair[0] == pair[1] or pair in _WIDER, (name, pair)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
    if tol == 0.0 or g.dtype.kind in "biu" or w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name,
                                   equal_nan=True)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_op_matches_jax(case):
    cid, name, args, kwargs, tol, _ = case
    jfn, pfn = getattr(J, name), getattr(P, name)
    jargs, _ = _jax_args(args)
    pargs, _ = _port_args(args)
    want = jfn(*jargs, **kwargs)
    got = pfn(*pargs, **_port_kwargs(pfn, kwargs))
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
    gs, ws = _flat(got), _flat(want)
    assert len(gs) == len(ws), cid
    for i, (g, w) in enumerate(zip(gs, ws)):
        _check(g, w, TOL[tol], f"{cid}[{i}]")


GRAD_CASES = [c for c in CASES if c[5]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_op_grad_matches_jax(case):
    """d(sum(out * cot)) / d(first float input), cot a seeded normal,
    through torch.autograd and through the JAX tape."""
    cid, name, args, kwargs, tol, _ = case
    jargs, jleaf = _jax_args(args, grad=True)
    pargs, pleaf = _port_args(args, grad=True)
    pfn = getattr(P, name)
    jout = [o for o in _flat(getattr(J, name)(*jargs, **kwargs))
            if isinstance(o, J.Tensor) and np.asarray(o._value).dtype.kind
            == "f"]
    pout = [o for o in _flat(pfn(*pargs, **_port_kwargs(pfn, kwargs)))
            if isinstance(o, torch.Tensor) and o.is_floating_point()]
    rng = np.random.RandomState(len(cid))
    cots = [np.asarray(rng.randn(*o.shape), np.float32) for o in pout]
    jg = J.grad(jout, [jleaf], [J.to_tensor(c) for c in cots],
                allow_unused=True)[0]
    pg = torch.autograd.grad(pout, [pleaf], [torch.from_numpy(c)
                                             for c in cots],
                             allow_unused=True)[0]
    jg = np.zeros(pleaf.shape, np.float32) if jg is None else _jnp(jg)
    pg = np.zeros(pleaf.shape, np.float32) if pg is None else _tnp(pg)
    scale = max(float(np.abs(jg).max()), 1e-6)
    rel = 1e-3 if tol == "la" else 1e-4
    np.testing.assert_allclose(pg, jg, rtol=0, atol=rel * scale,
                               err_msg=cid)


# -- reconstructions ---------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["svd", "qr", "qr_r", "eigh", "eig",
                                  "eigvals", "eigvalsh", "lu", "lstsq"])
def test_decompositions_reconstruct(case):
    """Each decomposition rebuilds its input within 1e-4 (relative to
    the input's scale), and its invariant parts equal the JAX
    package's: singular values, eigenvalues, R's |diagonal|, the LU
    pivots (bit for bit) and the least-squares solution."""
    la = P.linalg
    tol = 1e-4 * float(np.abs(SPD).max())
    if case == "svd":
        u, s, vh = la.svd(_t(A))
        np.testing.assert_allclose((u * s) @ vh, A, atol=tol)
        np.testing.assert_allclose(s, _jnp(J.linalg.svd(J.to_tensor(A))[1]),
                                   rtol=1e-5)
    elif case == "qr":
        q, r = la.qr(_t(SPD))
        np.testing.assert_allclose(q @ r, SPD, atol=tol)
        jr = _jnp(J.linalg.qr(J.to_tensor(SPD))[1])
        np.testing.assert_allclose(np.abs(np.diag(r)), np.abs(np.diag(jr)),
                                   rtol=1e-5)
    elif case == "qr_r":
        r = la.qr(_t(SPD), "r")
        jr = _jnp(J.linalg.qr(J.to_tensor(SPD), "r"))
        assert tuple(r.shape) == jr.shape
        np.testing.assert_allclose(np.abs(r.numpy()), np.abs(jr), atol=tol)
    elif case == "eigh":
        w, v = la.eigh(_t(SPD))
        np.testing.assert_allclose((v * w) @ v.T, SPD, atol=tol)
        np.testing.assert_allclose(
            w, _jnp(J.linalg.eigh(J.to_tensor(SPD))[0]), rtol=1e-5)
    elif case == "eig":
        w, v = la.eig(_t(SQ))
        rebuilt = (v * w) @ torch.linalg.inv(v)
        np.testing.assert_allclose(rebuilt.real.numpy(), SQ, atol=tol)
        jw = _jnp(J.linalg.eig(J.to_tensor(SQ))[0])
        np.testing.assert_allclose(np.sort_complex(w.numpy()),
                                   np.sort_complex(jw), atol=1e-4)
    elif case == "eigvals":
        w = la.eigvals(_t(SQ)).numpy()
        jw = _jnp(J.linalg.eigvals(J.to_tensor(SQ)))
        np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(jw),
                                   atol=1e-4)
    elif case == "eigvalsh":
        np.testing.assert_allclose(
            la.eigvalsh(_t(SPD)), _jnp(J.linalg.eigvalsh(J.to_tensor(SPD))),
            rtol=1e-5)
    elif case == "lu":
        lu, piv = la.lu(_t(SQ))
        jlu, jpiv = J.linalg.lu(J.to_tensor(SQ))
        np.testing.assert_array_equal(piv.numpy(), _jnp(jpiv))
        assert piv.dtype == torch.int32
        p, lo, up = la.lu_unpack(lu, piv)
        np.testing.assert_allclose(p @ lo @ up, SQ, atol=tol)
        jp, jl, ju = J.linalg.lu_unpack(jlu, jpiv)
        for a, b in ((p, jp), (lo, jl), (up, ju)):
            np.testing.assert_allclose(a.numpy(), _jnp(b), atol=tol)
        _, _, info = la.lu(_t(SQ), get_infos=True)
        assert info.dtype == torch.int32 and info.shape == ()
    else:
        sol = la.lstsq(_t(W3), _t(V4[:, None]))[0]
        jsol = J.linalg.lstsq(J.to_tensor(W3), J.to_tensor(V4[:, None]))[0]
        np.testing.assert_allclose(sol, _jnp(jsol), atol=1e-4)


# -- random ops --------------------------------------------------------------

RANDOM_CASES = [
    # (id, call, dtype, (lo, hi) range or None)
    ("uniform", lambda m, **d: m.uniform([4, 5], min=-2.0, max=3.0, **d),
     "float32", (-2.0, 3.0)),
    ("uniform_bf16", lambda m, **d: m.uniform([4, 5], "bfloat16", **d),
     "bfloat16", (-1.0, 1.0)),
    ("rand", lambda m, **d: m.rand([3, 2], **d), "float32", (0.0, 1.0)),
    ("randn", lambda m, **d: m.randn([3, 2], **d), "float32", None),
    ("standard_normal", lambda m, **d: m.standard_normal([6], "float64",
                                                         **d),
     "float64", None),
    ("normal", lambda m, **d: m.normal(1.0, 2.0, [5], **d), "float32",
     None),
    ("gauss", lambda m, **d: m.gauss(0.0, 1.0, [2, 2], **d), "float32",
     None),
    ("randint", lambda m, **d: m.randint(2, 9, [4, 4], **d), "int64",
     (2, 8)),
    ("randint_int32", lambda m, **d: m.randint(5, shape=[7], dtype="int32",
                                               **d), "int32", (0, 4)),
    ("randperm", lambda m, **d: m.randperm(9, **d), "int64", (0, 8)),
    ("log_normal", lambda m, **d: m.log_normal(0.0, 0.5, [8], **d),
     "float32", (0.0, np.inf)),
    ("rayleigh", lambda m, **d: m.rayleigh(2.0, [8], **d), "float32",
     (0.0, np.inf)),
]


def _jax_shape_dtype(call):
    out = call(J)
    v = np.asarray(out._value)
    return v.shape, v.dtype.name


@pytest.mark.parametrize("case", RANDOM_CASES, ids=[c[0] for c in
                                                    RANDOM_CASES])
def test_random_form_and_determinism(case):
    """Shape and dtype equal to the JAX package's (int64 / float64 for
    its int32 / float32, the width policy), values inside the range,
    the same draws after the same seed, other draws after another seed
    or the next call."""
    cid, call, dtype, rng_ = case
    jshape, jdtype = _jax_shape_dtype(call)
    P.seed(123)
    a = call(P, device="cpu")
    b = call(P, device="cpu")
    P.seed(123)
    a2 = call(P, device="cpu")
    P.seed(124)
    c = call(P, device="cpu")
    assert tuple(a.shape) == jshape
    assert a.dtype == getattr(torch, dtype)
    assert jdtype == dtype or (jdtype, dtype) in _WIDER
    assert torch.equal(a, a2)
    if cid != "randperm" or a.numel() > 2:
        assert not torch.equal(a, b) and not torch.equal(a, c)
    if rng_ is not None:
        assert float(a.min()) >= rng_[0] and float(a.max()) <= rng_[1]
    if cid == "randperm":
        assert sorted(a.tolist()) == list(range(9))


N = 100000
# (id, draw, mean, var, tolerance on each): the moments of 10^5 draws
MOMENT_CASES = [
    ("uniform", lambda: P.uniform([N], min=-1.0, max=3.0, device="cpu"),
     1.0, 16 / 12, 0.03),
    ("randn", lambda: P.randn([N], device="cpu"), 0.0, 1.0, 0.02),
    ("normal", lambda: P.normal(2.0, 0.5, [N], device="cpu"), 2.0, 0.25,
     0.01),
    ("randint", lambda: P.randint(0, 10, [N], device="cpu").double(), 4.5,
     8.25, 0.1),
    ("bernoulli", lambda: P.bernoulli(torch.full([N], 0.3)), 0.3, 0.21,
     0.01),
    ("poisson", lambda: P.poisson(torch.full([N], 4.0)), 4.0, 4.0, 0.1),
    ("binomial", lambda: P.binomial(torch.full([N], 10),
                                    torch.full([N], 0.4)).double(),
     4.0, 2.4, 0.06),
    ("exponential_", lambda: P.exponential_(torch.empty(N), 2.0), 0.5,
     0.25, 0.01),
    ("log_normal", lambda: P.log_normal(0.0, 0.25, [N], device="cpu"),
     float(np.exp(0.25 ** 2 / 2)),
     float((np.exp(0.25 ** 2) - 1) * np.exp(0.25 ** 2)), 0.01),
    ("rayleigh", lambda: P.rayleigh(1.0, [N], device="cpu"),
     float(np.sqrt(np.pi / 2)), float((4 - np.pi) / 2), 0.02),
    ("uniform_", lambda: P.uniform_(torch.empty(N), 0.0, 2.0), 1.0, 1 / 3,
     0.02),
    ("rrelu_train", lambda: -P.rrelu(-torch.ones(N), 0.1, 0.3), 0.2,
     0.04 / 12, 0.002),
]


@pytest.mark.parametrize("case", MOMENT_CASES, ids=[c[0] for c in
                                                    MOMENT_CASES])
def test_random_moments(case):
    cid, draw, mean, var, tol = case
    P.seed(7)
    x = draw().double()
    assert x.numel() == N
    assert abs(float(x.mean()) - mean) < tol, (cid, float(x.mean()))
    assert abs(float(x.var()) - var) < max(tol, 0.05 * var), (
        cid, float(x.var()))


def test_random_tensor_ops_form():
    """multinomial (with and without replacement), cauchy_, randint_like,
    gumbel_softmax: shapes, dtypes and supports as the JAX package's."""
    P.seed(0)
    probs = torch.tensor([[0.1, 0.0, 0.6, 0.3], [0.25, 0.25, 0.25, 0.25]])
    m = P.multinomial(probs, 3)
    jm = J.multinomial(J.to_tensor(probs.numpy()), 3)
    assert tuple(m.shape) == tuple(jm.shape) and m.dtype == torch.int64
    for row in m.tolist():
        assert len(set(row)) == 3          # without replacement
    assert 1 not in m[0].tolist()          # zero probability
    m = P.multinomial(probs, 20, True)
    assert tuple(m.shape) == (2, 20) and 1 not in m[0].tolist()
    c = P.cauchy_(torch.empty(1000), 1.0, 0.5)
    assert abs(float(c.median()) - 1.0) < 0.1
    r = P.randint_like(torch.zeros(3, 4), 2, 5)
    assert r.dtype == torch.float32 and set(r.unique().tolist()) <= {2, 3, 4}
    g = P.gumbel_softmax(torch.from_numpy(A), 0.5)
    torch.testing.assert_close(g.sum(-1), torch.ones(3))
    h = P.gumbel_softmax(torch.from_numpy(A), hard=True)
    assert set(h.unique().tolist()) <= {0.0, 1.0}
    assert h.sum(-1).tolist() == [1.0, 1.0, 1.0]


def test_rng_state_round_trip_and_module_generators():
    """get_rng_state / set_rng_state replay the package generator's
    draws; a module-held generator (queue 3 #18) is not touched by
    `seed`, and F.dropout with none draws from the package generator."""
    P.seed(5)
    state = P.get_rng_state()
    a = P.rand([6], device="cpu")
    d1 = P.nn.functional.dropout(torch.ones(64), 0.5)
    P.set_rng_state(state)
    assert torch.equal(P.rand([6], device="cpu"), a)
    assert torch.equal(P.nn.functional.dropout(torch.ones(64), 0.5), d1)
    g = torch.Generator().manual_seed(9)
    held = P.nn.Dropout(0.5, generator=g)
    x = held(torch.ones(64))
    P.seed(5)
    g2 = torch.Generator().manual_seed(9)
    assert torch.equal(P.nn.Dropout(0.5, generator=g2)(torch.ones(64)), x)


# -- switches, to_tensor, dtypes, in-place ----------------------------------

def test_autograd_switches_and_grad():
    x = P.to_tensor([1.0, 2.0], place="cpu", stop_gradient=False)
    assert x.requires_grad and P.is_grad_enabled()
    with P.no_grad():
        assert not P.is_grad_enabled()
        assert not (x * 2).requires_grad
        with P.enable_grad():
            assert (x * 2).requires_grad
    P.set_grad_enabled(False)
    try:
        assert not P.is_grad_enabled()
    finally:
        P.set_grad_enabled(True)

    @P.no_grad()
    def f(v):
        return v * 3

    assert not f(x).requires_grad
    y = (x ** 3).sum()
    (g,) = P.grad(y, x, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), [3.0, 12.0])
    (gg,) = P.grad(g.sum(), [x])
    np.testing.assert_allclose(gg.numpy(), [6.0, 12.0])
    z = P.to_tensor([1.0], place="cpu", stop_gradient=False)
    with pytest.raises(ValueError, match="allow_unused"):
        P.grad((x * 2).sum(), [x, z])
    assert P.grad((x * 2).sum(), [x, z], allow_unused=True)[1] is None
    # JAX's grad gives the same first and second derivatives
    jx = J.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    (jg,) = J.grad((jx ** 3).sum(), jx)
    np.testing.assert_allclose(_jnp(jg), g.detach().numpy())


@pytest.mark.parametrize("data,dtype", [
    ([1.5, 2.0], None), (np.arange(4, dtype=np.float64), None),
    ([[1, 2], [3, 4]], None), ([True, False], None), (3, "float16"),
    (np.float32(2.5), None), ([1, 2], "bfloat16"), (C34, None)])
def test_to_tensor_matches_jax(data, dtype):
    j = J.to_tensor(data, dtype=dtype)
    p = P.to_tensor(data, dtype=dtype, place="cpu")
    _check(p, j, 0.0, repr(data))
    assert not p.requires_grad
    assert P.to_tensor(p, place="cpu", stop_gradient=False).requires_grad \
        == (p.is_floating_point() or p.is_complex())


def test_default_dtype_and_dtype_map():
    assert P.get_default_dtype() == J.get_default_dtype() == "float32"
    from paddle_tpu.core import dtype as jd
    from paddle_tpu_torch.core import dtype as pd
    for key in jd._STR_TO_DTYPE:
        want = np.dtype(jd._STR_TO_DTYPE[key]).name
        got = str(pd.convert_dtype(key)).replace("torch.", "")
        # the width policy: JAX (x64 off) resolves int64 to int32 at
        # creation; the port keeps torch's widths
        assert got == want or (got == "bool" and want == "bool"), key
    assert pd.convert_dtype("int64") == torch.int64
    assert jd.convert_dtype("int64") == np.int32
    P.set_default_dtype("float64")
    J.set_default_dtype("float64")
    try:
        p, j = P.zeros([2], device="cpu"), J.zeros([2])
        assert p.dtype == torch.float64
        assert np.asarray(j._value).dtype == np.float32   # x64 off
        assert P.to_tensor([1.0], place="cpu").dtype == torch.float64
        assert P.arange(0.0, 1.0, 0.5, device="cpu").dtype == torch.float64
    finally:
        P.set_default_dtype("float32")
        J.set_default_dtype("float32")
    assert P.zeros([1], device="cpu").dtype == torch.float32


def test_creation_defaults_to_the_card():
    """With no device, a creation op asks for the card; here, without
    one, it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: P.zeros([2]), lambda: P.arange(3),
                 lambda: P.randn([2]), lambda: P.to_tensor([1.0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_inplace_ops_and_what_torch_refuses():
    """reshape_ / flatten_ re-point x; squeeze_ / unsqueeze_ / softmax_ /
    fill_diagonal_ / increment / the random fills change x itself;
    torch refuses each on a leaf that requires grad (the JAX package
    rebinds its value there)."""
    x = torch.from_numpy(A.copy())
    y = P.reshape_(x, [6, 2])
    assert y is x and tuple(x.shape) == (6, 2)
    np.testing.assert_array_equal(x.numpy(), A.reshape(6, 2))
    assert P.flatten_(x) is x and tuple(x.shape) == (12,)
    assert P.unsqueeze_(x, [0, 2]) is x and tuple(x.shape) == (1, 12, 1)
    assert P.squeeze_(x) is x and tuple(x.shape) == (12,)
    v = torch.zeros(3)
    assert P.increment(v, 2.0) is v and v.tolist() == [2.0] * 3
    leaf = torch.zeros(2, 2, requires_grad=True)
    for call in (lambda: P.reshape_(leaf, [4]), lambda: P.increment(leaf),
                 lambda: P.uniform_(leaf), lambda: P.fill_diagonal_(leaf, 1),
                 lambda: P.softmax_(leaf), lambda: P.unsqueeze_(leaf, 0)):
        with pytest.raises(RuntimeError):
            call()
    # inside a graph the in-place views keep autograd's trace
    w = torch.ones(3, requires_grad=True)
    h = w * 2
    P.unsqueeze_(h, 0)
    h.sum().backward()
    assert w.grad.tolist() == [2.0] * 3


def test_amp_sees_the_white_listed_ops():
    """O1 casts matmul, mv, einsum, addmm, linear and SDPA inputs to
    bf16, and no black-listed op's: the op names of the JAX package's
    lists all resolve to dispatched ops."""
    from paddle_tpu_torch import amp

    assert amp.audit_op_lists() == {"white": [], "black": []}
    a, b = torch.randn(4, 4), torch.randn(4)
    with amp.auto_cast():
        assert P.matmul(a, a).dtype == torch.bfloat16
        assert P.mv(a, b).dtype == torch.bfloat16
        assert P.einsum("ij,jk->ik", a, a).dtype == torch.bfloat16
        assert P.addmm(a, a, a).dtype == torch.bfloat16
        assert P.exp(a).dtype == torch.float32
        assert P.sum(a).dtype == torch.float32
