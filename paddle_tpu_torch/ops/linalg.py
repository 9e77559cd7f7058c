"""Linear algebra: the port of `paddle_tpu/ops/linalg.py` (39 names).

The JAX package leaves products and decompositions to XLA, outside any
Pallas kernel; here they are `torch.matmul` and `torch.linalg`, outside
any kernel of the port. `matmul`, `mv`, `einsum` and `addmm`
(`ops.math`) hand their inputs to `amp.maybe_cast_inputs` under those
names, which O1's white list casts. Mixed dtypes promote as jnp
promotes them. Semantics are the JAX kernels':

- `norm`: p "fro" (the default for axis None or a pair), "nuc", inf,
  -inf, 0 or a number; `dist` is the p-norm of x - y;
- `slogdet` stacks (sign, log|det|); `qr(mode="r")` gives R alone;
  `eig` and `eigvals` are complex; `lstsq` gives (solution, residuals,
  rank, singular values), the last three as `torch.linalg.lstsq`'s
  driver gives them (compare the solution);
- `lu` gives the packed factors and 0-based int32 pivots, as
  `jax.scipy.linalg.lu_factor` does, and `lu_unpack` (P, L, U) from
  them with x = P L U;
- `cov` takes numpy's frequency and importance weights, checked as the
  JAX op checks them; `histogram` counts int64 over [min, max] (the
  data's range when both are 0).
"""
from __future__ import annotations

import numpy as np
import torch

from ._common import _cast, axes

__all__ = [
    "matmul", "mm", "bmm", "mv", "dot", "norm", "dist", "cross", "cholesky",
    "cholesky_solve", "inv", "det", "slogdet", "svd", "qr", "eigh", "eig",
    "eigvals", "eigvalsh", "solve", "triangular_solve", "lstsq",
    "matrix_power", "matrix_rank", "pinv", "multi_dot", "cond",
    "corrcoef", "cov", "bincount", "histogram", "einsum", "lu", "lu_unpack",
    "tensordot", "matrix_norm", "vector_norm", "householder_product",
    "inverse",
]


def promote(*tensors):
    """The tensors cast to their common result type, as jnp promotes
    mixed operands (an f32 activation against a bf16 weight under O2
    gives an f32 product); `torch.matmul` refuses mixed dtypes."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y over the last two dims, with either side transposed first
    (a 1-d operand is not transposed). Mixed dtypes promote."""
    x, y = _cast("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(*promote(x, y))


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    x, vec = _cast("mv", x, vec)
    return torch.matmul(*promote(x, vec))


def dot(x, y, name=None):
    x, y = _cast("dot", x, y)
    return torch.sum(x * y, dim=-1)


def _norm(x, p, axis, keepdim):
    dim = axis if axis is None or isinstance(axis, tuple) else (axis,)
    if dim is None:
        dim = tuple(range(x.dim()))
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                    keepdim=keepdim))
    if p == "nuc":
        s = torch.linalg.svdvals(x)
        out = torch.sum(s, dim=-1, keepdim=keepdim)
        return out.unsqueeze(-1) if keepdim else out
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dim, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dim,
                               keepdim=keepdim), 1.0 / p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    (x,) = _cast("norm", x)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    axis = axes(axis)
    if isinstance(axis, tuple) and (p == "fro" or p == 2):
        p = "fro"
    return _norm(x, p, axis, bool(keepdim))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    (x,) = _cast("matrix_norm", x)
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=bool(keepdim))


def dist(x, y, p=2, name=None):
    x, y = _cast("dist", x, y)
    p = float(p) if p not in ("fro", "nuc") else p
    return _norm(x - y, p if p != 2 else "fro", None, False)


def cross(x, y, axis=9, name=None):
    """The cross product along `axis` (9, the default: the first dim of
    size 3)."""
    x, y = _cast("cross", x, y)
    ax = int(axis) if axis is not None else 9
    if ax == 9:
        ax = next((i for i, d in enumerate(x.shape) if d == 3), None)
        if ax is None:
            raise ValueError(
                "paddle.cross: no dimension of size 3 to take the cross "
                f"product over, x.shape={tuple(x.shape)}, "
                f"y.shape={tuple(y.shape)}; pass axis= explicitly")
    return torch.linalg.cross(*promote(x, y), dim=ax)


def cholesky(x, upper=False, name=None):
    (x,) = _cast("cholesky", x)
    return torch.linalg.cholesky(x, upper=bool(upper))


def cholesky_solve(x, y, upper=False, name=None):
    """Solves A z = x for A = y y^T (upper: y^T y), y the Cholesky
    factor."""
    x, y = _cast("cholesky_solve", x, y)
    return torch.cholesky_solve(x, y, upper=bool(upper))


def inv(x, name=None):
    (x,) = _cast("inv", x)
    return torch.linalg.inv(x)


inverse = inv


def det(x, name=None):
    (x,) = _cast("det", x)
    return torch.linalg.det(x)


def slogdet(x, name=None):
    (x,) = _cast("slogdet", x)
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs], dim=0)


def svd(x, full_matrices=False, name=None):
    (x,) = _cast("svd", x)
    return tuple(torch.linalg.svd(x, full_matrices=bool(full_matrices)))


def qr(x, mode="reduced", name=None):
    (x,) = _cast("qr", x)
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def eigh(x, UPLO="L", name=None):
    (x,) = _cast("eigh", x)
    sym = (x + x.transpose(-1, -2).conj()) / 2
    return tuple(torch.linalg.eigh(sym))


def eig(x, name=None):
    (x,) = _cast("eig", x)
    return tuple(torch.linalg.eig(x))


def eigvals(x, name=None):
    (x,) = _cast("eigvals", x)
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    (x,) = _cast("eigvalsh", x)
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def solve(x, y, name=None):
    x, y = _cast("solve", x, y)
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solves x z = y (transpose: x^T z = y), x triangular."""
    x, y = _cast("triangular_solve", x, y)
    a, up = (x.transpose(-1, -2), not upper) if transpose else (x, upper)
    return torch.linalg.solve_triangular(a, y, upper=bool(up),
                                         unitriangular=bool(unitriangular))


def lstsq(x, y, rcond=None, driver=None, name=None):
    x, y = _cast("lstsq", x, y)
    out = torch.linalg.lstsq(x, y, rcond=rcond, driver=driver)
    return out.solution, out.residuals, out.rank, out.singular_values


def matrix_power(x, n, name=None):
    (x,) = _cast("matrix_power", x)
    return torch.linalg.matrix_power(x, int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    (x,) = _cast("matrix_rank", x)
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=bool(hermitian))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    (x,) = _cast("pinv", x)
    return torch.linalg.pinv(x, rtol=float(rcond), hermitian=bool(hermitian))


def multi_dot(x, name=None):
    xs = _cast("multi_dot", *x)
    return torch.linalg.multi_dot(promote(*xs))


def cond(x, p=None, name=None):
    (x,) = _cast("cond", x)
    return torch.linalg.cond(x, p)


def _cov_weight(w, nobs, what, integral):
    """A cov weight vector checked as numpy's `cov` requires."""
    arr = np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w)
    if arr.ndim != 1:
        raise ValueError(
            f"paddle.linalg.cov: {what} must be 1-D, got shape {arr.shape}")
    if arr.shape[0] != nobs:
        raise ValueError(
            f"paddle.linalg.cov: {what} has {arr.shape[0]} entries for "
            f"{nobs} observations")
    if integral and not np.all(arr == np.round(arr)):
        raise TypeError(
            f"paddle.linalg.cov: {what} must be integer frequency counts")
    if np.any(arr < 0):
        raise ValueError(f"paddle.linalg.cov: {what} cannot be negative")
    return w


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Weighted covariance with numpy's semantics (fweights integer
    frequencies, aweights importance weights)."""
    (x,) = _cast("cov", x)
    v = x if rowvar or x.dim() < 2 else x.transpose(0, 1)
    nobs = v.shape[-1]
    fw = aw = None
    if fweights is not None:
        fw = torch.as_tensor(_cov_weight(fweights, nobs, "fweights", True),
                             device=x.device).long()
    if aweights is not None:
        aw = torch.as_tensor(_cov_weight(aweights, nobs, "aweights", False),
                             device=x.device).to(x.dtype)
    return torch.cov(v, correction=1 if ddof else 0, fweights=fw,
                     aweights=aw)


def corrcoef(x, rowvar=True, name=None):
    (x,) = _cast("corrcoef", x)
    return torch.corrcoef(x if rowvar or x.dim() < 2 else x.transpose(0, 1))


def bincount(x, weights=None, minlength=0, name=None):
    x, weights = _cast("bincount", x, weights)
    return torch.bincount(x, weights=weights, minlength=int(minlength))


def histogram(input, bins=100, min=0, max=0, name=None):
    (input,) = _cast("histogram", input)
    v = input.float() if not input.is_floating_point() else input
    return torch.histc(v, int(bins), float(min), float(max)).to(torch.int64)


def einsum(equation, *operands):
    ops = list(operands[0]) if len(operands) == 1 and isinstance(
        operands[0], (list, tuple)) else list(operands)
    ops = _cast("einsum", *ops)
    return torch.einsum(equation, *promote(*ops))


def tensordot(x, y, axes=2, name=None):
    x, y = _cast("tensordot", x, y)
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else a
                for a in axes]
    return torch.tensordot(*promote(x, y), dims=axes)


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots): the packed factors and 0-based int32 row swaps."""
    (x,) = _cast("lu", x)
    lu_mat, piv = torch.linalg.lu_factor(x)
    piv = (piv - 1).to(torch.int32)
    if get_infos:
        infos = torch.zeros([x.shape[0]] if x.dim() > 2 else [],
                            dtype=torch.int32, device=x.device)
        return lu_mat, piv, infos
    return lu_mat, piv


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True):
    """(P, L, U) of a 2-D `lu` result, x = P L U."""
    (lu_data,) = _cast("lu_unpack", lu_data)
    m = lu_data.shape[-2]
    eye = torch.eye(m, lu_data.shape[-1], dtype=lu_data.dtype,
                    device=lu_data.device)
    lower = torch.tril(lu_data, -1) + eye
    upper = torch.triu(lu_data)
    perm = list(range(m))
    for i, j in enumerate(lu_pivots.reshape(-1).tolist()):
        perm[i], perm[j] = perm[j], perm[i]
    pmat = torch.eye(m, dtype=lu_data.dtype, device=lu_data.device)[perm]
    return pmat.transpose(0, 1), lower, upper


def householder_product(x, tau, name=None):
    """The first n columns of H_0 H_1 ... H_{n-1}, H_i = I - tau_i w_i
    w_i^T, w_i column i of x below the diagonal with a 1 on it."""
    x, tau = _cast("householder_product", x, tau)
    m, n = x.shape[-2], x.shape[-1]
    q = torch.eye(m, dtype=x.dtype, device=x.device)
    rows = torch.arange(m, device=x.device)
    for i in range(n):
        w = torch.where(rows < i, torch.zeros_like(x[..., :, i]),
                        x[..., :, i])
        w = torch.where(rows == i, torch.ones_like(w), w)
        q = q - tau[i] * (q @ torch.outer(w, w))
    return q[..., :, :n]
