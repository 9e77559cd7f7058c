"""Random ops and the package's generators: the port of
`paddle_tpu/ops/random.py` (22 names).

The JAX package keeps one global threefry key and a call counter
(:64-98) and folds the counter into the key for each draw. The port's
package generator is torch's default generator of each device (the
CPU's and each card's): `seed(s)` seeds the CPU's and every card's,
and `get_rng_state()` / `set_rng_state(state)` round-trip both (the
state is {"cpu": ByteTensor, "cuda": [ByteTensor a card]}). Every draw
given no generator (these ops, `F.dropout`, the dense attention's
dropout) advances the generator of its tensor's device, so two layers
that draw in turn get different numbers. A module that holds a
`torch.Generator` of its own keeps drawing from it (ROADMAP queue 3
#18).

Philox and threefry draw different numbers: the ops are held to the
JAX package's shapes, dtypes, ranges, seeded determinism and moments,
never to its values (ROADMAP queue 3 #31). Ops that make a tensor from
nothing take a keyword-only `device` (None: the card). `seed=` of
`uniform` is accepted and ignored, as in the JAX package. `next_key`
is the JAX package's key plumbing and has no counterpart: a torch
generator holds its own state. The in-place draws (`uniform_`,
`exponential_`, `cauchy_`) fill x itself, which torch refuses on a
leaf that requires grad; the JAX package rebinds x's value there.
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, default_float_dtype, index_dtype
from ._common import _cast, device_of, float_dtype, shape_list

__all__ = [
    "seed", "get_rng_state", "set_rng_state", "uniform", "uniform_",
    "normal", "gauss", "randn", "rand", "randint", "randint_like",
    "randperm", "multinomial", "bernoulli", "poisson", "standard_normal",
    "exponential_", "binomial", "log_normal", "rayleigh", "cauchy_",
]


def seed(s: int):
    """Seed the CPU's generator and every card's."""
    torch.manual_seed(int(s))
    return torch.default_generator


def get_rng_state():
    cuda = torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []
    return {"cpu": torch.get_rng_state(), "cuda": cuda}


def set_rng_state(state):
    torch.set_rng_state(state["cpu"])
    if state["cuda"]:
        torch.cuda.set_rng_state_all(state["cuda"])


def _f32(dtype):
    """Draws are made in f32 at least (as jax.random does for bf16) and
    cast to `dtype`."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            device=None):
    dt = float_dtype(dtype)
    u = torch.rand(shape_list(shape), dtype=_f32(dt),
                   device=device_of(device=device))
    return (float(min) + (float(max) - float(min)) * u).to(dt)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return x.uniform_(float(min), float(max))


def normal(mean=0.0, std=1.0, shape=None, name=None, *, device=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        mean, std = _cast("normal", mean, std)
        ref = mean if isinstance(mean, torch.Tensor) else std
        z = torch.randn(tuple(ref.shape), dtype=default_float_dtype(),
                        device=ref.device)
        return mean + std * z
    z = torch.randn(shape_list(shape or [1]), dtype=default_float_dtype(),
                    device=device_of(device=device))
    return float(mean) + float(std) * z


def gauss(mean=0.0, std=1.0, shape=None, name=None, *, device=None):
    return normal(mean, std, shape, name, device=device)


def standard_normal(shape, dtype=None, name=None, *, device=None):
    dt = float_dtype(dtype)
    return torch.randn(shape_list(shape), dtype=_f32(dt),
                       device=device_of(device=device)).to(dt)


def randn(shape, dtype=None, name=None, *, device=None):
    return standard_normal(shape, dtype, name, device=device)


def rand(shape, dtype=None, name=None, *, device=None):
    return uniform(shape, dtype, min=0.0, max=1.0, device=device)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            device=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), shape_list(shape),
                         dtype=convert_dtype(dtype),
                         device=device_of(device=device))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    dt = convert_dtype(dtype) or x.dtype
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         dtype=index_dtype(), device=x.device).to(dt)


def randperm(n, dtype="int64", name=None, *, device=None):
    return torch.randperm(int(n), device=device_of(device=device)).to(
        convert_dtype(dtype))


def multinomial(x, num_samples=1, replacement=False, name=None):
    (x,) = _cast("multinomial", x)
    return torch.multinomial(x, int(num_samples), bool(replacement))


def bernoulli(x, name=None):
    (x,) = _cast("bernoulli", x)
    return torch.bernoulli(x)


def poisson(x, name=None):
    (x,) = _cast("poisson", x)
    return torch.poisson(x)


def binomial(count, prob, name=None):
    count, prob = _cast("binomial", count, prob)
    dt = torch.promote_types(prob.dtype, torch.float32)
    return torch.binomial(count.to(dt), prob.to(dt)).to(index_dtype())


def exponential_(x, lam=1.0, name=None):
    return x.exponential_(float(lam))


def log_normal(mean=1.0, std=2.0, shape=None, name=None, *, device=None):
    z = torch.randn(shape_list(shape or [1]), dtype=default_float_dtype(),
                    device=device_of(device=device))
    return torch.exp(float(mean) + float(std) * z)


def rayleigh(scale=1.0, shape=None, name=None, *, device=None):
    u = uniform(shape or [1], None, min=1e-7, max=1.0, device=device)
    return float(scale) * torch.sqrt(-2.0 * torch.log(u))


def cauchy_(x, loc=0, scale=1, name=None):
    return x.cauchy_(float(loc), float(scale))
