"""Model-parallel RNG tracking, the port of
`paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/random.py`.

`RNGStatesTracker` keeps named `torch.Generator`s. `rng_state(name)`
runs its body on the named generator's state in place of the device's
default generator (the source of the port's dropout masks when a layer
is given no generator of its own) and keeps the state the body leaves.
`model_parallel_random_seed(seed)` seeds two states, as the JAX package
does: "global_seed" with `seed` (the same on every model-parallel rank)
and the model-parallel state with `seed + 1024 + 1 + mp rank`. The JAX
package is one controller whose one key covers the whole logical
tensor, so its shards draw different numbers; here each rank is a
process and adds its mp rank, which is 0 at mp 1, where the seeds are
the JAX package's.
"""
from __future__ import annotations

import contextlib
import random as pyrandom

import torch

from .....device import resolve_device

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _default_generator(dev):
    if dev.type == "cuda":
        return torch.cuda.default_generators[dev.index]
    return torch.default_generator


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed, device=None):
        """A generator named `name` seeded `seed` on `device` (None: the
        card)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        dev = resolve_device(device)
        self.states_[name] = torch.Generator(device=dev).manual_seed(seed)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        gen = self.states_.get(name)
        if gen is None:
            yield
            return
        default = _default_generator(gen.device)
        saved = default.get_state()
        default.set_state(gen.get_state())
        try:
            yield
        finally:
            gen.set_state(default.get_state())
            default.set_state(saved)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None, *, device=None):
    """Seed the tracker's "global_seed" and model-parallel states from
    `seed` (None: a random one) and this rank's mp rank."""
    from .mp_layers import model_parallel_group

    group = model_parallel_group()
    mp_rank = 0 if group is None else group.rank
    seed = seed or pyrandom.randint(0, 2 ** 20)
    _tracker.reset()
    _tracker.add("global_seed", seed, device)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + 1 + mp_rank, device)
