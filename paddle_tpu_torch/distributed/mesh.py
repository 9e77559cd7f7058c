"""Meshes and groups: the port of `paddle_tpu/distributed/mesh.py`.

The JAX package lays the devices of one controller out as a
`jax.sharding.Mesh` over named axes, the standard set being
(dp, pp, sharding, mp, sp), and a group is a tuple of axis names that
XLA's collectives run over. Here every rank is a process, so:

- a `Mesh` is the row-major layout of the world's ranks over the named
  axes: `np.arange(world).reshape(sizes)`, the layout JAX gets from
  `np.array(devices).reshape(sizes)` (:29-44). `build_mesh(axes)`
  infers one -1 size from the world size;
- a `Group` is this rank's line of the mesh along some axes (the other
  coordinates fixed): its ranks, this rank's index among them, and the
  `torch.distributed` subgroup that joins them (`process_group`, None
  in a one-rank world). Every rank creates every line's subgroup, in
  the same order, as `torch.distributed.new_group` requires, so the
  groups of a mesh are made by all ranks together; a mesh keeps the
  groups it made.

`set_mesh` / `get_mesh` hold the process's current mesh (the JAX
package's global), `ensure_mesh` builds one when none is set and
`default_mesh` is `ensure_mesh()`: a dp mesh over the world.
"""
from __future__ import annotations

import threading

import numpy as np
import torch.distributed as dist

from .env import get_rank, get_world_size

__all__ = ["STANDARD_AXES", "Mesh", "Group", "build_mesh", "set_mesh",
           "get_mesh", "ensure_mesh", "default_mesh", "new_group_for_axes"]

STANDARD_AXES = ("dp", "pp", "sharding", "mp", "sp")

_lock = threading.Lock()
_global_mesh = None


class Mesh:
    """The world's ranks laid out row-major over named axes."""

    def __init__(self, ranks, axis_names):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-d ranks for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self._groups = {}

    @property
    def size(self):
        return int(self.ranks.size)

    def lines(self, axis_names):
        """Every line of the mesh along `axis_names`: lists of ranks,
        the named axes varying row-major, in the order of the other
        axes' coordinates."""
        axes = [self.axis_names.index(a) for a in axis_names]
        rest = [i for i in range(self.ranks.ndim) if i not in axes]
        moved = np.transpose(self.ranks, rest + axes)
        n = int(np.prod([self.ranks.shape[i] for i in axes]))
        return [[int(r) for r in row] for row in moved.reshape(-1, n)]

    def group(self, axis_names):
        """This rank's `Group` along `axis_names` (cached per axes)."""
        key = tuple(a for a in axis_names if a in self.shape)
        with _lock:
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = Group(mesh=self, axis_names=key)
            return g

    def __repr__(self):
        return f"Mesh({self.shape})"


class Group:
    """This rank's line of `mesh` along `axis_names`: `ranks`, `rank`
    (this process's index in them), `nranks` and `process_group`, the
    `torch.distributed` subgroup of the line (None when no process
    group is up). Constructing it is collective: every rank creates
    every line's subgroup."""

    def __init__(self, *, mesh, axis_names):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        me = get_rank() if mesh.size > 1 else 0
        lines = mesh.lines(self.axis_names)
        self.ranks = next(line for line in lines if me in line)
        self.rank = self.ranks.index(me)
        self.process_group = None
        if dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != mesh.size:
                raise ValueError(f"{mesh} needs {mesh.size} ranks, the "
                                 f"process group has "
                                 f"{dist.get_world_size()}")
            for line in lines:
                pg = dist.new_group(line)
                if me in line:
                    self.process_group = pg

    @property
    def nranks(self):
        return len(self.ranks)

    def __repr__(self):
        return f"Group(axes={self.axis_names}, ranks={self.ranks})"


def build_mesh(axes, *, world_size=None):
    """axes: ordered {name: size}. The sizes multiply to the world size
    (`world_size`, default: this run's); one -1 is inferred."""
    n = get_world_size() if world_size is None else int(world_size)
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, have {n}")
    return Mesh(np.arange(total).reshape(sizes), names)


def set_mesh(mesh):
    global _global_mesh
    with _lock:
        _global_mesh = mesh
    return mesh


def get_mesh():
    return _global_mesh


def ensure_mesh(**axes):
    """The current mesh; a new one from `axes` (default: dp over the
    world) when none is set."""
    global _global_mesh
    with _lock:
        if _global_mesh is None:
            _global_mesh = build_mesh(axes or {"dp": -1})
        return _global_mesh


def default_mesh():
    return ensure_mesh()


def new_group_for_axes(axis_names, *, mesh=None):
    """This rank's `Group` along `axis_names` of `mesh` (default: the
    current mesh, built over the world when none is set)."""
    return (mesh or default_mesh()).group(axis_names)

