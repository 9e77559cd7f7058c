"""Hybrid-parallel topology, the port of
`paddle_tpu/distributed/fleet/base/topology.py`: `CommunicateTopology`
(:21) and `HybridCommunicateGroup` (:74).

`CommunicateTopology` maps coordinates over the named parallel axes
(data, pipe, sharding, model, sep) to ranks row-major
(`itertools.product`), as the JAX package's does. `HybridCommunicateGroup`
builds the mesh of the same layout over the world (`distributed.mesh`,
axes dp, pp, sharding, mp, sp), sets it as the current mesh, and takes
each axis's group from it: this rank's line along the axis, with its
`torch.distributed` subgroup. A topology whose size is not the world
size (a dry run of a larger layout in one process) sets no mesh, as in
the JAX package; its groups carry their ranks and no subgroup.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from ... import mesh as mesh_mod
from ...env import get_rank, get_world_size

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model", "sep"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple(
            "Coordinate", self._parallel_names)
        self.world_size = int(np.prod(self._dims))
        ranges = [range(d) for d in self._dims]
        self._coord2rank = {}
        self._rank2coord = {}
        for rank, coord in enumerate(itertools.product(*ranges)):
            c = self.coordinate(*coord)
            self._coord2rank[c] = rank
            self._rank2coord[rank] = c

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def coord_to_rank(self, coord):
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        other = [i for i in range(len(self._dims)) if i != axis]
        groups = []
        for fixed in itertools.product(*[range(self._dims[i])
                                         for i in other]):
            ranks = []
            for v in range(self._dims[axis]):
                coord = [0] * len(self._dims)
                for pos, i in enumerate(other):
                    coord[i] = fixed[pos]
                coord[axis] = v
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            groups.append(ranks)
        return groups


_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
             "model": "mp", "sep": "sp"}


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        self.nranks = topology.world_size
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")
        self._sp_degree = (topology.get_dim("sep")
                           if "sep" in topology.get_hybrid_group_names()
                           else 1)
        names = topology.get_hybrid_group_names()
        mesh = mesh_mod.Mesh(
            np.arange(topology.world_size).reshape(
                [topology.get_dim(n) for n in names]),
            [_AXIS_MAP[n] for n in names])
        if topology.world_size == get_world_size():
            mesh_mod.set_mesh(mesh)
        self.mesh = mesh
        self._dp_group = mesh.group(("dp",))
        self._pp_group = mesh.group(("pp",))
        self._sharding_group = mesh.group(("sharding",))
        self._mp_group = mesh.group(("mp",))
        self._sp_group = mesh.group(("sp",))
        self._check_group = mesh.group(mesh_mod.STANDARD_AXES)

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "tensor_parallel"
        return "data_parallel"

    def _coord(self):
        if self.global_rank < self._topo.world_size:
            return self._topo.get_coord(self.global_rank)
        return self._topo.get_coord(0)

    # data parallel
    def get_data_parallel_rank(self):
        return self._coord().data

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model parallel
    def get_model_parallel_rank(self):
        return self._coord().model

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline
    def get_stage_id(self):
        return self._coord().pipe

    def get_pipe_parallel_rank(self):
        return self._coord().pipe

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._coord().sharding

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # sequence parallel
    def get_sep_parallel_rank(self):
        return getattr(self._coord(), "sep", 0)

    def get_sep_parallel_world_size(self):
        return self._sp_degree

    def get_sep_parallel_group(self):
        return self._sp_group

    def get_check_parallel_group(self, *args):
        return self._check_group

    def get_p2p_groups(self):
        return None

    def topology(self):
        return self._topo
