"""Role makers, the port of
`paddle_tpu/distributed/fleet/base/role_maker.py`: the collective role.
Every process is a worker; the parameter-server roles
(`is_collective=False`) are not ported and raise."""
from __future__ import annotations

from ...env import get_rank, get_trainer_endpoints, get_world_size

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return get_rank() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def server_num(self):
        return 0

    def get_trainer_endpoints(self):
        return get_trainer_endpoints()

    def _generate_role(self):
        pass

    def _barrier(self, comm_world=None):
        from ...collective import barrier

        barrier()


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        if not is_collective:
            raise NotImplementedError(
                "the parameter-server roles (is_collective=False) are not "
                "ported (ROADMAP queue 1 item 2)")
        super().__init__()
        self._is_collective = is_collective


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=True, init_gloo=False, **kwargs):
        super().__init__(is_collective=is_collective)
