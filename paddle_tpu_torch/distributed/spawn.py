"""`spawn`, the port of `paddle_tpu/distributed/spawn.py` (:39): start
`nprocs` processes (the `spawn` start method), each with the PADDLE_*
env contract of its rank, join each to the process group
(`init_parallel_env(backend=, device=)`) and run `func(*args)` there.

    spawn(train, args=(cfg,), nprocs=2)                  # NCCL, a card a rank
    spawn(train, nprocs=2, backend="gloo")               # gloo, on the card
    spawn(train, nprocs=4, device="cpu")                 # gloo, on the CPU

The rendezvous is `tcp://127.0.0.1:<free port>` unless `init_method`
names another (a `file://` store, say). `func` must be picklable by
reference: a module-level function. Results go back through files or a
multiprocessing queue the caller passes in `args`.

A rank that fails (exits non-zero) makes `join` stop the others, which
would otherwise wait in a collective for it, and raise in the parent.
With nprocs in (-1, 0, 1), `func` runs inline in this process with no
process group, as in the JAX package.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
from multiprocessing import connection

__all__ = ["spawn", "ProcessContext"]


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_entry(func, args, env, backend, device):
    os.environ.update(env)
    import torch.distributed as dist

    from .parallel import init_parallel_env

    init_parallel_env(backend=backend, device=device)
    try:
        func(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, backend=None,
          *, device=None, init_method=None):
    """Launch `func(*args)` in nprocs processes (daemonic when `daemon`),
    each joined to the process group; returns the ProcessContext
    (joined when `join`)."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return ProcessContext([])
    port = _free_port()
    endpoints = ",".join(f"127.0.0.1:{port + i}" for i in range(nprocs))
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": endpoints.split(",")[rank],
            "PADDLE_RANK_IN_NODE": str(rank),
            "PADDLE_MASTER": init_method or f"127.0.0.1:{port}",
        }
        p = ctx.Process(target=_spawn_entry,
                        args=(func, args, env, backend, device),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = ProcessContext(procs)
    if join:
        context.join()
    return context


class ProcessContext:
    def __init__(self, processes):
        self.processes = processes

    def _stop(self):
        for p in self.processes:
            if p.exitcode is None:
                p.terminate()
        for p in self.processes:
            p.join(10)
            if p.exitcode is None:
                p.kill()
                p.join()

    def join(self, timeout=None):
        """Wait for every rank. The first rank to exit non-zero (or the
        timeout, in seconds) stops the rest and raises."""
        deadline = None if timeout is None else time.monotonic() + timeout
        alive = list(self.processes)
        while alive:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready = connection.wait([p.sentinel for p in alive], left)
            if not ready:
                self._stop()
                raise TimeoutError(
                    f"spawned ranks still running after {timeout} s; "
                    "stopped")
            for p in alive:
                if p.sentinel in ready:
                    p.join()
            bad = [p.exitcode for p in self.processes
                   if p.exitcode not in (None, 0)]
            if bad:
                self._stop()
                raise RuntimeError(
                    f"spawned trainer process failed with exit codes {bad}"
                    "; the other ranks were stopped")
            alive = [p for p in alive if p.exitcode is None]
        return True
