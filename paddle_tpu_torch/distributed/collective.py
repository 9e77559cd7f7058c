"""Collective communication over torch.distributed, the port of the
eager multi-process part of `paddle_tpu/distributed/collective.py`:
`all_reduce` (with the per-call `compress=`), `all_gather`,
`broadcast`, `barrier`, and the point-to-point `send` / `recv` with
their non-blocking forms `isend` / `irecv` (:672-760).

Each call adds to `comm/<op>/{calls,bytes,wire_bytes,host_us}` in
`core.monitor` and runs inside a `collective` flight span (what the
watchdog watches), with the `collective` chaos site inside the span —
the JAX package's `_instrumented` (:129-215) without its profiler
span. `bytes` is the logical
per-rank payload (all_gather: the whole gathered list); `wire_bytes`
is what crosses the wire at the wire's precision, equal to `bytes`
except on the quantized all_reduce, so wire_bytes / bytes is the
measured compression ratio; `host_us` is the host's wall time in the
call, which includes the transfer for a blocking backend (gloo) and
only the enqueue for NCCL.

In a single process (no process group, or a group of one) every
collective is the identity, as in the JAX package's single-controller
regime. The collectives block until done.

Point to point (`send`, `recv`, `isend`, `irecv`; `isend` counts
under comm/send, `irecv` under comm/recv): `dst` and `src` are global
ranks, `group` a torch.distributed group or a mesh `Group` (its
`process_group`). `recv` fills the caller's buffer, which fixes the
shape and dtype, and returns it. Sends from one rank to another arrive
in the order they were posted. A CUDA tensor crosses a gloo group
through a host copy (gloo's point-to-point reads and writes host
memory only); NCCL takes it as it is. In a single process there is no
peer and every one of them raises NotImplementedError, as the JAX
package's eager branch does (:712-716). The JAX package's in-trace
branch, a send / recv pair lowered to one `ppermute` inside a compiled
step, has no counterpart here: every rank is a process of its own, and
the pipeline schedule (`distributed.pipeline`) sends between them.
"""
from __future__ import annotations

import functools
import time

import torch
import torch.distributed as dist

from ..core import monitor as _monitor
from ..monitor import chaos as _chaos
from ..monitor import flight as _flight
from .env import group_size

__all__ = ["ReduceOp", "all_reduce", "all_gather", "broadcast", "barrier",
           "send", "recv", "isend", "irecv"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}

def _payload_bytes(x):
    if isinstance(x, (list, tuple)):
        return sum(_payload_bytes(e) for e in x)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _instrumented(op):
    """Count each call of `fn` in comm/<op>/*. `fn` returns (result,
    wire_bytes); wire_bytes None means the payload crossed the wire as
    it is (every call but the quantized all_reduce)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            # all_gather(tensor_list, tensor, group): the only op
            # here whose group can come third
            group = kwargs.get("group", args[2] if op == "all_gather"
                               and len(args) > 2 else None)
            if op == "all_gather":
                base = kwargs.get("tensor", args[1] if len(args) > 1
                                  else None)
                nbytes = _payload_bytes(base) * group_size(group)
            else:
                nbytes = _payload_bytes(kwargs.get("tensor", args[0] if args
                                                   else None))
            tok = None
            if _flight.recorder.enabled:
                tok = _flight.begin("collective", op, bytes=nbytes)
            t0 = time.perf_counter()
            try:
                # the chaos site sits INSIDE the span: an injected stall
                # is what the watchdog sees for a real wedged collective
                if _chaos._armed:
                    _chaos.hit("collective", op=op)
                out, wire = fn(*args, **kwargs)
            finally:
                # a leaked in-flight entry would look like a hang
                _flight.end(tok)
            host_us = int((time.perf_counter() - t0) * 1e6)
            _monitor.stat_add(f"comm/{op}/calls", 1)
            _monitor.stat_add(f"comm/{op}/host_us", host_us)
            if nbytes:
                _monitor.stat_add(f"comm/{op}/bytes", nbytes)
                _monitor.stat_add(f"comm/{op}/wire_bytes",
                                  nbytes if wire is None else wire)
            return out

        return wrapped

    return deco


def _quantized_all_reduce(tensor, op, group, cfg, nranks):
    """The stateless quantized allreduce (no error feedback): ravel,
    pad to the W*block multiple, two-phase reduce, slice back, in
    place. AVG divides by W. Returns (tensor, wire bytes: codes plus
    scale sidecars)."""
    from . import compress as C

    n = tensor.numel()
    blk = C.effective_block(cfg, n, nranks)
    L = C.padded_elems(cfg, n, nranks)
    flat = torch.zeros(L, dtype=torch.float32, device=tensor.device)
    flat[:n].copy_(tensor.reshape(-1))
    out, _ = C.all_reduce_flat(flat, group=group, cfg=cfg, block=blk)
    if op == ReduceOp.AVG:
        out = out / torch.tensor(float(nranks), device=out.device)
    tensor.copy_(out[:n].view(tensor.shape))
    return tensor, C.wire_bytes_of(cfg, L, block=blk)


@_instrumented("all_reduce")
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               compress=None):
    """Reduce `tensor` over the group, in place; returns it. The reduce
    is always synchronous: `sync_op` is accepted and changes nothing,
    as in the JAX package.

    `compress`: a spec string ("int8"/"fp8"/"fp32", ":block=N"), a
    CompressConfig, or True for $PADDLE_COMM_COMPRESS. A SUM or AVG of
    a float tensor over 2 or more ranks then rides the quantized
    allreduce (stateless: error feedback lives in the train step, where
    the residual is state). Other ops and integer dtypes take the plain
    wire, as the JAX package does when its PTA081 guard is disarmed.
    AVG is a SUM divided by W (gloo has no AVG)."""
    nranks = group_size(group)
    if nranks == 1:
        return tensor, None
    if op not in _TORCH_OPS and op != ReduceOp.AVG:
        raise ValueError(f"all_reduce: unsupported ReduceOp {op!r}")
    if compress is not None:
        from . import compress as C

        cfg = C.resolve(compress)
        if (cfg is not None and cfg.mode != "fp32"
                and op in (ReduceOp.SUM, ReduceOp.AVG)
                and tensor.is_floating_point()):
            return _quantized_all_reduce(tensor, op, group, cfg, nranks)
    if op == ReduceOp.AVG:
        dist.all_reduce(tensor, dist.ReduceOp.SUM, group=group)
        tensor.copy_(tensor / torch.tensor(float(nranks),
                                           device=tensor.device))
    else:
        dist.all_reduce(tensor, _TORCH_OPS[op], group=group)
    return tensor, None


@_instrumented("all_gather")
def all_gather(tensor_list, tensor, group=None):
    """Append every rank's `tensor`, in rank order, to tensor_list."""
    nranks = group_size(group)
    if nranks == 1:
        tensor_list.append(tensor)
        return tensor_list, None
    parts = [torch.empty_like(tensor) for _ in range(nranks)]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    tensor_list.extend(parts)
    return tensor_list, None


@_instrumented("broadcast")
def broadcast(tensor, src=0, group=None):
    """Overwrite `tensor` with global rank `src`'s, in place."""
    if group_size(group) > 1:
        dist.broadcast(tensor, src, group=group)
    return tensor, None


@_instrumented("barrier")
def barrier(group=None):
    """Wait until every rank of the group arrives."""
    if group_size(group) > 1:
        dist.barrier(group=group)
    return None, None


_NO_PEER = ("single-process eager point-to-point has no peer: start the "
            "ranks with `distributed.spawn` (or a launcher), or run the "
            "pipeline schedule with every stage local")


def _pg(group):
    """The torch.distributed group of `group` (a mesh Group or a
    torch.distributed group; None: the world)."""
    return getattr(group, "process_group", group)


def _through_host(tensor, pg):
    """Whether `tensor` must cross `pg` through a host copy."""
    return tensor.is_cuda and dist.get_backend(pg) == "gloo"


def _p2p_check(name, pg):
    if group_size(pg) == 1:
        raise NotImplementedError(f"paddle.distributed.{name}: {_NO_PEER}")


class _RecvTask:
    """The pending `irecv` of a CUDA tensor over gloo: `wait()` waits
    for the host buffer and copies it into the caller's tensor."""

    def __init__(self, work, host, tensor):
        self._work, self._host, self._tensor = work, host, tensor

    def wait(self):
        self._work.wait()
        self._tensor.copy_(self._host)
        return True

    def is_completed(self):
        return self._work.is_completed()


class _SendTask:
    """A pending `isend`: keeps the buffer on the wire (a host copy, or
    a contiguous one) alive until the send completes."""

    def __init__(self, work, buf):
        self._work, self._buf = work, buf

    def wait(self):
        return self._work.wait()

    def is_completed(self):
        return self._work.is_completed()


def _isend(tensor, dst, pg):
    buf = tensor.detach()
    buf = (buf.to("cpu") if _through_host(tensor, pg) else buf).contiguous()
    return _SendTask(dist.isend(buf, dst, group=pg), buf)


def _irecv(tensor, src, pg):
    if _through_host(tensor, pg):
        host = torch.empty(tensor.shape, dtype=tensor.dtype)
        return _RecvTask(dist.irecv(host, src, group=pg), host, tensor)
    if not tensor.is_contiguous():
        raise ValueError("recv: the buffer must be contiguous")
    return dist.irecv(tensor, src, group=pg)


@_instrumented("send")
def send(tensor, dst=0, group=None, sync_op=True):
    """Send `tensor` to global rank `dst`; with `sync_op` False, return
    the pending task (as `isend`)."""
    pg = _pg(group)
    _p2p_check("send", pg)
    task = _isend(tensor, dst, pg)
    if not sync_op:
        return task, None
    task.wait()
    return tensor, None


@_instrumented("recv")
def recv(tensor, src=0, group=None, sync_op=True):
    """Receive from global rank `src` into `tensor`, in place; returns
    it (with `sync_op` False, the pending task, as `irecv`)."""
    pg = _pg(group)
    _p2p_check("recv", pg)
    task = _irecv(tensor, src, pg)
    if not sync_op:
        return task, None
    task.wait()
    return tensor, None


def isend(tensor, dst=0, group=None):
    """Post a send of `tensor` to global rank `dst`; returns a task
    whose `wait()` blocks until it is done. Counted under comm/send."""
    return send(tensor, dst, group=group, sync_op=False)


def irecv(tensor, src=0, group=None):
    """Post a receive from global rank `src` into `tensor`; returns a
    task whose `wait()` blocks until `tensor` holds it. Counted under
    comm/recv."""
    return recv(tensor, src, group=group, sync_op=False)
