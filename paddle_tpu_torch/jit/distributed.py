"""Data-parallel train step over torch.distributed, the port of
`paddle_tpu/jit/distributed.py` `DistributedTrainStepCompiler`.

    init_parallel_env()            # or inside distributed.spawn(...)
    step = DistributedTrainStepCompiler(model, opt, comm_compress="int8:ef")
    loss = step(ids, labels)       # every rank passes the GLOBAL batch

    mesh = build_mesh({"dp": 1, "pp": 1, "mp": -1})
    step = DistributedTrainStepCompiler(model, opt, mesh=mesh)

The group the step reduces over is `group` (a torch.distributed group;
None: the world) or, with `mesh=` (a `distributed.mesh.Mesh`), the
mesh's dp group: this rank's line along "dp", the ranks that hold the
same parameter shards. `mesh=` also sets the mesh as the current one,
as the JAX class does. The batch split, the first-call broadcast and
the gradient and loss reductions below all run over that group, so
under model parallelism (an "mp" axis, whose layers reduce over their
own group) nothing is reduced or broadcast across the mp ranks. The
JAX class shards the batch over "dp" by default (`_batch_sharding`) and
GSPMD reduces the gradients of replicated parameters over it.

The JAX class compiles one program over a mesh, where GSPMD inserts the
gradient psum over the data axis, or, with `comm_compress`, an explicit
shard_map island whose allreduce is the quantized one. Here every rank
is a process that runs the base `TrainStepCompiler` microstep on its own
share of the batch, and the gradients are reduced where the JAX island
sits (:253-325): right after backward and the GradScaler unscale,
before the non-finite guard and the gradient merge.

- The batch: every rank receives the global batch, as every JAX process
  does, and takes its contiguous 1/W slice of dim 0 (dim 1 under
  `steps_per_dispatch > 1`, where dim 0 is the microstep axis;
  `_batch_sharding` :108-126). Elements without that dimension are
  replicated.
- The parameters (and float buffers) are broadcast from the group's
  rank 0 at the first call, the c_broadcast-at-startup analog. The
  optimizer's slots are created at its first update, after that.
- `comm_compress` (a spec "int8"/"fp8"[:ef][:block=N] or the explicit
  "fp32" twin, a CompressConfig, None/False for off, True (default)
  for $PADDLE_COMM_COMPRESS): the gradients, in sorted name order (the
  order of the JAX package's gradient pytree), are packed into one flat
  f32 buffer and reduced by `compress.reduce_tree` (SUM, then / W).
  Compression off: each gradient is SUM-allreduced in its own dtype
  and divided by W, the GSPMD psum-mean, and no comm counter moves. In
  both cases the returned loss is the mean over ranks (`pmean`, :308).
- Error feedback: the residual is one flat (L,) f32 tensor per rank,
  zero at the first call, L = `padded_elems` of the packed gradient
  (`_init_comm_state` :226-251), in `self._comm_state["residual"]`. A
  microstep the guard trips keeps the old residual, as in the JAX
  package. `restore_state(..., comm=)` (or `adopt_state_from`) before
  the first call sets the residual the first call then keeps.
- Validation at the first call (`_resolve_compress` :153-203): fewer
  than 2 ranks disables compression; a mesh axis other than "dp" of
  size > 1, or a parameter that carries a `dist_spec` (a sharded
  layout, which has no single flat gradient), raises for an explicit
  spec and disables an env spec.
- Accounting (`compress.account`, called by `reduce_tree`:
  comm/all_reduce/{calls,bytes,wire_bytes}) runs once per microstep
  that reduces; the JAX package prices it once per program build.

`accumulate_steps`, `guard_nonfinite`, `grad_scaler` and
`steps_per_dispatch` compose as in the base class. Under model or
pipeline parallelism (a mesh axis other than "dp" above 1) the guard's
verdict, which the GradScaler reads too, is agreed over every rank, so
all skip a microstep together.

Pipeline parallelism (a mesh whose "pp" size S is above 1): the model
is a GPT built under that mesh with `GPTConfig.pp_num_stages` S, so
this rank holds one stage (`text.models.gpt`). Each microstep then runs
`distributed.pipeline`'s schedule over the pp group, in
`GPTConfig.pp_schedule`'s order, with `pp_microbatches` micro-batches
of this rank's dp share of the batch, in place of the forward and
backward; then the tied `wte`'s gradient is summed over the first and
last stages, and the step goes on as above (the dp reduction over the
mesh's dp group only). The loss is the mean of the micro-batch losses
(and of the dp ranks'), on every rank. A model that holds every stage
(built before the mesh was set), or one without pp stages, raises, as
does a mesh whose pp size is not the model's S. `fleet`'s
`PipelineLayer` models train over pp through `PipelineParallel`.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..distributed import collective
from ..distributed import compress as C
from ..distributed import mesh as mesh_mod
from ..distributed.env import group_rank, group_size
from ..distributed.pipeline import PipelineSchedule
from . import TrainStepCompiler

__all__ = ["DistributedTrainStepCompiler"]


class DistributedTrainStepCompiler(TrainStepCompiler):
    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 batch_specs=None, donate=True, *, group=None,
                 comm_compress=True, **kwargs):
        if batch_specs is not None:
            raise NotImplementedError("DistributedTrainStepCompiler: "
                                      "batch_specs is not ported")
        super().__init__(model, optimizer, loss_fn=loss_fn, donate=donate,
                         **kwargs)
        if mesh is not None:
            if group is not None:
                raise ValueError("DistributedTrainStepCompiler: pass a "
                                 "mesh or a group, not both")
            mesh_mod.set_mesh(mesh)
            group = mesh.group(("dp",)).process_group
        self._mesh = mesh
        self._group = group
        self._pp = self._pipeline(model, loss_fn, mesh)
        self._compress = C.resolve(comm_compress)
        # an env config disables itself on an incompatible layout; an
        # explicit constructor spec raises instead
        self._compress_from_env = comm_compress is True
        self._nranks = None          # resolved at the first call
        self._rank = 0
        self._pending_residual = None

    @staticmethod
    def _pipeline(model, loss_fn, mesh):
        """(the GPT, its schedule) when `mesh` has a pp axis above 1;
        None otherwise."""
        S = 1 if mesh is None else mesh.shape.get("pp", 1)
        if S < 2:
            return None
        gpt = getattr(model, "gpt", model)
        if not hasattr(gpt, "pp_stage_forward") or loss_fn is not None:
            raise TypeError(
                "DistributedTrainStepCompiler: a pp > 1 mesh needs a GPT "
                "built with pp_num_stages and no loss_fn; train a "
                "PipelineLayer through fleet's PipelineParallel")
        if gpt.pp_group is None:
            raise ValueError(
                "DistributedTrainStepCompiler: the model holds every "
                f"pipeline stage, but the mesh's pp axis has {S} ranks: "
                "build the model after the mesh is set")
        if gpt.pp_stages != S:
            raise ValueError(f"the mesh's pp axis has {S} ranks, the "
                             f"model {gpt.pp_stages} stages")
        from ..text.models.gpt import causal_lm_loss

        return gpt, PipelineSchedule(gpt.pp_stage_forward, gpt.pp_group,
                                     loss_fn=causal_lm_loss)

    def _forward_backward(self, batch, scale):
        if self._pp is None:
            return super()._forward_backward(batch, scale)
        gpt, sched = self._pp
        c = gpt.config
        if gpt.training and c.dropout > 0.0:
            raise ValueError("GPipe path requires dropout=0.0 for now")
        ids, labels = batch
        loss = sched.train(
            ids, labels, max(c.pp_microbatches, 1), c.pp_schedule,
            loss_scale=scale if self._grad_scaler is not None else None)
        gpt.allreduce_shared_weight_gradients()
        return loss

    def _agree(self, ok):
        mesh = self._mesh
        if mesh is None or all(n == 1 for a, n in mesh.shape.items()
                               if a != "dp"):
            return ok
        flag = torch.tensor(float(ok))
        if dist.get_backend() != "gloo":
            flag = flag.to(self._device())
        collective.all_reduce(flag, collective.ReduceOp.MIN)
        return bool(flag.item())

    def _resolve_compress(self):
        cfg = self._compress
        if cfg is None:
            return None
        if self._nranks < 2:
            return None              # nothing to compress

        def incompatible(why):
            if not self._compress_from_env:
                raise ValueError(f"comm_compress={cfg.spec()!r}: {why}")
            warnings.warn(f"comm_compress={cfg.spec()} "
                          f"(PADDLE_COMM_COMPRESS): {why} — disabled "
                          "for this compiler", stacklevel=4)

        others = ([a for a, n in self._mesh.shape.items()
                   if a != "dp" and n > 1] if self._mesh is not None else [])
        if others:
            incompatible(f"needs a pure data-parallel mesh, but axes "
                         f"{others} are also > 1")
            return None
        for name, p in self._model.named_parameters():
            spec = getattr(p, "dist_spec", None)
            if spec is not None:
                incompatible(f"needs replicated parameters, but {name!r} "
                             f"carries dist_spec={spec!r}")
                return None
        return cfg

    def _params(self):
        """(name, param) of every trainable parameter, sorted by name:
        the packing order, the same on every rank."""
        return sorted(((n, p) for n, p in self._opt._named
                       if p.requires_grad), key=lambda np_: np_[0])

    def _setup(self):
        self._nranks = group_size(self._group)
        self._rank = group_rank(self._group)
        self._compress = self._resolve_compress()
        cfg = self._compress
        if cfg is not None and cfg.ef:
            total = sum(p.numel() for _, p in self._params())
            L = C.padded_elems(cfg, total, self._nranks)
            # a restored (or adopted) residual of this length is kept:
            # exact error-feedback resume is a same-world-size contract
            res = self._comm_state.get("residual")
            if res is None or tuple(res.shape) != (L,):
                self._comm_state["residual"] = torch.zeros(
                    L, dtype=torch.float32, device=self._device())
        else:
            self._comm_state.pop("residual", None)
        if self._nranks > 1:
            src = (0 if self._group is None
                   else dist.get_global_rank(self._group, 0))
            with torch.no_grad():
                for t in list(self._model.parameters()) + [
                        b for b in self._model.buffers()
                        if b.is_floating_point()]:
                    dist.broadcast(t.data, src, group=self._group)

    def _shard(self, batch):
        """This rank's contiguous 1/W slice of every batch element."""
        W, r = self._nranks, self._rank
        if W == 1:
            return batch
        dim = 1 if self._steps_per_dispatch > 1 else 0
        out = []
        for b in batch:
            t = torch.as_tensor(b)
            if t.dim() <= dim:
                out.append(t)
                continue
            n = t.shape[dim]
            if n % W:
                raise ValueError(
                    f"DistributedTrainStepCompiler: batch dim {dim} of "
                    f"size {n} does not split over {W} ranks")
            out.append(t.narrow(dim, r * (n // W), n // W).contiguous())
        return out

    def __call__(self, *batch):
        if self._nranks is None:
            self._setup()
        return super().__call__(*self._shard(batch))

    def _reduce_grads(self, loss, named):
        W = self._nranks
        if W == 1:
            return loss, named
        params = self._params()
        grads = {n: p.grad for n, p in params}
        dev = loss.device
        div = torch.tensor(float(W), device=dev)   # a true division
        cfg = self._compress
        if cfg is None:
            for n, p in params:
                g = grads[n]
                dist.all_reduce(g, dist.ReduceOp.SUM, group=self._group)
                p.grad = g / div
        else:
            segs = C.pack.segments([n for n, _ in params], grads)
            mean, self._pending_residual = C.reduce_tree(
                grads, segs, group=self._group, cfg=cfg,
                residual=self._comm_state.get("residual"))
            for n, p in params:
                p.grad = mean[n]
        loss = loss.detach().clone()
        dist.all_reduce(loss, dist.ReduceOp.SUM, group=self._group)
        return loss / div, params

    def _commit_comm(self, ok):
        if ok and self._pending_residual is not None:
            self._comm_state["residual"] = self._pending_residual
        self._pending_residual = None
