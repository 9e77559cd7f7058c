"""Weights carried across from the JAX package.

`paddle_tpu`'s serving code reads a GPT's weights as a parameter tree
(`model_runner.extract_params`): {"wte", "wpe", "blocks": {"ln1_w",
...}, "lnf_w", "lnf_b"}. The port's GPT keeps the same names, shapes
and `x @ W` orientation, so the tree — turned into numpy arrays by the
caller — loads name for name:

    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    load_reference_params(port_model, tree)

Trees of an O2 model (`amp.decorate` in the JAX package) hold bf16
arrays (numpy's `bfloat16` from ml_dtypes); they load into bf16 port
parameters unchanged, through an exact f32 round trip.

`load_reference_state_dict(model, flat)` loads a flat {structured
name: array} dict, as `dict(jax_model.state_dict())` gives it (BERT,
ResNet, `nn.Transformer` and the other models built from `nn` layers),
or the same names nested as a parameter tree, into a port model whose
parameters and persistent buffers (BatchNorm's running statistics)
carry the same names.

ERNIE and the other models built from fleet's tensor-parallel layers
keep the JAX package's names too. At mp > 1 each rank holds a shard:
`shard_state_dict(flat, mp_layout(model), nranks, rank)` cuts a full
dict to one rank's pieces (each parameter along its `mp_split` axis, in
its blocks, so the fused qkv weight is cut per head),
`load_sharded_state_dict(model, flat)` loads a full dict into this
rank's shards, and its inverse, `gather_state_dict(model)`, gathers the
model's full parameters from the ranks of its mp group (collective).
Under pipeline parallelism a rank holds one stage (its parameters carry
`pp_group`): `load_sharded_state_dict` loads the stage's names of the
full dict (and their mp shards at mp x pp), and `gather_state_dict`
also gathers the stages over the pp group, every rank's names in stage
order: a name two stages hold (a tied embedding) is taken from the
first, and a parameter that holds a stage's slice of a stacked tensor
(`pp_concat_dim`, GPT's blocks) is concatenated along that dim.

`optimizer_state_from_numpy` carries a JAX optimizer's slots (moments,
velocity, beta powers, master weights) into the port's
`Optimizer.set_state_dict` keys, so that both packages can go on from
the same mid-run state.

Nothing here imports JAX: the caller hands over numpy.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "load_reference_params",
           "load_reference_state_dict", "optimizer_state_from_numpy",
           "mp_layout", "shard_state_dict", "load_sharded_state_dict",
           "gather_state_dict"]


def _tensor(arr):
    """CPU tensor of a numpy array: bf16 stays bf16, anything else f32."""
    arr = np.asarray(arr)
    t = torch.from_numpy(np.array(arr, np.float32))
    return t.to(torch.bfloat16) if arr.dtype.name == "bfloat16" else t


def params_from_numpy(tree):
    """Flat {port parameter name: CPU tensor} from a numpy parameter
    tree: `wte`, `wpe`, `blocks.<name>`, `lnf_w`, `lnf_b`; bf16 arrays
    give bf16 tensors, the rest f32."""
    flat = {}
    for key, value in tree.items():
        if key == "blocks":
            for name, arr in value.items():
                flat[f"blocks.{name}"] = _tensor(arr)
        else:
            flat[key] = _tensor(value)
    return flat


@torch.no_grad()
def load_reference_params(model, tree):
    """Copy a numpy parameter tree into a port GPTModel /
    GPTForCausalLM in place, on the model's device (a pipeline stage
    takes its names and its slice of the blocks). Every parameter must
    be present with its exact shape; extra or missing names raise."""
    gpt = getattr(model, "gpt", model)
    flat = params_from_numpy(tree)
    if getattr(gpt, "pp_group", None) is not None:
        # a pipeline stage: its slice of the blocks, its own names
        own = dict(gpt.named_parameters())
        n = gpt.blocks["ln1_w"].shape[0]
        flat = {k: (v[n * gpt.pp_stage:n * (gpt.pp_stage + 1)]
                    if k.startswith("blocks.") else v)
                for k, v in flat.items() if k in own}
    own = dict(gpt.named_parameters())
    if set(flat) != set(own):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(own) - set(flat))}"
            f", unexpected {sorted(set(flat) - set(own))}")
    for name, value in flat.items():
        p = own[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: shape {tuple(value.shape)} != "
                f"{tuple(p.shape)}")
        p.copy_(value.to(device=p.device, dtype=p.dtype))
    return model


def _flatten(tree, prefix=""):
    """{"a.b.c": leaf} of a nested {"a": {"b": {"c": leaf}}} dict."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


@torch.no_grad()
def load_reference_state_dict(model, flat):
    """Copy a {structured name: array} dict (numpy arrays, or anything
    `np.asarray` takes) into the parameters and persistent buffers of
    the same names of a port model, in place, on the model's device and
    in each tensor's dtype. The dict may also be nested, a parameter
    tree ({"encoder": {"layers": {"0": ...}}}), whose keys join with
    ".". A missing, extra or misshapen name raises."""
    flat = _flatten(flat)
    own = dict(model.named_parameters())
    keys = set(model.state_dict())
    own.update((n, b) for n, b in model.named_buffers() if n in keys)
    if set(flat) != set(own):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(own) - set(flat))}"
            f", unexpected {sorted(set(flat) - set(own))}")
    values = {name: _tensor(arr) for name, arr in flat.items()}
    for name, value in values.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: shape {tuple(value.shape)} != "
                f"{tuple(own[name].shape)}")
    for name, value in values.items():
        p = own[name]
        p.copy_(value.to(device=p.device, dtype=p.dtype))
    return model


def optimizer_state_from_numpy(jax_state, names):
    """The port's `set_state_dict` dict of a JAX optimizer state.

    `jax_state` is either the compiled step's state tree, {JAX parameter
    name: {slot: array}}, or a flat {"<JAX name>.<slot>": array} dict as
    the eager `state_dict()` gives it (numpy arrays, or anything
    `np.asarray` takes), with an optional "@step" and "LR_Scheduler".
    `names` maps each JAX parameter name to the port's (a dict, or a
    callable); a name it does not map raises. Slots become f32 CPU
    tensors under "<port name>.<slot>"; `set_state_dict` moves them to
    the parameters' device."""
    rename = names if callable(names) else names.__getitem__
    flat = {}
    for key, value in jax_state.items():
        if key in ("@step", "LR_Scheduler"):
            continue
        if isinstance(value, dict):
            for slot, arr in value.items():
                flat[(key, slot)] = arr
        else:
            pname, _, slot = key.rpartition(".")
            flat[(pname, slot)] = value
    out = {f"{rename(pname)}.{slot}": torch.from_numpy(
               np.array(np.asarray(arr), np.float32))
           for (pname, slot), arr in flat.items()}
    out["@step"] = int(jax_state.get("@step", 0))
    if "LR_Scheduler" in jax_state:
        out["LR_Scheduler"] = dict(jax_state["LR_Scheduler"])
    return out


def mp_layout(model):
    """{parameter name: (axis, blocks)} of the model's parameters that
    the tensor-parallel layers cut (`mp_split`)."""
    return {n: p.mp_split for n, p in model.named_parameters()
            if getattr(p, "mp_split", None) is not None}


def _mp_group(model):
    """The mp Group the model's sharded parameters share; None at mp 1."""
    groups = {id(p.mp_group): p.mp_group for p in model.parameters()
              if getattr(p, "mp_group", None) is not None}
    if len(groups) > 1:
        raise ValueError("the model's parameters are sharded over more "
                         "than one mp group")
    return next(iter(groups.values()), None)


def shard_state_dict(flat, layout, nranks, rank):
    """Rank `rank`'s pieces of a full {name: array} dict: each name in
    `layout` cut along its axis in its blocks (`mp_layers.shard`), the
    rest whole."""
    from .distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
        shard)

    out = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        split = layout.get(name)
        out[name] = (arr if split is None or nranks == 1
                     else shard(arr, *split, nranks, rank))
    return out


def _pp_group(model):
    """The pp Group of a pipeline stage's parameters; None when the
    model holds every stage."""
    return next((p.pp_group for p in model.parameters()
                 if getattr(p, "pp_group", None) is not None), None)


def load_sharded_state_dict(model, flat):
    """Load a full {structured name: array} dict into this rank's shards
    of a tensor-parallel model (the whole dict at mp 1), or of a
    pipeline stage: the stage's names of the dict."""
    if _pp_group(model) is not None:
        own = set(model.state_dict())
        missing = sorted(own - set(flat))
        if missing:
            raise ValueError(f"parameter names missing: {missing}")
        flat = {n: v for n, v in flat.items() if n in own}
    group = _mp_group(model)
    if group is None:
        return load_reference_state_dict(model, flat)
    return load_reference_state_dict(model, shard_state_dict(
        flat, mp_layout(model), group.nranks, group.rank))


@torch.no_grad()
def gather_state_dict(model, tensors=None, all_ranks=True):
    """{name: full CPU tensor} of the model's parameters, or of
    `tensors` ({parameter name: tensor} laid out as the parameters, such
    as an optimizer's master weights), each sharded one all-gathered
    over its mp group (collective: every rank of the group calls it), in
    its own dtype. A pipeline stage's dict is then gathered with the
    other stages' over the pp group (collective too): onto every rank,
    or with `all_ranks` False onto the pp group's first rank only (the
    others get {})."""
    from .distributed import collective
    from .distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
        unshard)

    out = {}
    for name, p in model.named_parameters():
        t = (p if tensors is None else tensors[name]).detach().contiguous()
        if getattr(p, "mp_group", None) is not None:
            parts = collective.all_gather([], t,
                                          group=p.mp_group.process_group)
            t = unshard(parts, *p.mp_split)
        out[name] = t.cpu()
    pp = _pp_group(model)
    if pp is None:
        return out
    import torch.distributed as dist

    dims = {n: getattr(p, "pp_concat_dim", None)
            for n, p in model.named_parameters()}
    mine = {n: (t, dims[n]) for n, t in out.items()}
    if all_ranks:
        stages = [None] * pp.nranks
        dist.all_gather_object(stages, mine, group=pp.process_group)
    else:
        first = pp.rank == 0
        stages = [None] * pp.nranks if first else None
        dist.gather_object(mine, stages, dst=pp.ranks[0],
                           group=pp.process_group)
        if not first:
            return {}
    out = {}
    for stage in stages:
        for name, (t, dim) in stage.items():
            if name not in out:
                out[name] = t
            elif dim is not None:
                out[name] = torch.cat([out[name], t], dim)
    return out
