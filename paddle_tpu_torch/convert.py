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
ResNet and the other models built from `nn` layers), into a port model
whose parameters and persistent buffers (BatchNorm's running
statistics) carry the same names.

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
           "load_reference_state_dict", "optimizer_state_from_numpy"]


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
    GPTForCausalLM in place, on the model's device. Every parameter
    must be present with its exact shape; extra or missing names
    raise."""
    gpt = getattr(model, "gpt", model)
    flat = params_from_numpy(tree)
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


@torch.no_grad()
def load_reference_state_dict(model, flat):
    """Copy a flat {structured name: array} dict (numpy arrays, or
    anything `np.asarray` takes) into the parameters and persistent
    buffers of the same names of a port model, in place, on the model's
    device and in each tensor's dtype. A missing, extra or misshapen
    name raises."""
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
