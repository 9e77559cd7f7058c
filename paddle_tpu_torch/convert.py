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

Nothing here imports JAX: the caller hands over numpy.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "load_reference_params"]


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
