"""GPT-2 in PyTorch: the port of `paddle_tpu/text/models/gpt.py`
(forward, causal-LM loss and training).

The L transformer blocks keep ONE set of stacked parameters with a
leading layer dim, under the JAX package's names (`wte`, `wpe`,
`blocks.{ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b,
fc1_w, fc1_b, fc2_w, fc2_b}`, `lnf_w`, `lnf_b`) and its `x @ W`
orientation (`qkv_w` is [L, H, 3H]), so a parameter tree carries over
name for name (`paddle_tpu_torch.convert`). The LM head is tied to the
token embedding.

LayerNorm goes through the fused kernel wrappers of
`incubate.nn.kernels.layernorm` — the CUDA kernels on the card, their
plain versions on the CPU, with the backward kernel as the gradient —
or, with `use_kernel=False` (`gpt_forward`, `gpt_loss`, the serving
forward passes), explicitly through the plain versions. The full
forward's attention goes through `flash_attention` (forward and
backward kernels) when `use_flash` is set and the head_dim is one the
kernels take (`flash_supported`), as the JAX model takes its flash
kernel on the TPU (gpt.py:118-126); otherwise, and in the serving
prefill, it is the dense causal form (f32 scores, the -1e30 mask, f32
softmax, probabilities cast to q's dtype before P.V).

Training: `GPTForCausalLM(input_ids, labels)` returns the causal-LM
loss (`gpt_loss`, the port of `_k_gpt_loss`). `remat` recomputes each
block in the backward (`torch.utils.checkpoint`, the port of
`jax.checkpoint`). Dropout > 0 in training mode is inverted dropout
whose masks come from the model's own `torch.Generator`; each block
draws its masks from a generator seeded once per forward, so a
recomputed block replays the same masks. The masks are not JAX's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...incubate.nn.kernels import flash_attention as _fa
from ...incubate.nn.kernels import layernorm as _ln

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_small",
           "gpt2_345m", "gpt_forward", "gpt_loss"]

_BLOCK_PARAMS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_hidden: int = 4096
    max_seq_len: int = 1024
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    remat: bool = True  # recompute each block in the backward


def _attention(q, k, v, n_head):
    """Dense causal attention over [B, S, H] q/k/v (gpt.py:129-135)."""
    b, s, h = q.shape
    d = h // n_head
    q = q.reshape(b, s, n_head, d).transpose(1, 2)
    k = k.reshape(b, s, n_head, d).transpose(1, 2)
    v = v.reshape(b, s, n_head, d).transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = probs @ v
    return out.transpose(1, 2).reshape(b, s, h)


def _flash_or_dense(q, k, v, n_head, use_flash, use_kernel):
    """Causal attention over [B, S, H] q/k/v for the full forward: the
    flash kernels when `use_flash` and the head_dim is one they take
    (the plain flash versions when `use_kernel` is False), else dense
    (gpt.py:118-135)."""
    b, s, h = q.shape
    d = h // n_head
    if not (use_flash and _fa.flash_supported(d)):
        return _attention(q, k, v, n_head)
    q, k, v = (t.reshape(b, s, n_head, d).transpose(1, 2).contiguous()
               for t in (q, k, v))
    out = _fa.flash_attention(q, k, v, True, 1.0 / math.sqrt(d),
                              use_kernel=use_kernel)
    return out.transpose(1, 2).reshape(b, s, h)


def _layer_norm(x, w, b, eps, use_kernel=True):
    """LayerNorm over the last dim (gpt.py:149-160): the fused kernel's
    wrapper, or its plain version when `use_kernel` is False."""
    if use_kernel:
        return _ln.fused_layer_norm(x, w, b, eps)
    return _ln.fused_layer_norm_reference(x, w, b, eps)


def _residual_layer_norm(add, x, w, b, eps, use_kernel=True):
    """(LayerNorm(x + add), x + add) (gpt.py:163-175)."""
    if use_kernel:
        return _ln.fused_residual_layer_norm(add, x, w, b, eps)
    return _ln.fused_residual_layer_norm_reference(add, x, w, b, eps)


def _dropout(x, rate, generator):
    """Inverted dropout (gpt.py:178-182): keep with probability
    1 - rate, kept values scaled by 1 / (1 - rate)."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _block(x, bp, n_head, eps, use_kernel, use_flash=False, dropout=0.0,
           seed=None):
    """One pre-LN transformer block (gpt.py:185-204). With dropout,
    both masks come from a generator seeded with `seed`."""
    gen = None
    if dropout > 0.0 and seed is not None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
    hidden = x.shape[-1]
    h = _layer_norm(x, bp["ln1_w"], bp["ln1_b"], eps, use_kernel)
    qkv = h @ bp["qkv_w"] + bp["qkv_b"]
    q, k, v = qkv.split(hidden, dim=-1)
    attn = _flash_or_dense(q, k, v, n_head, use_flash, use_kernel)
    attn = attn @ bp["proj_w"] + bp["proj_b"]
    attn = _dropout(attn, dropout, gen)
    h, x = _residual_layer_norm(attn, x, bp["ln2_w"], bp["ln2_b"], eps,
                                use_kernel)
    ffn = F.gelu(h @ bp["fc1_w"] + bp["fc1_b"], approximate="tanh")
    ffn = ffn @ bp["fc2_w"] + bp["fc2_b"]
    ffn = _dropout(ffn, dropout, gen)
    return x + ffn


def layer_params(blocks, layer):
    """This layer's slices of the stacked block parameters."""
    return {name: p[layer] for name, p in blocks.items()}


def gpt_forward(ids, params, n_head, eps, use_kernel=True, use_flash=False,
                remat=False, dropout=0.0, generator=None):
    """Full causal forward: ids [B, S] -> logits [B, S, V]
    (`_k_gpt_forward`). `use_flash` sends attention through the flash
    kernels where the head_dim allows; `remat` recomputes each block in
    the backward; `dropout` > 0 draws masks from `generator` (no
    generator: no dropout)."""
    ids = ids.long()
    x = params["wte"][ids]
    x = x + params["wpe"][:ids.shape[1]]
    blocks = params["blocks"]
    n_layers = blocks["ln1_w"].shape[0]
    seeds = [None] * n_layers
    if dropout > 0.0 and generator is not None:
        x = _dropout(x, dropout, generator)
        seeds = torch.randint(0, 2 ** 62, (n_layers,), generator=generator,
                              device=generator.device).tolist()
    for layer in range(n_layers):
        args = (x, layer_params(blocks, layer), n_head, eps, use_kernel,
                use_flash, dropout, seeds[layer])
        if remat:
            x = checkpoint(_block, *args, use_reentrant=False)
        else:
            x = _block(*args)
    x = _layer_norm(x, params["lnf_w"], params["lnf_b"], eps, use_kernel)
    return x @ params["wte"].T


def gpt_loss(ids, labels, params, n_head, eps, use_kernel=True,
             use_flash=False, remat=False, dropout=0.0, generator=None):
    """Causal-LM loss with the next-token shift (`_k_gpt_loss`,
    gpt.py:275-296): position t predicts labels[t + 1]; the loss is
    logsumexp minus the gathered logit, in f32, averaged over
    B * (S - 1)."""
    logits = gpt_forward(ids, params, n_head, eps, use_kernel, use_flash,
                         remat, dropout, generator)
    lg = logits[:, :-1].float()
    tgt = labels[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return (lse - picked).mean()


class GPTModel(nn.Module):
    """Decoder-only transformer with stacked-layer parameters.

    `device` defaults to the CUDA card (raises without one; pass
    device="cpu" for the plain path). Weights are drawn from
    `generator` (a torch.Generator on `device`; default: seed 0 there)
    at std `initializer_range`, with proj_w and fc2_w divided by
    sqrt(2L), as the JAX package initialises them; one more draw from
    it seeds `dropout_generator`, the source of the dropout masks. The
    LayerNorm scales and shifts carry `no_amp_cast`: `amp.decorate`
    leaves them f32 (gpt.py:343-347)."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        self.config = c = config
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        std = c.initializer_range

        def normal(*shape):
            return std * torch.randn(shape, generator=generator,
                                     device=dev, dtype=torch.float32)

        def const(value, *shape):
            return torch.full(shape, value, dtype=torch.float32,
                              device=dev)

        L, H, F_, V, S = (c.num_layers, c.hidden_size, c.ffn_hidden,
                          c.vocab_size, c.max_seq_len)
        self.wte = nn.Parameter(normal(V, H))
        self.wpe = nn.Parameter(normal(S, H))
        blocks = {
            "ln1_w": const(1.0, L, H),
            "ln1_b": const(0.0, L, H),
            "qkv_w": normal(L, H, 3 * H),
            "qkv_b": const(0.0, L, 3 * H),
            "proj_w": normal(L, H, H) / math.sqrt(2 * L),
            "proj_b": const(0.0, L, H),
            "ln2_w": const(1.0, L, H),
            "ln2_b": const(0.0, L, H),
            "fc1_w": normal(L, H, F_),
            "fc1_b": const(0.0, L, F_),
            "fc2_w": normal(L, F_, H) / math.sqrt(2 * L),
            "fc2_b": const(0.0, L, H),
        }
        self.blocks = nn.ParameterDict(
            {name: nn.Parameter(blocks[name]) for name in _BLOCK_PARAMS})
        self.lnf_w = nn.Parameter(const(1.0, H))
        self.lnf_b = nn.Parameter(const(0.0, H))
        for p in (self.blocks["ln1_w"], self.blocks["ln1_b"],
                  self.blocks["ln2_w"], self.blocks["ln2_b"], self.lnf_w,
                  self.lnf_b):
            p.no_amp_cast = True
        seed = torch.randint(0, 2 ** 62, (), generator=generator,
                             device=dev)
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(seed))

    @property
    def device(self):
        return self.wte.device

    def params_tree(self, detach=True):
        """{"wte", "wpe", "blocks": {...}, "lnf_w", "lnf_b"} of the
        parameters (`_params_tree` in the JAX package): detached
        tensors for the serving passes, or with `detach=False` the
        parameters themselves, for a forward that trains."""
        def own(p):
            return p.detach() if detach else p

        return {
            "wte": own(self.wte),
            "wpe": own(self.wpe),
            "blocks": {k: own(p) for k, p in self.blocks.items()},
            "lnf_w": own(self.lnf_w),
            "lnf_b": own(self.lnf_b),
        }

    def _run(self, fn, *args):
        c = self.config
        drop = c.dropout if self.training else 0.0
        args = [torch.as_tensor(a, device=self.device) for a in args]
        return fn(*args, self.params_tree(detach=False), c.num_heads,
                  c.layer_norm_eps, use_flash=c.use_flash_attention,
                  remat=c.remat, dropout=drop,
                  generator=self.dropout_generator if drop > 0.0 else None)

    def forward(self, input_ids):
        """Logits [B, S, V]; dropout only in training mode."""
        return self._run(gpt_forward, input_ids)


class GPTForCausalLM(nn.Module):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        self.gpt = GPTModel(config, device=device, generator=generator)
        self.config = config

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V], or with `labels` the causal-LM loss
        (`gpt_loss`, a 0-d f32 tensor), as gpt.py:383-399."""
        if labels is None:
            return self.gpt(input_ids)
        return self.gpt._run(gpt_loss, input_ids, labels)


def gpt2_small(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, ffn_hidden=3072, **kw)


def gpt2_345m(**kw):
    """GPT-2 medium / Megatron 345M."""
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, ffn_hidden=4096, **kw)
