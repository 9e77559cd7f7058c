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

Pipeline parallelism (`pp_num_stages` S > 1, `pp_microbatches` M > 1,
`pp_schedule` "gpipe" or "1f1b"; gpt.py:69-78, 240-262). With no pp
group live the loss is the JAX package's micro-batched schedule in one
process: the embedding on the whole batch, the blocks micro-batch by
micro-batch, the head and the loss on the whole batch, differentiated
by autograd (both schedules give these numbers). Under a live pp group
of S ranks (the current mesh's "pp" axis when the model is built) each
rank is one stage: it builds the whole model from the seed, in order,
and keeps `num_layers / S` blocks (`blocks.*` hold that slice and carry
`pp_concat_dim` 0), stage 0 also `wte` and `wpe`, the last stage `lnf`
and the tied `wte` (`pp_shared_copy`), every parameter carrying
`pp_group`. `pp_stage_forward` is the stage's part of the forward on a
micro-batch and `causal_lm_loss` the last stage's loss;
`jit.distributed.DistributedTrainStepCompiler(mesh=)` runs them through
`distributed.pipeline`'s schedule and `allreduce_shared_weight_
gradients` sums the tied `wte`'s gradient over the first and last
stages. As in the JAX package, the pp path refuses dropout > 0 in
training and `num_layers` not divisible by S; a live pp group whose
size is not S raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...distributed.fleet.meta_parallel.parallel_layers import pp_layers
from ...distributed.pipeline import SCHEDULES, microbatch
from ...incubate.nn.kernels import flash_attention as _fa
from ...incubate.nn.kernels import layernorm as _ln

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_small",
           "gpt2_345m", "gpt_forward", "gpt_loss", "causal_lm_loss"]

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
    # sequence-parallel attention and selective remat are not ported: a
    # value other than the default raises (`scan_unroll` is a JAX
    # dispatch knob with nothing to do here, so any value is taken)
    use_ring_attention: bool = False
    sp_attention: str = "ring"
    remat: bool = True  # recompute each block in the backward
    remat_policy: str | None = None
    scan_unroll: int | bool = 1
    # pipeline: num_layers cut into pp_num_stages stages, the batch into
    # pp_microbatches micro-batches (0: no pipeline)
    pp_num_stages: int = 0
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"   # or "1f1b"

    def __post_init__(self):
        if self.use_ring_attention:
            raise NotImplementedError(
                "GPTConfig: use_ring_attention is not ported")
        if self.remat_policy is not None:
            raise NotImplementedError(
                f"GPTConfig: remat_policy={self.remat_policy!r} is not "
                "ported")


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


def _embed(ids, params):
    ids = ids.long()
    return params["wte"][ids] + params["wpe"][:ids.shape[1]]


def _blocks(x, blocks, n_head, eps, use_kernel, use_flash, remat, dropout,
            seeds):
    """Every block of the stacked `blocks`, in order."""
    for layer in range(blocks["ln1_w"].shape[0]):
        args = (x, layer_params(blocks, layer), n_head, eps, use_kernel,
                use_flash, dropout, seeds[layer])
        if remat:
            x = checkpoint(_block, *args, use_reentrant=False)
        else:
            x = _block(*args)
    return x


def _head(x, params, eps, use_kernel):
    """The final LayerNorm and the tied head: logits."""
    x = _layer_norm(x, params["lnf_w"], params["lnf_b"], eps, use_kernel)
    return x @ params["wte"].T


def _check_pp(n_layers, dropout, generator, pp_stages, pp_schedule):
    """The JAX package's refusals on the pipelined path (gpt.py:241-246)
    and its schedule names."""
    if dropout > 0.0 and generator is not None:
        raise ValueError("GPipe path requires dropout=0.0 for now")
    if n_layers % pp_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{pp_stages} pipeline stages")
    if pp_schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {pp_schedule!r}")


def gpt_forward(ids, params, n_head, eps, use_kernel=True, use_flash=False,
                remat=False, dropout=0.0, generator=None, pp_stages=0,
                pp_microbatches=0, pp_schedule="gpipe"):
    """Full causal forward: ids [B, S] -> logits [B, S, V]
    (`_k_gpt_forward`). `use_flash` sends attention through the flash
    kernels where the head_dim allows; `remat` recomputes each block in
    the backward; `dropout` > 0 draws masks from `generator` (no
    generator: no dropout). With `pp_stages` > 1 and `pp_microbatches`
    > 1 the blocks run micro-batch by micro-batch (the JAX package's
    pipelined loop in one process)."""
    x = _embed(ids, params)
    blocks = params["blocks"]
    n_layers = blocks["ln1_w"].shape[0]
    seeds = [None] * n_layers
    if dropout > 0.0 and generator is not None:
        x = _dropout(x, dropout, generator)
        seeds = torch.randint(0, 2 ** 62, (n_layers,), generator=generator,
                              device=generator.device).tolist()
    run = (blocks, n_head, eps, use_kernel, use_flash, remat, dropout, seeds)
    if pp_stages > 1 and pp_microbatches > 1:
        _check_pp(n_layers, dropout, generator, pp_stages, pp_schedule)
        x = torch.cat([_blocks(xm, *run)
                       for xm in microbatch(x, pp_microbatches)], 0)
    else:
        x = _blocks(x, *run)
    return _head(x, params, eps, use_kernel)


def causal_lm_loss(logits, labels):
    """Position t predicts labels[t + 1]: logsumexp minus the gathered
    logit, in f32, averaged over B * (S - 1) (gpt.py:285-296)."""
    lg = logits[:, :-1].float()
    tgt = labels[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return (lse - picked).mean()


def gpt_loss(ids, labels, params, n_head, eps, use_kernel=True,
             use_flash=False, remat=False, dropout=0.0, generator=None,
             pp_stages=0, pp_microbatches=0, pp_schedule="gpipe"):
    """Causal-LM loss with the next-token shift (`_k_gpt_loss`,
    gpt.py:275-296) of `gpt_forward`'s logits (`causal_lm_loss`)."""
    logits = gpt_forward(ids, params, n_head, eps, use_kernel, use_flash,
                         remat, dropout, generator, pp_stages,
                         pp_microbatches, pp_schedule)
    return causal_lm_loss(logits, labels)


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

    def __init__(self, config: GPTConfig, *, device=None, generator=None):
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
        wte, wpe = normal(V, H), normal(S, H)
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
        lnf_w, lnf_b = const(1.0, H), const(0.0, H)
        seed = torch.randint(0, 2 ** 62, (), generator=generator,
                             device=dev)
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(seed))
        group = self.pp_group = pp_layers.pipe_group()
        P = c.pp_num_stages
        self.pp_stage, self.pp_stages = 0, 1
        if group is not None:
            if P != group.nranks:
                raise ValueError(
                    f"GPTConfig.pp_num_stages is {P}, but the mesh's pp "
                    f"axis has {group.nranks} ranks")
            _check_pp(L, 0.0, None, P, c.pp_schedule)
            self.pp_stage, self.pp_stages = group.rank, P
            lo = L // P * group.rank
            blocks = {n: t[lo:lo + L // P].clone() for n, t in blocks.items()}
        first, last = self.is_first_stage, self.is_last_stage
        if first or last:
            self.wte = nn.Parameter(wte)
        if first:
            self.wpe = nn.Parameter(wpe)
        self.blocks = nn.ParameterDict(
            {name: nn.Parameter(blocks[name]) for name in _BLOCK_PARAMS})
        norms = [self.blocks[n] for n in ("ln1_w", "ln1_b", "ln2_w",
                                          "ln2_b")]
        if last:
            self.lnf_w = nn.Parameter(lnf_w)
            self.lnf_b = nn.Parameter(lnf_b)
            norms += [self.lnf_w, self.lnf_b]
        for p in norms:
            p.no_amp_cast = True
        self._shared_wte_group = None
        if group is not None:
            if last:
                self.wte.pp_shared_copy = True
            for p in self.blocks.values():
                p.pp_concat_dim = 0
            for p in self.parameters():
                p.pp_group = group
            self._shared_wte_group = pp_layers.stages_subgroup(
                group, [0, P - 1])

    @property
    def device(self):
        return self.blocks["ln1_w"].device

    @property
    def is_first_stage(self):
        return self.pp_stage == 0

    @property
    def is_last_stage(self):
        return self.pp_stage == self.pp_stages - 1

    def pp_stage_forward(self, x):
        """This pipeline stage's part of the forward on one micro-batch:
        the first stage takes ids, the last returns logits, the others
        map hidden states to hidden states."""
        c = self.config
        params = self.params_tree(detach=False)
        if self.is_first_stage:
            x = _embed(torch.as_tensor(x, device=self.device), params)
        x = _blocks(x, params["blocks"], c.num_heads, c.layer_norm_eps,
                    True, c.use_flash_attention, c.remat, 0.0,
                    [None] * params["blocks"]["ln1_w"].shape[0])
        if self.is_last_stage:
            x = _head(x, params, c.layer_norm_eps, True)
        return x

    def allreduce_shared_weight_gradients(self):
        """Sum the tied `wte`'s gradient over the first and the last
        stage (after the schedule, before the clip)."""
        if self._shared_wte_group is not None:
            pp_layers.allreduce_gradients([self.wte],
                                          self._shared_wte_group)

    def params_tree(self, detach=True):
        """{"wte", "wpe", "blocks": {...}, "lnf_w", "lnf_b"} of the
        parameters (`_params_tree` in the JAX package): detached
        tensors for the serving passes, or with `detach=False` the
        parameters themselves, for a forward that trains."""
        def own(p):
            return p.detach() if detach else p

        tree = {name: own(getattr(self, name))
                for name in ("wte", "wpe", "lnf_w", "lnf_b")
                if hasattr(self, name)}
        tree["blocks"] = {k: own(p) for k, p in self.blocks.items()}
        return tree

    def _run(self, fn, *args):
        c = self.config
        if self.pp_group is not None:
            raise RuntimeError(
                f"GPTModel: this model is stage {self.pp_stage} of a "
                f"pipeline over {self.pp_stages} ranks; train it through "
                "jit.distributed.DistributedTrainStepCompiler(mesh=)")
        drop = c.dropout if self.training else 0.0
        args = [torch.as_tensor(a, device=self.device) for a in args]
        return fn(*args, self.params_tree(detach=False), c.num_heads,
                  c.layer_norm_eps, use_flash=c.use_flash_attention,
                  remat=c.remat, dropout=drop,
                  generator=self.dropout_generator if drop > 0.0 else None,
                  pp_stages=c.pp_num_stages,
                  pp_microbatches=c.pp_microbatches,
                  pp_schedule=c.pp_schedule)

    def forward(self, input_ids):
        """Logits [B, S, V]; dropout only in training mode."""
        return self._run(gpt_forward, input_ids)


class GPTForCausalLM(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, generator=None):
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
