"""GPT-2 paged-serving forward passes (prefill, single-token decode,
speculative verification, prefix-cache tail prefill), the port of
`paddle_tpu/inference/serving/model_runner.py`.

  * `prefill_step` — ONE causal forward over the (block-padded) prompt
    that also writes every position's K/V into the paged pools through
    the request's block table, and samples the first generated token
    from the last REAL prompt row.
  * `decode_logits` — one token per running sequence: embed, run the
    layer stack writing and reading K/V through the pools (ragged
    paged attention over each request's cached context), return the
    [B, V] logits. `decode_step` is `decode_logits` followed by
    `sample_tokens`.
  * `verify_logits` — speculative-decode verification: T tokens per
    sequence (the pending token and T-1 draft proposals) in ONE
    dispatch, through the multi-query paged-attention kernel;
    `verify_step` samples every slot. `draft_params` is the draft
    model: the target's first layers, sharing its embeddings and head.
  * `prefill_tail_step` — prefix caching: a causal forward over only
    the uncached tail of a prompt, attending over the whole paged
    context (the cached prefix through shared blocks). Its attention
    is the plain multi-query version, `paged_attention_multi_reference`,
    on every device: a tail of up to max_seq_len rows is too long for
    the unrolled kernel, and the JAX package computes it outside any
    kernel too (model_runner.py:346-351). This is the one pass that
    runs no paged-attention kernel on the card.

All of them reuse the model's own helpers (`_layer_norm`,
`_residual_layer_norm`, `_attention` from `text.models.gpt`), so the
serving path computes what the full forward computes: greedy tokens
through the engine equal those of a sequential full re-forward loop.

`use_kernel=True` sends LayerNorm and decode and verify attention
through the kernel wrappers — the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors. `use_kernel=False` calls the plain
versions explicitly, on any device: the comparison path.

Positions past the model's last `wpe` row and table columns past the
table's width are clamped to the last row and column. A speculative
dispatch of a sequence near max_seq_len places slots there; the engine
passes tables with one NULL column more, so those slots write their
K/V into the NULL block, and their tokens are never emitted (the JAX
package reads such `wpe` rows through a filling gather instead).

The pools are updated IN PLACE, one layer slice at a time
(`pool[layer][blk, off] = ...`, an `index_put_`): PyTorch has no
buffer donation, and the engine keeps the same pool tensors for its
whole life. Token ids, positions, tables and lengths arrive as int32
(the JAX package's types); PyTorch indexing takes them as int64, the
paged-attention kernel as the int32 tensors given.

Sampling is per request: `temperature == 0` is exact argmax (first
index on ties), `temperature > 0` draws from the (optionally
top-k-filtered) softmax with a per-row `torch.Generator` seeded from
(request seed, absolute position) by the host — so an evicted and
re-prefilled request replays the draws it would have made
uninterrupted, whatever batch it lands in. The draws are not JAX's:
its PRNG is not reproduced.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...incubate.nn.kernels import paged_attention as _pa
from ...text.models.gpt import (_attention, _layer_norm,
                                _residual_layer_norm, layer_params)

__all__ = ["extract_params", "prefill_step", "decode_logits",
           "decode_step", "verify_logits", "verify_step",
           "prefill_tail_step", "draft_params", "sample_tokens",
           "seed_for"]


def extract_params(model):
    """(param tree of detached tensors, GPTConfig) from GPTForCausalLM
    or GPTModel."""
    gpt = getattr(model, "gpt", model)
    return gpt.params_tree(), gpt.config


def draft_params(params, n_layers):
    """Truncated-layer twin of the target for speculative drafting: the
    first `n_layers` transformer blocks, with the embeddings, final
    norm and head shared as they are (views, no copy). The draft only
    has to AGREE with the target often enough to pay for its
    dispatches: verification makes the emitted stream the target's own
    tokens whatever the draft proposes."""
    if n_layers < 1:
        raise ValueError(f"draft needs >= 1 layer, got {n_layers}")
    total = params["blocks"]["ln1_w"].shape[0]
    if n_layers > total:
        raise ValueError(
            f"draft layers {n_layers} > target layers {total}")
    out = dict(params)
    out["blocks"] = {k: v[:n_layers] for k, v in params["blocks"].items()}
    return out


def seed_for(request_seed, token_index):
    """Host-side per-token sampling seed: a pure function of the
    request's seed and the ABSOLUTE position being sampled."""
    return (int(request_seed) * 1000003 + int(token_index)) \
        & 0x7FFFFFFF


def sample_tokens(logits, temperature, top_k, seeds):
    """Per-request next-token selection over [B, V] logits; the
    per-row controls are host sequences. Returns int64 tokens [B] on
    the logits' device.

    temperature[b] == 0 -> argmax (greedy decode);
    temperature[b] > 0  -> categorical over logits/temperature with
    ranks >= top_k[b] masked out when top_k[b] > 0."""
    vocab = logits.shape[-1]
    tokens = torch.argmax(logits, dim=-1)
    temperature = np.asarray(temperature, np.float32)
    for row in np.flatnonzero(temperature > 0):
        lg = logits[row].float()
        ranks = torch.argsort(torch.argsort(-lg, stable=True), stable=True)
        k = int(top_k[row])
        lg = lg.masked_fill(ranks >= (k if k > 0 else vocab),
                            float("-inf"))
        probs = torch.softmax(lg / max(float(temperature[row]), 1e-6),
                              dim=-1)
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(int(seeds[row]))
        tokens[row] = torch.multinomial(probs, 1, generator=gen)[0]
    return tokens


def _wpe(params, positions):
    """Position embeddings, positions past the last row clamped to it
    (near-cap speculative slots, whose tokens are never emitted)."""
    wpe = params["wpe"]
    return wpe[positions.clamp(max=wpe.shape[0] - 1)]


def _table_blocks(block_tables, positions, block_size):
    """Pool block ids of [B, T] positions through [B, W] tables, the
    column clamped to the table's last (the speculative path's NULL
    column)."""
    col = (positions // block_size).clamp(max=block_tables.shape[1] - 1)
    return block_tables.long().gather(1, col)


def _ffn(h, bp):
    ffn = F.gelu(h @ bp["fc1_w"] + bp["fc1_b"], approximate="tanh")
    return ffn @ bp["fc2_w"] + bp["fc2_b"]


@torch.no_grad()
def prefill_step(params, ids, prompt_len, k_pool, v_pool, block_table,
                 temperature, top_k, seed, *, n_head, eps, block_size,
                 use_kernel=True):
    """Causal forward over one block-padded prompt.

    ids [1, P] (P a multiple of block_size); prompt_len a host int;
    block_table [MAXB]. Writes all P positions' K/V through the table
    — padded tail positions land in slots the decode steps overwrite
    before any masked read could see them. Returns the first sampled
    token as a 0-d int64 tensor."""
    p_len = ids.shape[1]
    hidden = params["wte"].shape[1]
    d = hidden // n_head
    x = params["wte"][ids.long()] + params["wpe"][:p_len]
    positions = torch.arange(p_len, device=x.device)
    blk = block_table.long()[positions // block_size]
    off = positions % block_size
    blocks = params["blocks"]
    for layer in range(k_pool.shape[0]):
        bp = layer_params(blocks, layer)
        h = _layer_norm(x, bp["ln1_w"], bp["ln1_b"], eps, use_kernel)
        qkv = h @ bp["qkv_w"] + bp["qkv_b"]
        q, k, v = qkv.split(hidden, dim=-1)
        # dense causal attention over the prompt itself: the prompt IS
        # the whole context, so no pool read is needed
        attn = _attention(q, k, v, n_head)
        # this layer's K/V for every padded position, written in place
        k_pool[layer][blk, off] = k[0].reshape(p_len, n_head, d).to(
            k_pool.dtype)
        v_pool[layer][blk, off] = v[0].reshape(p_len, n_head, d).to(
            v_pool.dtype)
        attn = attn @ bp["proj_w"] + bp["proj_b"]
        h2, x2 = _residual_layer_norm(attn, x, bp["ln2_w"], bp["ln2_b"],
                                      eps, use_kernel)
        x = x2 + _ffn(h2, bp)
    x = _layer_norm(x, params["lnf_w"], params["lnf_b"], eps, use_kernel)
    logits = x[0, prompt_len - 1] @ params["wte"].T      # [V]
    return sample_tokens(logits[None], [temperature], [top_k], [seed])[0]


def _paged_forward(params, ids, pos, blk, off, k_pool, v_pool, attend, *,
                   n_head, eps, use_kernel):
    """The layer stack over ids [B, T] at positions pos [B, T], reading
    K/V out of the paged pools: each layer writes its K/V at pool
    (blk, off) [B, T] in place BEFORE `attend(q, k_layer, v_layer)`
    reads through the tables (q [B, T, H, D] in the pool dtype). Returns
    the final-normed rows [B, T, hidden]."""
    bsz, t_q = ids.shape
    hidden = params["wte"].shape[1]
    d = hidden // n_head
    x = params["wte"][ids.long()] + _wpe(params, pos)
    for layer in range(k_pool.shape[0]):
        bp = layer_params(params["blocks"], layer)
        kc, vc = k_pool[layer], v_pool[layer]
        h = _layer_norm(x, bp["ln1_w"], bp["ln1_b"], eps, use_kernel)
        qkv = h @ bp["qkv_w"] + bp["qkv_b"]
        q, k, v = qkv.split(hidden, dim=-1)
        kc[blk, off] = k.reshape(bsz, t_q, n_head, d).to(kc.dtype)
        vc[blk, off] = v.reshape(bsz, t_q, n_head, d).to(vc.dtype)
        q = q.reshape(bsz, t_q, n_head, d).to(kc.dtype).contiguous()
        attn = attend(q, kc, vc).to(x.dtype)
        attn = attn.reshape(bsz, t_q, hidden) @ bp["proj_w"] + bp["proj_b"]
        h2, x2 = _residual_layer_norm(attn, x, bp["ln2_w"], bp["ln2_b"],
                                      eps, use_kernel)
        x = x2 + _ffn(h2, bp)
    return _layer_norm(x, params["lnf_w"], params["lnf_b"], eps, use_kernel)


@torch.no_grad()
def decode_logits(params, ids, positions, k_pool, v_pool, block_tables,
                  context_lens, *, n_head, eps, block_size,
                  use_kernel=True):
    """Logits [B, V] of one generation step for the whole batch.

    ids/positions [B]; context_lens[b] == positions[b] + 1 (this token
    included); block_tables [B, MAXB] and context_lens int32. Each
    layer writes this token's K/V at (tables[b, pos // BS], pos % BS)
    BEFORE attending — so the current token sees itself, and garbage a
    block-padded prefill left in that slot is overwritten before any
    read. Inactive slots (NULL-block tables, context_lens 1) all write
    to (NULL_BLOCK, 0): which of those writes wins is undefined and
    never matters, because no live context reads the NULL block."""
    pos = positions.long()[:, None]                       # [B, 1]
    scale = 1.0 / math.sqrt(params["wte"].shape[1] // n_head)
    fn = _pa.paged_attention if use_kernel \
        else _pa.paged_attention_reference

    def attend(q, kc, vc):
        return fn(q[:, 0], kc, vc, block_tables, context_lens,
                  sm_scale=scale)[:, None]

    x = _paged_forward(params, ids[:, None], pos,
                       _table_blocks(block_tables, pos, block_size),
                       pos % block_size, k_pool, v_pool, attend,
                       n_head=n_head, eps=eps, use_kernel=use_kernel)
    return x[:, 0] @ params["wte"].T


def decode_step(params, ids, positions, k_pool, v_pool, block_tables,
                context_lens, temperature, top_k, seeds, *, n_head, eps,
                block_size, use_kernel=True):
    """`decode_logits` then `sample_tokens`: next tokens [B]."""
    logits = decode_logits(params, ids, positions, k_pool, v_pool,
                           block_tables, context_lens, n_head=n_head,
                           eps=eps, block_size=block_size,
                           use_kernel=use_kernel)
    return sample_tokens(logits, temperature, top_k, seeds)


@torch.no_grad()
def verify_logits(params, ids, start_positions, k_pool, v_pool,
                  block_tables, context_lens, *, n_head, eps, block_size,
                  use_kernel=True):
    """Logits [B, T, V] of a speculative-decode verification: T tokens
    per sequence in ONE dispatch.

    ids [B, T]: slot 0 is the sequence's pending token (sampled last
    round, K/V unwritten), slots 1..T-1 the draft proposals. Token
    (b, t) sits at absolute position `start_positions[b] + t` and
    `context_lens[b] == start_positions[b] + 1`. Each layer writes all T
    slots' K/V through the table BEFORE the multi-query paged attention
    (`paged_attention_multi`, T <= 8), so slot t sees slots 0..t and
    nothing deeper. Rejected slots' K/V land past the accepted context
    and a later dispatch overwrites them before any read. The table's
    width is read from `block_tables` ([B, W]; the engine passes one
    NULL column more than max_blocks_per_seq, into which positions past
    the real width clamp)."""
    pos = start_positions.long()[:, None] \
        + torch.arange(ids.shape[1], device=ids.device)[None, :]  # [B, T]
    scale = 1.0 / math.sqrt(params["wte"].shape[1] // n_head)
    fn = _pa.paged_attention_multi if use_kernel \
        else _pa.paged_attention_multi_reference

    def attend(q, kc, vc):
        return fn(q, kc, vc, block_tables, context_lens, sm_scale=scale)

    x = _paged_forward(params, ids, pos,
                       _table_blocks(block_tables, pos, block_size),
                       pos % block_size, k_pool, v_pool, attend,
                       n_head=n_head, eps=eps, use_kernel=use_kernel)
    return x @ params["wte"].T


def verify_step(params, ids, start_positions, k_pool, v_pool,
                block_tables, context_lens, temperature, top_k, seeds, *,
                n_head, eps, block_size, use_kernel=True):
    """`verify_logits` then `sample_tokens` on every slot: tokens
    [B, T], token (b, t) the target's choice for output index
    context_lens[b] + t, sampled with seeds[b, t] — the SAME
    position-keyed seed the k=1 engine uses, which makes acceptance
    token-identical at any temperature. temperature and top_k are
    per-sequence host sequences [B], seeds a host array [B, T]."""
    logits = verify_logits(params, ids, start_positions, k_pool, v_pool,
                           block_tables, context_lens, n_head=n_head,
                           eps=eps, block_size=block_size,
                           use_kernel=use_kernel)
    bsz, t_q, vocab = logits.shape
    flat = sample_tokens(logits.reshape(bsz * t_q, vocab),
                         np.repeat(np.asarray(temperature), t_q),
                         np.repeat(np.asarray(top_k), t_q),
                         np.asarray(seeds).reshape(bsz * t_q))
    return flat.reshape(bsz, t_q)


@torch.no_grad()
def prefill_tail_step(params, ids, start, total_len, k_pool, v_pool,
                      block_table, temperature, top_k, seed, *, n_head,
                      eps, block_size, use_kernel=True):
    """Prefix-cache tail prefill: causal forward over ONLY the uncached
    tail of one request's context.

    The leading `start` tokens (a multiple of block_size) already have
    their K/V in the pools through shared table blocks; ids [1, Tpad]
    holds the tail (block-padded), its token t at absolute position
    `start + t`. Each layer writes the tail's K/V through the table
    (private blocks only: admission caps sharing below the full
    context), then attends over the WHOLE paged context through the
    plain multi-query version (slot t sees start + t + 1 tokens) — on
    every device, as the JAX package does; `use_kernel` covers the
    LayerNorms. Samples the first token from the last REAL tail row
    (`total_len - 1 - start`). Returns it as a 0-d int64 tensor."""
    pos = start + torch.arange(ids.shape[1], device=ids.device)[None, :]
    scale = 1.0 / math.sqrt(params["wte"].shape[1] // n_head)
    tables = block_table[None]
    lens = torch.tensor([start + 1], dtype=torch.int32, device=ids.device)

    def attend(q, kc, vc):
        return _pa.paged_attention_multi_reference(q, kc, vc, tables, lens,
                                                   sm_scale=scale)

    x = _paged_forward(params, ids, pos,
                       _table_blocks(tables, pos, block_size),
                       pos % block_size, k_pool, v_pool, attend,
                       n_head=n_head, eps=eps, use_kernel=use_kernel)
    logits = x[0, total_len - 1 - start] @ params["wte"].T   # [V]
    return sample_tokens(logits[None], [temperature], [top_k], [seed])[0]
