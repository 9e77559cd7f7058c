"""Block-allocated paged KV cache (the vLLM / Ragged-Paged-Attention
memory model), the port of `paddle_tpu/inference/serving/kv_cache.py`.

The cache is a FIXED device pool of fixed-size blocks per layer:

    k/v pools:  [num_layers, num_blocks, block_size, n_head, head_dim]

and every request owns a host-side BLOCK TABLE — the ordered list of
pool block ids covering its tokens. Token `t` of a request lives at
`(table[t // block_size], t % block_size)`. Attention reads K/V through
the table (the paged-attention kernel on the card, the dense gather on
the CPU), so sequences of very different lengths share one pool with no
padding beyond the last partial block.

Block 0 is the reserved NULL block: padded prompt positions and
inactive batch slots write their garbage K/V there, and no read ever
sees it because every read is masked by the request's context length.

The pools are torch tensors the serving code updates IN PLACE
(`index_put_` on a layer's slice): there is no buffer donation to
manage. The allocator is host code, unchanged from the JAX package.
Pool sizing comes from the `pool_bytes` or `num_blocks` argument or, on
the card, from `torch.cuda.mem_get_info()`'s free memory.

Speculative decoding (`draft_layers` > 0) adds twin pools `k_draft` /
`v_draft` for the draft model's first `draft_layers` layers. They are
addressed through the SAME allocator and tables, so one refcount covers
a block's target and draft K/V; they stay outside the pool budget, as
in the JAX package.

Prefix caching (`prefix_cache=True`, copy-on-write sharing): FULL
immutable prompt blocks are published in the allocator's content-hash
index under a chain hash (`prefix_hashes`: each block's digest folds in
its predecessor's, so a hit at depth i proves the whole prefix matches).
`admit()` maps a new request's cached prefix blocks into its table by
raising their refcounts, with no data movement, and allocates only the
uncached remainder; the engine then prefills only the tail. Sharing is
capped below the full context, so every write lands in a private block
(`check_cow` enforces it). A block returns to the free list, and leaves
the index, only when its LAST reference goes.

PTA07x (block-leak) accounting, as in the JAX package (:46-49): with
`PADDLE_SANITIZE=serving` armed, double-free / free-of-unowned trips a
PTA071 finding at the faulting call, `audit_leaks(live_owners)`
reports PTA070 for blocks still owned by requests the serving layer no
longer tracks, and PTA074 flags copy-on-write violations (a shared
block written through, or a block physically reclaimed while another
table still maps it).
"""
from __future__ import annotations

import hashlib
import math
from collections import deque

import numpy as np
import torch

from ...core import monitor as _cmon
from ...device import resolve_device
from ...monitor import sanitize as _san

__all__ = ["BlockAllocator", "PagedKVCache", "NULL_BLOCK",
           "auto_num_blocks", "bytes_per_block", "prefix_hashes",
           "env_block_size", "env_pool_bytes", "env_max_batch",
           "env_spec_k", "env_spec_draft", "env_prefix_cache"]

NULL_BLOCK = 0  # reserved garbage-dump block, never owned

_DEF_BLOCK_SIZE = 16
_DEF_MAX_BATCH = 8
# CPU fallback pool budget — big enough for the tests' tiny models
_DEF_POOL_BYTES = 64 << 20


def env_block_size():
    """PADDLE_SERVE_BLOCK_SIZE — tokens per KV block (default 16)."""
    return max(1, _cmon._env_int("PADDLE_SERVE_BLOCK_SIZE",
                                 _DEF_BLOCK_SIZE))


def env_pool_bytes():
    """PADDLE_SERVE_POOL_BYTES — total KV pool budget in bytes
    (default 0 = auto-size from the card's free memory)."""
    return _cmon._env_int("PADDLE_SERVE_POOL_BYTES", 0)


def env_max_batch():
    """PADDLE_SERVE_MAX_BATCH — decode batch width (default 8)."""
    return max(1, _cmon._env_int("PADDLE_SERVE_MAX_BATCH",
                                 _DEF_MAX_BATCH))


def env_spec_k():
    """PADDLE_SERVE_SPEC_K — speculative tokens per round (default 1 =
    speculation off)."""
    return max(1, min(8, _cmon._env_int("PADDLE_SERVE_SPEC_K", 1)))


def env_spec_draft():
    """PADDLE_SERVE_SPEC_DRAFT — draft model layer count (default 0 =
    half the target's layers, at least 1)."""
    return max(0, _cmon._env_int("PADDLE_SERVE_SPEC_DRAFT", 0))


def env_prefix_cache():
    """PADDLE_SERVE_PREFIX_CACHE — 1 enables copy-on-write prefix
    block sharing (default 0 = off)."""
    return 1 if _cmon._env_int("PADDLE_SERVE_PREFIX_CACHE", 0) else 0


def prefix_hashes(tokens, block_size, n_blocks=None):
    """Chain hashes for the leading FULL blocks of a token sequence:
    digest(i) = sha256(digest(i-1) || tokens of block i as int64). The
    chain makes a depth-i hit prove the entire prefix matches and keeps
    repeated identical chunks within one prompt distinct. The digests
    are the JAX package's (kv_cache.py:121-137), byte for byte."""
    if n_blocks is None:
        n_blocks = len(tokens) // block_size
    out = []
    h = b"\x00" * 32
    for i in range(n_blocks):
        m = hashlib.sha256()
        m.update(h)
        m.update(np.asarray(tokens[i * block_size:(i + 1) * block_size],
                            np.int64).tobytes())
        h = m.digest()
        out.append(h)
    return out


def bytes_per_block(num_layers, block_size, n_head, head_dim, dtype):
    """Device bytes of ONE block id across all layers, K and V."""
    return 2 * num_layers * block_size * n_head * head_dim \
        * dtype.itemsize


def auto_num_blocks(per_block, pool_bytes=None, fraction=0.45,
                    *, device=None):
    """Pool size in blocks: the explicit budget when given (argument or
    `PADDLE_SERVE_POOL_BYTES`), else `fraction` of the card's free
    memory (`torch.cuda.mem_get_info`, read after the weights are
    resident), else the CPU fallback budget."""
    budget = pool_bytes if pool_bytes else env_pool_bytes()
    if not budget and device is not None and device.type == "cuda":
        from ...monitor import memory as _memory

        budget = int(_memory.memory_stats(device)["bytes_free"]
                     * fraction)
    if not budget:
        budget = _DEF_POOL_BYTES
    # +1: block 0 is the null block, not usable capacity
    return max(2, budget // max(1, per_block) + 1)


class BlockAllocator:
    """Host-side free-list over the pool's block ids.

    Block 0 (NULL_BLOCK) is never handed out. Ownership is tracked per
    request id so leaks are attributable: `release(owner)` drops every
    reference an owner holds, `audit_leaks(live)` reports blocks owned
    by ids the caller no longer tracks.

    Refcounts: a freshly allocated block has refcount 1; `share()` maps
    it into another owner's table copy-on-write (refcount up, no data
    movement). A block returns to the free list — and leaves the
    content-hash index — only when its LAST reference goes."""

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 null + 1 usable), got "
                f"{num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free = deque(range(1, self.num_blocks))
        self._owned = {}  # owner id -> [block ids]
        self._refcnt = {}  # block id -> live references
        self._by_hash = {}  # chain digest -> block id
        self._hash_of = {}  # block id -> chain digest
        self._sync_gauges()

    # -- occupancy ---------------------------------------------------
    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.num_blocks - 1 - len(self._free)

    def owners(self):
        return sorted(self._owned)

    def owned(self, owner):
        return list(self._owned.get(owner, ()))

    def can_alloc(self, n):
        return len(self._free) >= n

    def refcount(self, block_id):
        return self._refcnt.get(block_id, 0)

    def _sync_gauges(self):
        _cmon.stat_set("serve/kv_blocks/used", self.used_blocks)
        _cmon.stat_set("serve/kv_blocks/free", self.free_blocks)

    # -- alloc/free --------------------------------------------------
    def alloc(self, owner, n=1):
        """Give `owner` `n` more blocks; returns the new block ids, or
        None when the pool can't satisfy the request (the caller's cue
        to evict — never a partial grant)."""
        if n <= 0:
            return []
        if len(self._free) < n:
            return None
        got = [self._free.popleft() for _ in range(n)]
        for b in got:
            self._refcnt[b] = 1
        self._owned.setdefault(owner, []).extend(got)
        self._sync_gauges()
        return got

    def share(self, owner, block_id):
        """Map a LIVE block into `owner`'s table copy-on-write."""
        if block_id == NULL_BLOCK or block_id not in self._refcnt:
            raise ValueError(
                f"cannot share unallocated block {block_id}")
        self._refcnt[block_id] += 1
        self._owned.setdefault(owner, []).append(block_id)
        self._sync_gauges()
        return block_id

    def _deref(self, block_id):
        """Drop one reference; reclaim on the last one. Returns 1 when
        the block actually hit the free list."""
        rc = self._refcnt.get(block_id, 1) - 1
        if rc > 0:
            self._refcnt[block_id] = rc
            return 0
        self._refcnt.pop(block_id, None)
        digest = self._hash_of.pop(block_id, None)
        if digest is not None and self._by_hash.get(digest) == block_id:
            del self._by_hash[digest]
        if _san._serving:
            # defensive PTA074 half: reclaiming a block some OTHER
            # table still maps means a refcount was lost somewhere
            holders = [o for o, bl in self._owned.items()
                       if block_id in bl]
            if holders:
                _san._emit(
                    "PTA074",
                    f"block {block_id} physically reclaimed while "
                    f"still mapped by {holders!r} (refcount lost)",
                    dedup=("PTA074", "reclaim", block_id))
        self._free.append(block_id)
        return 1

    def check_cow(self, block_id):
        """Copy-on-write guard: a block mapped by more than one request
        is immutable. PTA074 when the serving sanitizer is armed,
        ValueError always."""
        rc = self._refcnt.get(block_id, 1)
        if rc > 1:
            if _san._serving:
                _san._emit(
                    "PTA074",
                    f"write to shared block {block_id} (refcount "
                    f"{rc}) without copy-on-write",
                    dedup=("PTA074", "cow", block_id))
            raise ValueError(
                f"block {block_id} is shared by {rc} requests and "
                f"immutable (copy-on-write required)")
        return block_id

    # -- content-hash index ------------------------------------------
    def register_hash(self, block_id, digest):
        """Publish one full immutable block under its chain digest;
        an already-published digest or block keeps its mapping.
        Returns 1 on a new registration, 0 on skip."""
        if digest in self._by_hash or block_id in self._hash_of:
            return 0
        if block_id == NULL_BLOCK or block_id not in self._refcnt:
            raise ValueError(
                f"cannot index unallocated block {block_id}")
        self._by_hash[digest] = block_id
        self._hash_of[block_id] = digest
        return 1

    def lookup_hash(self, digest):
        return self._by_hash.get(digest)

    def clear_hash_index(self):
        self._by_hash.clear()
        self._hash_of.clear()

    def release(self, owner):
        """Drop every reference `owner` holds; returns how many were
        dropped. Unknown owners are a no-op."""
        blocks = self._owned.pop(owner, None)
        if not blocks:
            return 0
        for b in blocks:
            self._deref(b)
        self._sync_gauges()
        return len(blocks)

    def free_one(self, owner, block_id):
        """Return one specific block. Freeing a block the owner doesn't
        hold (double-free or foreign free) is PTA071 when the serving
        sanitizer is armed, ValueError always."""
        blocks = self._owned.get(owner)
        if not blocks or block_id not in blocks:
            if _san._serving:
                _san._emit(
                    "PTA071",
                    f"free of block {block_id} not owned by "
                    f"{owner!r} (double-free or foreign free)",
                    dedup=("PTA071", owner, block_id))
            raise ValueError(
                f"block {block_id} is not owned by {owner!r}")
        blocks.remove(block_id)
        if not blocks:
            self._owned.pop(owner, None)
        self._deref(block_id)
        self._sync_gauges()
        return block_id

    def audit_leaks(self, live_owners=()):
        """{owner: [blocks]} of blocks owned by request ids the serving
        layer no longer tracks ({} when clean); with the `serving`
        sanitize family armed each leak also emits a PTA070 finding."""
        live = set(live_owners)
        leaked = {o: list(b) for o, b in self._owned.items()
                  if o not in live and b}
        if leaked and _san._serving:
            for owner, blocks in sorted(leaked.items(),
                                        key=lambda kv: str(kv[0])):
                _san._emit(
                    "PTA070",
                    f"KV block leak: {len(blocks)} block(s) still "
                    f"owned by finished/unknown request {owner!r}",
                    dedup=("PTA070", owner))
        return leaked


class PagedKVCache:
    """The device pools + the allocator + per-request block tables."""

    def __init__(self, num_layers, num_heads, head_dim,
                 block_size=None, num_blocks=None, pool_bytes=None,
                 dtype=None, draft_layers=0, prefix_cache=False, *,
                 device=None):
        self.device = resolve_device(device)
        self.block_size = int(block_size or env_block_size())
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype or torch.float32
        self.draft_layers = int(draft_layers)
        self.prefix_cache = bool(prefix_cache)
        per_block = bytes_per_block(num_layers, self.block_size,
                                    num_heads, head_dim, self.dtype)
        if num_blocks is None:
            num_blocks = auto_num_blocks(per_block, pool_bytes=pool_bytes,
                                         device=self.device)
        self.num_blocks = int(num_blocks)
        self._zero_pools()
        self.allocator = BlockAllocator(self.num_blocks)

    def _zero_pools(self):
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        # the draft's twin pools: same blocks, same tables
        self.k_draft = self.v_draft = None
        if self.draft_layers:
            dshape = (self.draft_layers,) + shape[1:]
            self.k_draft = torch.zeros(dshape, dtype=self.dtype,
                                       device=self.device)
            self.v_draft = torch.zeros(dshape, dtype=self.dtype,
                                       device=self.device)

    # -- geometry ----------------------------------------------------
    def blocks_for_tokens(self, n_tokens):
        return max(1, math.ceil(n_tokens / self.block_size))

    def can_admit(self, n_tokens, lookahead_blocks=1, cached_blocks=0):
        """Admission control: room for the prompt's blocks (less any
        already cached) plus a decode lookahead, so a request admitted
        now can generate at least one block of tokens before pool
        pressure. Speculative decoding passes a k-aware lookahead."""
        need = max(0, self.blocks_for_tokens(n_tokens) - cached_blocks) \
            + lookahead_blocks
        return self.allocator.can_alloc(need)

    # -- prefix cache ------------------------------------------------
    def probe_prefix(self, tokens):
        """(cached_blocks, block_ids): the longest chain of leading FULL
        blocks already published, capped BELOW the full context so the
        tail prefill always has >= 1 real token to run (and a row to
        sample from)."""
        if not self.prefix_cache or not len(tokens):
            return 0, []
        cap = max(0, (len(tokens) - 1) // self.block_size)
        ids = []
        for digest in prefix_hashes(tokens, self.block_size, cap):
            b = self.allocator.lookup_hash(digest)
            if b is None:
                break
            ids.append(b)
        return len(ids), ids

    def admit(self, owner, tokens):
        """Give `owner` the blocks for its context at once: cached
        prefix blocks map copy-on-write (leading the table, at their
        token positions), only the remainder comes off the free list.
        Returns the cached TOKEN count (0 when the cache is off or
        cold), or None when the pool cannot cover the remainder, with
        nothing granted."""
        total = self.blocks_for_tokens(len(tokens))
        n_shared, shared = self.probe_prefix(tokens)
        fresh = total - n_shared
        if not self.allocator.can_alloc(fresh):
            return None
        for b in shared:
            self.allocator.share(owner, b)
        if fresh:
            self.allocator.alloc(owner, fresh)
        if n_shared:
            _cmon.stat_add("serve/prefix/hits", 1)
            _cmon.stat_add("serve/prefix/blocks_shared", n_shared)
        return n_shared * self.block_size

    def register_prefix(self, owner, tokens):
        """Publish `owner`'s full prompt blocks (written, immutable from
        here on) in the content index, so later admissions can share
        them. Blocks already published, and digests already claimed,
        keep their mapping. Returns how many blocks were newly
        published."""
        if not self.prefix_cache:
            return 0
        blocks = self.allocator.owned(owner)
        full = min(len(tokens) // self.block_size, len(blocks))
        n = 0
        for i, digest in enumerate(
                prefix_hashes(tokens, self.block_size, full)):
            n += self.allocator.register_hash(blocks[i], digest)
        return n

    def block_table(self, owner, max_blocks):
        """Padded int32 table row for one request: its owned blocks in
        token order, NULL_BLOCK beyond."""
        blocks = self.allocator.owned(owner)
        if len(blocks) > max_blocks:
            raise ValueError(
                f"request {owner!r} holds {len(blocks)} blocks > "
                f"max_blocks_per_seq={max_blocks}")
        row = np.full((max_blocks,), NULL_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        return row

    def reset_pools(self):
        """Fresh zero pools. The caller re-prefills every sequence: the
        allocator's state survives but the K/V contents are gone, and so
        is every published prefix (sharing a pre-reset digest would
        share zeros)."""
        self._zero_pools()
        self.allocator.clear_hash_index()

    # -- defrag ------------------------------------------------------
    def defrag(self):
        """Compact allocated blocks to the front of the pool, owners in
        sorted order and a shared block moved once, with one
        `index_select` a pool. Rewrites the owner tables, refcounts and
        hash index as the JAX package's `defrag` does (kv_cache.py:514)
        and returns the number of blocks that moved."""
        alloc = self.allocator
        owners = alloc.owners()
        mapping = {NULL_BLOCK: NULL_BLOCK}
        nxt = 1
        for owner in owners:
            for b in alloc._owned[owner]:
                if b not in mapping:
                    mapping[b] = nxt
                    nxt += 1
        moved = sum(1 for old, new in mapping.items() if old != new)
        if not moved:
            return 0
        # perm[new] = old; the tail keeps the identity (its blocks are
        # free and never read unmasked)
        perm = np.arange(self.num_blocks)
        for old, new in mapping.items():
            perm[new] = old
        idx = torch.from_numpy(perm).to(self.device)
        self.k = self.k.index_select(1, idx)
        self.v = self.v.index_select(1, idx)
        if self.k_draft is not None:
            self.k_draft = self.k_draft.index_select(1, idx)
            self.v_draft = self.v_draft.index_select(1, idx)
        for owner in owners:
            alloc._owned[owner] = [mapping[b] for b in alloc._owned[owner]]
        alloc._refcnt = {mapping[b]: c for b, c in alloc._refcnt.items()}
        alloc._by_hash = {h: mapping[b] for h, b in alloc._by_hash.items()}
        alloc._hash_of = {mapping[b]: h for b, h in alloc._hash_of.items()}
        alloc._free = deque(range(nxt, self.num_blocks))
        alloc._sync_gauges()
        return moved
