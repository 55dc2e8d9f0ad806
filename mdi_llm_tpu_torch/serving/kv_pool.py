"""Host-side block allocator for the pooled KV cache.

The device side is a `(L, num_blocks, block_size, G, hs)` array pair
(`transformer.init_paged_kv_cache`); this module owns the METADATA: which
blocks are free, which sequence references which blocks, and — the piece
that makes shared system prompts cheap — a hash-chain prefix cache in the
style of vLLM's automatic prefix caching:

- every FULL block of a prompt is identified by
  `hash(parent_hash, tokens_in_block)`, so equal prompt prefixes map to
  equal hash chains regardless of which request produced them;
- on allocation, cached blocks matching the prompt's chain are reused by
  refcount (copy-free: no KV bytes move);
- on release, refcounts drop; hash-registered blocks whose count hits zero
  stay warm in an LRU "evictable" set and only return to circulation when
  the free list runs dry (copy-free release — nothing is zeroed or moved).

Block 0 is reserved as the write-only TRASH block: padded lanes and
bucket-padding positions scatter their garbage K/V there
(`ops.paged_attention.paged_update`), so it is never handed out.

Dtype blindness (the quantized-pool contract): this allocator also never
learns what the blocks store.  `ServingConfig(kv_dtype="int8")` swaps the
device arrays for int8 payload + per-block-per-group scale arrays riding
the same `(L, num_blocks, ...)` layout (`ops/paged_attention.py`), but a
block id still means "block_size token slots" — free lists, refcounts and
the hash-chain prefix cache are untouched, so a prefix hit reuses an int8
block (payload AND scale) exactly as copy-free as an fp one.

Device-count blindness (the tensor-parallel serving contract): this
allocator never learns how many chips back the pool.  Under a tp mesh the
device arrays shard their KV-GROUP axis (`parallel.sharding.paged_kv_spec`
— each device holds its head-slice of EVERY block), so block ids, free
lists, refcounts and the hash chains are identical on 1 chip or N; only
the bytes behind a block id shrink per device (by exactly 1/tp —
`ServingConfig.pool_bytes_per_device`).  Sharding the BLOCK axis instead
would have forced per-device free lists and device-aware tables; sharding
heads keeps this file untouched by distribution.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["KVPool"]


class KVPool:
    """Free-list block allocator with refcounts and hash-based prefix reuse."""

    def __init__(self, num_blocks: int, block_size: int, prefix_caching: bool = True):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash block)")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_caching = prefix_caching
        # LIFO free list keeps recently-released blocks hot in HBM caches
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        # prefix cache state
        self._hash_to_block: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}  # registered full blocks only
        self._evictable: "OrderedDict[int, None]" = OrderedDict()  # ref==0, cached
        self.prefix_hits = 0  # blocks reused copy-free
        self.prefix_queries = 0  # full blocks looked up
        # host-RAM tier seam (serving/host_tier.py): the allocator stays
        # device- AND tier-blind — the engine installs these when
        # ServingConfig.host_pool_mib > 0, and every tier decision rides
        # the two existing choke points (`_take` eviction, `match_prefix`
        # miss).  None (the default) is today's behavior, bit-for-bit.
        self.host = None  # Optional[host_tier.HostTier], for snapshot()
        # (block, chain_hash) -> None, called as a cached block is evicted:
        # the engine copies the block's bytes to a host slot (spill)
        self.spill_hook: Optional[Callable[[int, int], None]] = None
        # chain_hash -> fresh HBM block (refcount 1) with the spilled
        # payload's restore scheduled, or None when the hash isn't spilled
        # / no capacity.  Hits through this path count as prefix_hits_host.
        self.restore_hook: Optional[Callable[[int], Optional[int]]] = None
        self.prefix_hits_host = 0  # blocks restored from the host tier

    # -- capacity ------------------------------------------------------------

    @property
    def available(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._evictable)

    @property
    def used(self) -> int:
        """Blocks referenced by live sequences."""
        return sum(1 for c in self._ref.values() if c > 0)

    @property
    def utilization(self) -> float:
        """Fraction of allocatable blocks held by live sequences."""
        return self.used / max(1, self.num_blocks - 1)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time allocator gauges for the observability layer
        (`obs/`): pure host-side counters the pool already maintains —
        reading them costs nothing and touches no device state."""
        snap = {
            "num_blocks": self.num_blocks,
            "used_blocks": self.used,
            "available_blocks": self.available,
            "evictable_blocks": len(self._evictable),
            "utilization": self.utilization,
            "prefix_hits": self.prefix_hits,
            "prefix_queries": self.prefix_queries,
        }
        if self.host is not None:
            snap["prefix_hits_host"] = self.prefix_hits_host
            snap.update(self.host.snapshot())
        return snap

    # -- allocation ----------------------------------------------------------

    def _take(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._evictable:  # evict the least-recently-released cached block
            blk, _ = self._evictable.popitem(last=False)
            h = self._block_hash.pop(blk)
            del self._hash_to_block[h]
            if self.spill_hook is not None:
                # host tier: copy the cold chain block down instead of
                # dropping it (the gather snapshots the block's bytes
                # before the new owner's first write can land)
                self.spill_hook(blk, h)
            return blk
        return None

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take `n` fresh blocks (refcount 1 each); None if short — the
        caller must not have mutated state (all-or-nothing)."""
        if n > self.available:
            return None
        out = []
        for _ in range(n):
            blk = self._take()
            assert blk is not None
            self._ref[blk] = 1
            out.append(blk)
        return out

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block.  Copy-free: registered blocks whose
        refcount reaches zero stay warm for prefix reuse; unregistered ones
        go straight back to the free list."""
        for blk in blocks:
            c = self._ref.get(blk, 0) - 1
            if c > 0:
                self._ref[blk] = c
                continue
            self._ref.pop(blk, None)
            if blk in self._block_hash:
                self._evictable[blk] = None
                self._evictable.move_to_end(blk)
            else:
                self._free.append(blk)

    # -- prefix caching ------------------------------------------------------

    @staticmethod
    def chain_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
        """One hash per FULL block, each chained on its parent so a block's
        identity covers the whole prefix up to and including it."""
        hashes: List[int] = []
        parent = 0
        for i in range(len(tokens) // block_size):
            parent = hash((parent, tuple(tokens[i * block_size : (i + 1) * block_size])))
            hashes.append(parent)
        return hashes

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block-chain prefix of `tokens`, with a reference
        taken on every matched block.  Returns (blocks, n_cached_tokens).

        At most `(len(tokens) - 1) // block_size` blocks are matched: the
        prompt's last token is always recomputed, and keeping the cached
        span block-aligned means the requester's first write lands in a
        block it owns exclusively (no copy-on-write machinery needed).
        """
        if not self.prefix_caching:
            return [], 0
        max_blocks = max(0, (len(tokens) - 1)) // self.block_size
        matched: List[int] = []
        for h in self.chain_hashes(tokens, self.block_size)[:max_blocks]:
            self.prefix_queries += 1
            blk = self._hash_to_block.get(h)
            if blk is None:
                # host tier: a chain that fell out of HBM may live on in
                # the spilled store — the hook hands back a fresh block
                # (refcount already 1) with the payload restore scheduled
                if self.restore_hook is not None:
                    blk = self.restore_hook(h)
                if blk is None:
                    break
                self.prefix_hits_host += 1
                self._hash_to_block[h] = blk
                self._block_hash[blk] = h
                matched.append(blk)
                continue
            self.prefix_hits += 1
            self._ref[blk] = self._ref.get(blk, 0) + 1
            self._evictable.pop(blk, None)
            matched.append(blk)
        return matched, len(matched) * self.block_size

    def register_prefix(self, blocks: Sequence[int], tokens: Sequence[int]) -> None:
        """Record the hash chain for the full blocks of `tokens`, making
        them reusable by future requests.  Blocks already registered under
        the same hash keep the existing mapping (first writer wins)."""
        if not self.prefix_caching:
            return
        for blk, h in zip(blocks, self.chain_hashes(tokens, self.block_size)):
            if h in self._hash_to_block:
                continue
            if blk in self._block_hash:  # block already identifies another chain
                continue
            self._hash_to_block[h] = blk
            self._block_hash[blk] = h
