"""Host-RAM KV tier: a block store in host memory behind the paged pool.

Port of `mdi_llm_tpu/serving/host_tier.py`.  The serving scale ceiling is
the KV bytes resident on the card: pool exhaustion triggers recompute
preemption (`scheduler.preempt_latest`: generated work thrown away and
re-prefilled) and the hash-chain prefix cache drops cold chains at
capacity (`kv_pool.KVPool._take`).  This module holds the tier both paths
fall back to instead:

- **Swap on preemption**: a victim's blocks are gathered on the device and
  copied to host slots (`engine._issue_fetch`), the pool blocks return to
  the free list at once, and on resume the payload is restored in place
  into fresh blocks (`engine._swap_in`): the sequence re-enters
  mid-generation with no re-prefill.
- **Prefix spill**: chains evicted from the prefix cache land in host
  slots keyed by the same chain hash; a later `match_prefix` hit on a
  spilled block restores it and counts as `prefix_hits_host`.

Everything here is host-side bookkeeping over CPU tensors (the slabs); the
device work (gather, copies, in-place scatter) stays in
`serving/engine.py`, as `KVPool`'s tables are likewise device-blind.  On a
CUDA device the slabs are pinned, so the copies to and from them run
asynchronously on the stream.  Every slab holds its leaf's raw bytes as
an integer tensor of the same element width: bfloat16 and float8 pools
round-trip byte for byte, and no float8 operation is ever asked of the
host.

Content state walks `device -> in-flight -> host -> device`: "in-flight"
is a gather snapshot whose copy into its host slots has been queued but
has not completed yet (the pool blocks are already free: the snapshot owns
the bytes); the engine waits for it at the next host-sync boundary.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "HOST_LINK_GBPS",
    "DEFAULT_HOST_LINK_GBPS",
    "lookup_host_link_gbps",
    "raw_dtype",
    "SwapCostModel",
    "HostBlockStore",
    "HostTier",
    "SwapRecord",
]

# Host<->device link bandwidth priors in GB/s, keyed by the CUDA device
# name (longest prefix wins); the CPU and unknown kinds get the
# conservative default.  Priors only: the cost model EWMA-corrects toward
# the transfer rates it measures as swaps happen.  The H100 row is the
# slower direction (host to device; device to host 44.281) of pinned
# copies of one swap chunk, 8 tiny-llama-1.1b bf16 pool blocks (2.88 MB),
# timed by CUDA events in `chip_smoke.py tier` on an NVIDIA H100 80GB
# HBM3 at 700.00 W.
HOST_LINK_GBPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 41.292,
}
DEFAULT_HOST_LINK_GBPS = 8.0

# integer dtype of each element width: a slab holds its leaf's raw bytes
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def raw_dtype(dtype: torch.dtype) -> torch.dtype:
    """The integer dtype of `dtype`'s element width (`Tensor.view` target)."""
    return _RAW[dtype.itemsize]


def lookup_host_link_gbps(device_kind: Optional[str]) -> float:
    """Longest-prefix match of `device_kind` against the table; unknown
    kinds (the CPU, other cards) get the conservative default."""
    if device_kind:
        best = ""
        for kind in HOST_LINK_GBPS:
            if device_kind.startswith(kind) and len(kind) > len(best):
                best = kind
        if best:
            return HOST_LINK_GBPS[best]
    return DEFAULT_HOST_LINK_GBPS


@dataclasses.dataclass
class SwapCostModel:
    """Swap-vs-recompute decision for one preemption victim.

    Swapping a victim costs a round trip of its block bytes over the host
    link; recomputing costs re-prefilling every token it had fed.  Both
    sides start from priors (`link_gbps` from the device table,
    `prefill_tokens_per_s` from a deliberately pessimistic default) and
    EWMA-correct toward measured rates, so the decision tracks the actual
    machine rather than the table.  `clock` is injectable for
    deterministic unit tests."""

    link_gbps: float
    prefill_tokens_per_s: float = 2000.0
    ewma: float = 0.25
    clock: Callable[[], float] = time.perf_counter

    def swap_seconds(self, nbytes: int) -> float:
        """One-way transfer time for `nbytes` at the estimated link BW."""
        if self.link_gbps <= 0:
            return float("inf")
        return nbytes / (self.link_gbps * 1e9)

    def recompute_seconds(self, refill_tokens: int) -> float:
        return refill_tokens / max(self.prefill_tokens_per_s, 1e-9)

    def should_swap(self, nbytes: int, refill_tokens: int) -> bool:
        """True when the swap round trip (out + back in) beats
        re-prefilling `refill_tokens`.  A zero or negative link can never
        win."""
        if self.link_gbps <= 0:
            return False
        return 2.0 * self.swap_seconds(nbytes) < self.recompute_seconds(
            refill_tokens
        )

    def observe_transfer(self, nbytes: int, seconds: float) -> None:
        """Fold one measured host<->device transfer into the BW estimate."""
        if seconds <= 0 or nbytes <= 0:
            return
        measured = nbytes / (seconds * 1e9)
        self.link_gbps += self.ewma * (measured - self.link_gbps)

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        """Fold one measured prefill burst into the recompute estimate."""
        if seconds <= 0 or tokens <= 0:
            return
        measured = tokens / seconds
        self.prefill_tokens_per_s += self.ewma * (
            measured - self.prefill_tokens_per_s
        )


class HostBlockStore:
    """Fixed-capacity host block store: one slab per pool leaf.

    The slab layout is derived from the live pool's leaf shapes with the
    block axis hoisted to the front: slot i of leaf j is
    ``slabs[j][i]``, one block's worth of that leaf.  Total `nbytes` is
    exactly ``num_slots x ServingConfig.block_bytes(tp=1)`` for the flat
    pool layout.  `pin_memory` (a CUDA device's engine) pins the slabs, so
    copies to and from them can be asynchronous.

    Allocation mirrors `KVPool`: LIFO free list, all-or-nothing `alloc`."""

    def __init__(
        self,
        leaf_shapes: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
        block_axis: int,
        num_slots: int,
        pin_memory: bool = False,
    ):
        self.block_axis = int(block_axis)
        self.num_slots = int(num_slots)
        self.pin_memory = bool(pin_memory)
        self.dtypes: List[torch.dtype] = []
        self.slabs: List[torch.Tensor] = []
        for shape, dtype in leaf_shapes:
            ba = self.block_axis
            per_block = tuple(shape[:ba]) + tuple(shape[ba + 1:])
            self.dtypes.append(dtype)
            self.slabs.append(torch.zeros(
                (self.num_slots,) + per_block, dtype=raw_dtype(dtype),
                pin_memory=self.pin_memory,
            ))
        self._free: List[int] = list(range(self.num_slots))

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.slabs)

    @property
    def used(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing: n slots or None (no partial grabs to unwind)."""
        if n < 0 or n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, slots: Sequence[int]) -> None:
        for s in slots:
            self._free.append(int(s))

    def write(self, slots: Sequence[int], arrays: Sequence[torch.Tensor],
              non_blocking: bool = False) -> None:
        """Store per-leaf payloads (block axis leading: row k is block k,
        of the leaf's dtype or its raw integer view, on the host or the
        device) into `slots`, one row copy each; payload rows past
        len(slots) are transfer padding and are dropped.  `non_blocking`
        queues device-to-pinned copies on the current stream: the slots
        may then be read only once an event recorded after them has
        completed."""
        for slab, arr in zip(self.slabs, arrays):
            rows = arr.view(slab.dtype)
            for k, slot in enumerate(slots):
                slab[int(slot)].copy_(rows[k], non_blocking=non_blocking)

    def read(self, slots: Sequence[int], width: Optional[int] = None,
             device=None, non_blocking: bool = False) -> List[torch.Tensor]:
        """Per-leaf payloads for `slots` in the leaves' dtypes, block axis
        leading, on `device` (default the host): the inverse of `write`.
        `width` rows (default len(slots)), the rows past len(slots) zero
        (transfer padding).  `non_blocking` queues pinned-to-device copies
        on the current stream; every later write into these slots is then
        a copy queued after them (the engine never writes a slab from the
        host while copies are queued)."""
        n = len(slots)
        width = n if width is None else int(width)
        out = []
        for slab, dtype in zip(self.slabs, self.dtypes):
            rows = torch.zeros((width,) + tuple(slab.shape[1:]), dtype=slab.dtype,
                               device=device)
            for k, slot in enumerate(slots):
                rows[k].copy_(slab[int(slot)], non_blocking=non_blocking)
            out.append(rows.view(dtype))
        return out


@dataclasses.dataclass
class SwapRecord:
    """What a swapped-out victim needs to resume: which host slots hold its
    blocks (block-chain order) and how many tokens of KV they cover
    (`n_tokens` = the victim's fed position count; the last slot is a
    partial block unless n_tokens is block-aligned)."""

    slots: List[int]
    n_tokens: int
    nbytes: int


class HostTier:
    """Bookkeeping over one `HostBlockStore`: swap records vs spilled prefix
    blocks, with swaps taking priority for capacity (evicting spilled
    blocks LRU when the free list runs dry: state beats cache).

    Purely host-side; the engine owns every device interaction and calls
    down here only at host-sync boundaries."""

    def __init__(self, store: HostBlockStore, cost_model: SwapCostModel,
                 prefix_spill: bool = True):
        self.store = store
        self.cost_model = cost_model
        self.prefix_spill = bool(prefix_spill)
        # chain hash -> host slot, LRU order (oldest first): the spilled
        # shadow of KVPool._evictable
        self.spilled: "OrderedDict[int, int]" = OrderedDict()
        # counters the engine folds into ServingStats / obs at run end
        self.swaps_out = 0
        self.swaps_in = 0
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.spills = 0

    # -- capacity ----------------------------------------------------------

    def alloc_for_swap(self, n: int) -> Optional[List[int]]:
        """n slots for a preemption swap, evicting spilled prefix blocks
        (oldest first) when the free list alone cannot cover it."""
        while self.store.available < n and self.spilled:
            _, slot = self.spilled.popitem(last=False)
            self.store.release([slot])
        return self.store.alloc(n)

    def alloc_for_spill(self) -> Optional[int]:
        """One slot for a spilled prefix block: free list first, else
        recycle the oldest spilled block; spills never displace swap
        records."""
        slots = self.store.alloc(1)
        if slots is None and self.spilled:
            _, slot = self.spilled.popitem(last=False)
            return slot
        return slots[0] if slots else None

    # -- spilled-prefix map ------------------------------------------------

    def record_spill(self, chain_hash: int, slot: int) -> None:
        self.spilled[chain_hash] = slot
        self.spilled.move_to_end(chain_hash)
        self.spills += 1

    def lookup_spill(self, chain_hash: int) -> Optional[int]:
        return self.spilled.get(chain_hash)

    def take_spill(self, chain_hash: int) -> Optional[int]:
        """Claim a spilled block's slot for restore; the caller releases
        the slot once the payload is back on the device."""
        return self.spilled.pop(chain_hash, None)

    def snapshot(self) -> Dict[str, int]:
        """Tier gauges for `KVPool.snapshot` / obs: slot occupancy plus
        the lifetime swap/spill counters."""
        return {
            "host_blocks": self.store.num_slots,
            "host_used_blocks": self.store.used,
            "host_spilled_blocks": len(self.spilled),
            "host_pool_bytes": self.store.nbytes,
            "swaps_out": self.swaps_out,
            "swaps_in": self.swaps_in,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
        }
