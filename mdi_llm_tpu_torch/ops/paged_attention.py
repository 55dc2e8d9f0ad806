"""Paged attention over a pooled, block-table-indexed KV cache.

Port of `mdi_llm_tpu/ops/paged_attention.py`.  A layer's pool is
`(num_blocks, block_size, G, hs)` (fp or float8), or the quantized pool
`{"q": int8 (num_blocks, block_size, G, hs), "scale": float32 (num_blocks,
G)}` with one symmetric scale per (block, KV group); slot i of a
sequence's block table holds absolute positions `[i * block_size, (i + 1)
* block_size)`.

- `paged_update` scatters a chunk's K/V into the pool IN PLACE
  (`index_put_`; the JAX package donates the pool to the jitted step for
  the same effect).  Positions past a table's coverage are redirected to
  block 0, which the pool (`serving/kv_pool.py`) reserves as a write-only
  trash block.  A float8 pool casts on write; an int8 pool quantizes on
  write (`_quantized_update`): the block's scale only grows, and when it
  grows the block's existing payload is requantized in the same update, so
  a rewrite of the same (token, position) leaves the bytes unchanged and a
  block's final scale does not depend on how its tokens were grouped into
  calls.
- `paged_prefill` (the unified ragged step) and `paged_attention` (a
  per-sequence batch, packed into spans of width Tq) route a CUDA tensor
  to kernel K1 (`ops/ragged_paged_attention.py`) and a CPU tensor to the
  plain route, the JAX package's lax math.  `use_kernel=False` forces the
  plain route on any device (the on-card parity check uses it);
  `use_kernel=True` always goes through the K1 wrapper.
  `_paged_prefill_plain.calls` / `_paged_attention_plain.calls` count the
  plain route, so a run on the card can show it was never taken.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdi_llm_tpu_torch.ops.attention import multihead_attention
from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
    _pool_parts,
    gather_paged_kv,
    ragged_paged_attention,
    token_attention,
)

__all__ = ["paged_attention", "paged_prefill", "paged_update", "gather_paged_kv"]


def _quantized_update(pool, new, blk, off) -> None:
    """Quantizing write into one int8 pool, in place: `new` (N, G, hs)
    lands at (blk[n], off[n]) under its block's per-group scale.

    The arithmetic of the JAX package's `_quantized_update`: the scale is
    a running max (the old scale and each token's max |x| / 127, duplicate
    block ids folded by `scatter_reduce_`); the written blocks' payload is
    requantized by old / new from the payload and scales as they were
    before this call (duplicate block ids then write identical bytes, and
    a factor of exactly 1 rounds every byte back to itself); then each
    token is stored as clip(round(x / new), -127, 127), rounding half to
    even as JAX does.  The transient is the written blocks only."""
    q, s = pool["q"], pool["scale"]
    vals = new.float()
    tok_scale = vals.abs().amax(dim=-1) / 127.0  # (N, G)
    old_g = s[blk]  # (N, G) a copy: the scales before this call
    old_q = q[blk].float()  # (N, BS, G, hs) the payload before this call
    s.scatter_reduce_(0, blk[:, None].expand_as(tok_scale), tok_scale, "amax")
    new_g = s[blk]  # (N, G) after the update, >= old_g
    # an all-zero block (scale 0) maps 0 -> 0 whatever the factor: the
    # guard only dodges 0 / 0
    factor = torch.where(new_g > 0, old_g / new_g.clamp_min(1e-30), 0.0)
    q[blk] = torch.round(old_q * factor[:, None, :, None]).to(torch.int8)
    tok_q = torch.round(vals / new_g.clamp_min(1e-30)[..., None]).clamp(-127, 127)
    q.index_put_((blk, off), tok_q.to(torch.int8))


def paged_update(
    k_pool,  # (num_blocks, block_size, G, hs) or an int8 pool, updated in place
    v_pool,
    k_new: torch.Tensor,  # (B, T, G, hs)
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks)
    pos: torch.Tensor,  # (B, T) absolute positions of the chunk's tokens
):
    """Write position p of row b to block `table[b, p // block_size]`,
    offset `p % block_size`; block indices past the table go to the trash
    block 0.  A float8 pool casts on write, an int8 pool quantizes on
    write (`_quantized_update`).  Returns the (same, updated) pools."""
    MB = block_tables.shape[1]
    BS = _pool_parts(k_pool)[0].shape[1]
    pos = pos.long()
    idx = pos // BS
    blk = torch.gather(block_tables.long(), 1, idx.clamp(0, MB - 1))
    blk = torch.where(idx < MB, blk, torch.zeros_like(blk))
    off = pos % BS
    if isinstance(k_pool, dict):
        G, hs = k_new.shape[-2:]
        blk, off = blk.reshape(-1), off.reshape(-1)
        _quantized_update(k_pool, k_new.reshape(-1, G, hs), blk, off)
        _quantized_update(v_pool, v_new.reshape(-1, G, hs), blk, off)
        return k_pool, v_pool
    k_pool.index_put_((blk, off), k_new.to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new.to(v_pool.dtype))
    return k_pool, v_pool


def _paged_attention_plain(q, k_pool, v_pool, block_tables, q_pos, scale):
    _paged_attention_plain.calls += 1
    k = gather_paged_kv(k_pool, block_tables)
    v = gather_paged_kv(v_pool, block_tables)
    if isinstance(k_pool, dict):
        # dequantized K/V are float32: q runs in float32 too, the kernel's
        # math, and the output is cast back
        return multihead_attention(q.float(), k, v, q_pos, scale=scale).to(q.dtype)
    return multihead_attention(q, k, v, q_pos, scale=scale)


def _paged_prefill_plain(q, k_pool, v_pool, block_tables, q_slot, q_pos, scale):
    _paged_prefill_plain.calls += 1
    return token_attention(q, k_pool, v_pool, block_tables, q_slot, q_pos, scale)


_paged_attention_plain.calls = 0
_paged_prefill_plain.calls = 0


def paged_prefill(
    q: torch.Tensor,  # (1, n_head, T, hs) packed slot-major ragged queries
    k_pool,  # (num_blocks, block_size, G, hs), or an int8 pool
    v_pool,
    block_tables: torch.Tensor,  # (n_slots, max_blocks)
    q_slot: torch.Tensor,  # (T,) slot id per packed token (plain route)
    q_start: torch.Tensor,  # (n_slots,) span offset per slot (kernel)
    q_len: torch.Tensor,  # (n_slots,) span length (0 = slot absent)
    q_pos: torch.Tensor,  # (T,) absolute position per packed token
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> torch.Tensor:
    """Ragged mixed prefill+decode attention over the paged pool; returns
    (1, n_head, T, hs).  Packed rows no slot owns are garbage (plain
    route) or zeros (kernel) — the caller discards them."""
    hs, T = q.shape[-1], q.shape[2]
    if scale is None:
        scale = 1.0 / (hs**0.5)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return _paged_prefill_plain(
            q, k_pool, v_pool, block_tables, q_slot, q_pos, scale
        )
    i32 = torch.int32
    qstart, qlen = q_start.to(i32), q_len.to(i32)
    # the span's deepest visible position + 1 (spans are contiguous
    # position runs); the clamp only guards absent slots (q_len 0), whose
    # q_start may point anywhere
    lens = q_pos.to(i32)[qstart.long().clamp(0, T - 1)] + qlen
    return ragged_paged_attention(
        q.contiguous(), k_pool, v_pool, block_tables.to(i32), qstart, qlen,
        lens, q_pos.to(i32), scale=scale,
    )


def paged_attention(
    q: torch.Tensor,  # (B, n_head, Tq, hs)
    k_pool,  # (num_blocks, block_size, G, hs), or an int8 pool
    v_pool,
    block_tables: torch.Tensor,  # (B, max_blocks)
    q_pos: torch.Tensor,  # (B, Tq) absolute query positions
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> torch.Tensor:
    """Causal GQA attention through per-sequence block tables; returns
    (B, n_head, Tq, hs).  The kernel route packs sequence b as the span
    `[b * Tq, (b + 1) * Tq)` of a (1, n_head, B * Tq, hs) ragged batch."""
    B, n_head, Tq, hs = q.shape
    if scale is None:
        scale = 1.0 / (hs**0.5)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return _paged_attention_plain(q, k_pool, v_pool, block_tables, q_pos, scale)
    i32 = torch.int32
    qp = q.transpose(0, 1).reshape(1, n_head, B * Tq, hs).contiguous()
    qstart = torch.arange(B, dtype=i32, device=q.device) * Tq
    qlen = torch.full((B,), Tq, dtype=i32, device=q.device)
    lens = (q_pos.amax(dim=1) + 1).to(i32)
    out = ragged_paged_attention(
        qp, k_pool, v_pool, block_tables.to(i32), qstart, qlen, lens,
        q_pos.reshape(-1).to(i32).contiguous(), scale=scale,
    )
    return out[0].reshape(n_head, B, Tq, hs).transpose(0, 1)
