"""Causal multi-head / grouped-query attention on dense K/V.

Port of `mdi_llm_tpu/ops/attention.py`.  Queries carry absolute positions
`q_pos` (B, Tq); key j is valid iff `k_pos[j] <= q_pos[i]` (and
`j < kv_valid_len` when given).  Logits and softmax run in float32, the
probabilities are cast to V's dtype before the PV product — the same chain
the JAX package computes, so greedy streams agree token for token.

This is the plain math the paged attention's reference route and the
ragged kernel's plain version build on; it is not a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite on purpose: see ops/ragged_paged_attention.py


def multihead_attention(
    q: torch.Tensor,  # (B, n_head, Tq, hs)
    k: torch.Tensor,  # (B, n_query_groups, Tk, hs)
    v: torch.Tensor,  # (B, n_query_groups, Tk, hs)
    q_pos: torch.Tensor,  # (B, Tq) absolute positions of the queries
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,)
    k_pos: Optional[torch.Tensor] = None,  # (B, Tk) absolute key positions
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention with implicit GQA; returns (B, n_head, Tq, hs)."""
    B, n_head, Tq, hs = q.shape
    _, n_groups, Tk, _ = k.shape
    if scale is None:
        scale = 1.0 / (hs**0.5)
    if k.dtype != q.dtype:  # narrow KV cache: upcast at the read
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    q_per_kv = n_head // n_groups
    qg = q.reshape(B, n_groups, q_per_kv, Tq, hs)
    logits = torch.einsum("bgqth,bgsh->bgqts", qg.float(), k.float()) * scale
    if k_pos is None:
        k_pos = torch.arange(Tk, device=q.device).expand(B, Tk)
    mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B, Tq, Tk)
    if kv_valid_len is not None:
        slot = torch.arange(Tk, device=q.device)
        mask = mask & (slot[None, None, :] < kv_valid_len[:, None, None])
    # a Python scalar, not a device tensor made from one: that would be a
    # host-to-device copy, illegal inside a CUDA graph capture
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bgqts,bgsh->bgqth", probs, v)
    return out.reshape(B, n_head, Tq, hs)
