"""Ring attention: causal attention with the sequence split over the
ranks of a sequence-parallel (sp) group.

Port of `mdi_llm_tpu/ops/ring_attention.py`.  Each rank holds a contiguous
chunk of the sequence's queries, keys and values; every rank's queries
attend the whole (distributed) sequence with an online softmax (running
max, denominator and weighted sum in float32), so the full (T, T) score
matrix is never formed.

The JAX package runs this inside a `shard_map` and rotates the K/V chunks
around the ring with `jax.lax.ppermute`.  The port's sp ranks share one
card, as its tp ranks do (`models/transformer.TPRanks`), so a ring step
takes the list of the ranks' local tensors and the rotation is index
arithmetic: at hop h, rank r sees chunk (r - h) mod P, the chunk the
ppermute ring hands it after h steps.  Ranks on different devices get the
chunk copied to theirs.  `ring_decode`'s `pmax`/`psum` are a max and a sum
over the ranks' partials (`parallel.collectives.all_reduce`).

Across processes (`group`, a `parallel.collectives.CommGroup` of the
processes that hold the sp ranks, each a contiguous range of them, in
rank order) a process passes its own ranks' tensors: `ring_attention`
first all-gathers every rank's K/V chunks of the call (one
`gather_summed` of K and V together, whose backward sums the
cotangent over the processes: other processes' queries read these
chunks), then runs its ranks' rings; `ring_decode` merges its ranks'
partials and then the processes' in two all-reduces, a max of m and one
sum of l and o packed together.

Two bodies, with the JAX package's numerics:

- the plain body: float32 accumulators, `NEG_INF` finite, exp arguments
  clamped at -80, p = 0 where a score is masked, the denominator floored
  at 1e-30;
- the flash body (`use_flash`, caller contract causal with q_pos ==
  k_pos == contiguous per-rank ranges): the diagonal block through K2
  with its LSE (`ops.flash.flash_attention_lse(causal=True)`), seeding the
  carry (lse, 1, o); each rotated chunk through K2 non-causal with its LSE,
  gated per batch row by whether the chunk precedes every local query
  (chunks are disjoint contiguous ranges, so a chunk lies wholly before
  or wholly after), its weight multiplied by the gate so a gated-out
  chunk adds exactly 0.  K2 runs P^2 times per call over P ranks; the
  gated-out blocks are computed and then zeroed, as in the JAX package.

Both bodies are differentiable through autograd; the flash body's
backward runs K3 and K4 with the LSE's cotangent (`ops/flash._FlashCore`).
On the CPU K2-K4 run as their plain versions, on the card as the kernels,
chosen by the tensors' device (`use_kernel=None`) as for every K2 caller.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from mdi_llm_tpu_torch.ops.flash import flash_attention_lse
from mdi_llm_tpu_torch.parallel.collectives import CommGroup, all_reduce, gather_summed

__all__ = ["ring_attention", "ring_decode", "NEG_INF"]

NEG_INF = -1e30


def _grouped(x: torch.Tensor, G: int) -> torch.Tensor:
    B, H, T, hs = x.shape
    return x.reshape(B, G, H // G, T, hs)


def _plain_rank(q, ks, vs, q_pos, k_pos, order, causal, scale):
    """One rank's plain ring: the online softmax over the chunks `order`
    (the rotation's order).  Returns (B, n_head, Tq, hs)."""
    B, H, Tq, hs = q.shape
    G = ks[0].shape[1]
    qg = _grouped(q, G).float()
    m = torch.full((B, G, H // G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qg)
    for c in order:
        k_c, v_c = ks[c].to(q.device), vs[c].to(q.device)
        s = torch.einsum("bgqth,bgsh->bgqts", qg, k_c.float()) * scale
        if causal:
            mask = k_pos[c].to(q.device)[:, None, :] <= q_pos[:, :, None]  # (B, Tq, Tk)
            s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully masked rows keep their exp arguments finite
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        p = torch.exp(torch.clamp(s - m_new[..., None], min=-80.0))
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bgqts,bgsh->bgqth", p, v_c.float())
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, Tq, hs).to(q.dtype)


def _flash_rank(q, ks, vs, q_pos, k_pos, r, order, scale, use_kernel):
    """One rank's flash ring: the diagonal chunk `r` through K2 causal
    seeding (lse, 1, o), then each chunk of `order` through K2 non-causal,
    gated per batch row."""
    B, H, Tq, hs = q.shape
    G = ks[r].shape[1]
    o_n, lse = flash_attention_lse(q, ks[r], vs[r], scale=scale, causal=True,
                                   use_kernel=use_kernel)
    # the carry in rescaled form: (m, l, o) and (lse, 1, o_normalized) are
    # equal under the merge rules
    m = lse.reshape(B, G, H // G, Tq)
    l = torch.ones_like(m)
    o = _grouped(o_n, G).float()
    q_min = q_pos.amin(dim=1)
    for c in order:
        k_c, v_c = ks[c].to(q.device), vs[c].to(q.device)
        o_h, lse_h = flash_attention_lse(q, k_c, v_c, scale=scale, causal=False,
                                         use_kernel=use_kernel)
        gate = (k_pos[c].to(q.device).amax(dim=1) <= q_min)[:, None, None, None]  # (B,1,1,1)
        lse_hg = torch.where(gate, lse_h.reshape(B, G, H // G, Tq),
                             torch.full_like(m, NEG_INF))
        m_new = torch.maximum(m, lse_hg)
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        # the chunk arrives normalized: its (m, l, o) form is (lse, 1, o_h)
        beta = torch.exp(torch.clamp(lse_hg - m_new, min=-80.0)) * gate.float()
        l = l * alpha + beta
        o = o * alpha[..., None] + _grouped(o_h, G).float() * beta[..., None]
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, Tq, hs).to(q.dtype)


def ring_attention(
    qs: Sequence[torch.Tensor],  # per rank (B, n_head, Tq_local, hs)
    ks: Sequence[torch.Tensor],  # per rank (B, n_groups, Tk_local, hs)
    vs: Sequence[torch.Tensor],  # per rank (B, n_groups, Tk_local, hs)
    q_pos: Sequence[torch.Tensor],  # per rank (B, Tq_local) absolute positions
    k_pos: Sequence[torch.Tensor],  # per rank (B, Tk_local) absolute positions
    causal: bool = True,
    scale: Optional[float] = None,
    use_flash: bool = False,
    use_kernel: Optional[bool] = None,  # K2-K4: None → the tensors' device
    # decides; False → their plain versions anywhere
    group: Optional[CommGroup] = None,
) -> List[torch.Tensor]:
    """Each rank's (B, n_head, Tq_local, hs): its queries' attention over
    the whole distributed key/value sequence, on its device.  `use_flash`
    (with `causal`) runs every block through K2 with its LSE (the module
    docstring).  With `group`, `qs`, `ks`, `vs` and `q_pos` are this
    process's ranks (one device) and `k_pos` every rank's."""
    first = 0
    if group is not None and group.size > 1:
        first = group.index * len(qs)
        ks, vs = _gather_chunks(ks, vs, group)
    P = len(ks)
    if len(k_pos) != P:
        raise ValueError(f"{len(k_pos)} key position chunks for a ring of {P} ranks")
    hs = qs[0].shape[-1]
    if scale is None:
        scale = 1.0 / (hs**0.5)
    out = []
    for i in range(len(qs)):
        r = first + i
        if use_flash and causal:
            order = [(r - h) % P for h in range(1, P)]
            out.append(_flash_rank(qs[i], ks, vs, q_pos[i], k_pos, r, order, scale,
                                   use_kernel))
        else:
            order = [(r - h) % P for h in range(P)]
            out.append(_plain_rank(qs[i], ks, vs, q_pos[i], k_pos, order, causal, scale))
    return out


def _gather_chunks(ks, vs, group: CommGroup):
    """Every rank's K and V chunks from the process's own (one call):
    stacked (2, local ranks, ...), gathered along the rank axis."""
    both = gather_summed(torch.stack([torch.stack(list(ks)), torch.stack(list(vs))]), 1, group)
    return list(both[0].unbind(0)), list(both[1].unbind(0))


def ring_decode(
    qs: Sequence[torch.Tensor],  # per rank (B, n_head, 1, hs): the decode token
    k_caches: Sequence[torch.Tensor],  # per rank (B, n_groups, C, hs), its shard
    v_caches: Sequence[torch.Tensor],
    k_pos: Sequence[torch.Tensor],  # per rank (B, C): each local slot's absolute
    # position (a sentinel >= 2^30 marks an empty slot)
    q_pos: Sequence[torch.Tensor],  # per rank (B, 1) the query's position
    scale: Optional[float] = None,
    group: Optional[CommGroup] = None,
) -> List[torch.Tensor]:
    """Decode-step attention over a sequence-split KV cache: each rank's
    online-softmax partials (m, l, o) over its shard, merged across the
    ranks by a max and two sums (the JAX `pmax`/`psum`), the distributed
    flash-decoding.  Returns each rank's (B, n_head, 1, hs), equal on
    every rank.  With `group`, the arguments are this process's ranks (one
    device), merged with the other processes' in two all-reduces."""
    B, H, Tq, hs = qs[0].shape
    G = k_caches[0].shape[1]
    if scale is None:
        scale = 1.0 / (hs**0.5)
    ms, ls, os_ = [], [], []
    for q, kc, vc, kp, qp in zip(qs, k_caches, v_caches, k_pos, q_pos):
        qg = _grouped(q, G).float()
        s = torch.einsum("bgqth,bgsh->bgqts", qg, kc.float()) * scale
        valid = kp[:, None, :] <= qp[:, :, None]  # (B, 1, C): an empty slot's
        # sentinel is never <= a real position
        s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(torch.clamp(s - m[..., None], min=-80.0))
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bgqts,bgsh->bgqth", p, vc.float()))
    if group is not None and group.size > 1:
        m_g = [group.all_reduce_(torch.stack(ms).amax(dim=0), op="max")] * len(ms)
    else:
        m_g = all_reduce(ms, op="max")
    corr = [torch.exp(torch.clamp(m - mg, min=-80.0)) for m, mg in zip(ms, m_g)]
    l_g = all_reduce([l * c for l, c in zip(ls, corr)])
    o_g = all_reduce([o * c[..., None] for o, c in zip(os_, corr)])
    if group is not None and group.size > 1:
        # l and o of this process's ranks, summed with the others' in one call
        packed = group.all_reduce_(torch.cat([l_g[0].reshape(-1), o_g[0].reshape(-1)]))
        n = l_g[0].numel()
        l_g = [packed[:n].view_as(l_g[0])] * len(ms)
        o_g = [packed[n:].view_as(o_g[0])] * len(ms)
    return [(o / torch.clamp(l[..., None], min=1e-30)).reshape(B, H, Tq, hs).to(q.dtype)
            for o, l, q in zip(o_g, l_g, qs)]
