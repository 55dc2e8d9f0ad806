"""Decoder-only transformer as plain functions over a parameter tree.

Port of `mdi_llm_tpu/models/transformer.py`, for sequential generation,
serving and training.  The parameter tree keeps the JAX package's layout,
so converted weights drop in (`mdi_llm_tpu_torch.convert.params_from_numpy`):

- every per-layer leaf carries a leading layer axis; `run_blocks` is a
  Python loop over per-layer views of it, one `torch.unbind` per leaf
  (the JAX package scans it with `lax.scan`), with `remat` checkpointing
  each block for training;
- linear weights are torch-layout `(out, in)`; the attention projection is
  litGPT's fused QKV, interleaved per KV group (`_split_qkv`);
- two KV caches, each updated IN PLACE (the JAX package donates the cache
  to the jitted step for the same effect), so `forward` returns the
  logits only:
  - the dense cache of `Generator.generate` and `ChatSession`,
    `{"k", "v"}` each `(L, B, G, S, hs)` (`init_kv_cache`): chunk row b is
    written at slot `input_pos[b]`, and slot j holds absolute position j;
  - the serving engine's pool, `{"k", "v"}` each
    `(L, num_blocks, block_size, G, hs)` (fp or float8) or each an int8
    pool `{"q", "scale"}`, read and written through block tables
    (`ops/paged_attention.py`); `run_blocks` hands every layer views of
    its slice.

Attention runs on the kernels on the card: K1 for every paged call, K2
(`ops/flash.py`) for a fresh prefill or a training forward with
`use_flash`, and K3/K4 in that training forward's backward.  The dense-cache
attention of decode steps and short prefills stays the torch
`multihead_attention`, as the JAX package leaves it to XLA; so do the
large matrix products (`F.linear`, and `ops/quant.quantized_einsum` for
the linears and the untied head of a quantized tree).  Mixture-of-experts
layers (`moe_forward`) run the JAX package's dense formulation: every
expert on every token, weighted by the router's renormalised top-k, as
matrix products of the stacked expert weights (no Pallas kernel lies on
that path in the JAX package either).

`sharded_forward` is the same forward over the ranks of a tensor-parallel
split (`parallel/sharding.py`, the JAX package's GSPMD layout): each rank
runs this module's layer code on its slice through its rank config
(`shard_config`), and the partial sums of the row-parallel products meet
in one all-reduce each (`parallel/collectives.py`).  Its pieces
(`TPRanks`: embed, blocks, head) also carry the training meshes, under
autograd and, across processes, through the collectives' Megatron pair.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.ops.attention import multihead_attention
from mdi_llm_tpu_torch.ops.flash import flash_attention
from mdi_llm_tpu_torch.ops.norms import layer_norm, rms_norm
from mdi_llm_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_prefill,
    paged_update,
)
from mdi_llm_tpu_torch.ops.quant import is_quantized, quantized_einsum
from mdi_llm_tpu_torch.ops.ring_attention import ring_attention
from mdi_llm_tpu_torch.ops.rope import apply_rope, build_rope_cache, gather_rope
from mdi_llm_tpu_torch.parallel.collectives import all_gather, all_reduce, copy_to_ranks

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    if not is_quantized(p):
        return F.linear(x, p["weight"], p.get("bias"))
    y = quantized_einsum("...i,oi->...o", x, p)
    return y + p["bias"] if "bias" in p else y


def _norm(cfg: Config, x: torch.Tensor, p: Params) -> torch.Tensor:
    if cfg.norm_class_name == "RMSNorm":
        return rms_norm(
            x, p["weight"], cfg.norm_eps, add_unit_offset=cfg.rmsnorm_add_unit_offset
        )
    return layer_norm(x, p["weight"], p.get("bias"), cfg.norm_eps)


def _gelu(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if cfg.gelu_approximate == "tanh" else "none")


MLP_CLASSES = ("GptNeoxMLP", "LLaMAMLP", "GemmaMLP", "LLaMAMoE")


def check_supported(cfg: Config) -> None:
    """Refuse configs whose layers the port does not carry."""
    if cfg.mlp_class_name not in MLP_CLASSES:
        raise ValueError(
            f"{cfg.name}: mlp_class_name={cfg.mlp_class_name!r} is not ported "
            f"(the port carries {MLP_CLASSES})"
        )


def mlp_forward(cfg: Config, p: Params, x: torch.Tensor, moe_aux: bool = False,
                project: bool = True, moe_impl=None):
    """The (B, T, D) output; with `moe_aux` (LLaMAMoE only), (out, aux).
    `project=False` (a dense MLP) returns the input of the `proj` product
    instead, for a tensor-parallel rank to contract (`_row_parallel`).
    `moe_impl` replaces `moe_forward` with the same signature (the token
    dispatch of `parallel/expert.ep_moe_forward`)."""
    kind = cfg.mlp_class_name
    if moe_aux and kind != "LLaMAMoE":
        raise ValueError(f"moe_aux requires an MoE config (got {kind!r})")
    proj = (lambda h: linear(h, p["proj"])) if project else (lambda h: h)
    if kind == "GptNeoxMLP":
        return proj(_gelu(cfg, linear(x, p["fc"])))
    if kind == "LLaMAMLP":
        return proj(F.silu(linear(x, p["fc_1"])) * linear(x, p["fc_2"]))
    if kind == "GemmaMLP":
        return proj(_gelu(cfg, linear(x, p["fc_1"])) * linear(x, p["fc_2"]))
    if kind == "LLaMAMoE":
        return (moe_impl or moe_forward)(cfg, p, x, with_aux=moe_aux)
    check_supported(cfg)
    raise ValueError(f"unknown mlp_class_name {kind!r}")


def moe_forward(cfg: Config, p: Params, x: torch.Tensor, with_aux: bool = False):
    """Top-k routed mixture of experts in the JAX package's dense
    formulation (`mdi_llm_tpu/models/transformer.moe_forward`): every
    expert runs on every token, and the router's top-k weights,
    renormalised over the selected experts, zero out the rest.  The router
    runs in x's dtype and is cast to float32 for the softmax and top-k;
    the expert stacks are `gate` (E, D), `experts.fc_1`/`fc_2` (E, I, D)
    and `experts.proj` (E, D, I).

    `with_aux` also returns the load-balancing loss E * sum_e f_e * P_e
    (f_e: the share of top-k assignments routed to expert e, detached;
    P_e: the mean router probability of e), 1.0 at uniform routing.

    A tensor-parallel rank routes with the whole router and runs its own
    experts (`moe_route`, `moe_experts`: `TPRanks.block`)."""
    probs, onehot, dense_w = moe_route(cfg, p, x)
    y = moe_experts(p, x, dense_w)
    if not with_aux:
        return y
    assign, prob_sum = moe_stats(probs, onehot)
    return y, moe_aux_loss(cfg, assign, prob_sum, probs.numel() // probs.shape[-1])


def moe_route(cfg: Config, p: Params, x: torch.Tensor):
    """The router over every expert: (probs (..., E) float32, the top-k
    one-hots (..., k, E), the renormalised top-k weights as a dense
    (..., E) table)."""
    router = quantized_einsum("...i,ei->...e", x, p["gate"]).float()
    E = router.shape[-1]  # every expert of the router
    probs = torch.softmax(router, dim=-1)  # (..., E)
    topv, topi = torch.topk(probs, cfg.n_expert_per_token, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    # the normalised top-k weights scattered back to a dense (..., E) table
    onehot = F.one_hot(topi, E).to(probs.dtype)  # (..., k, E)
    return probs, onehot, torch.einsum("...k,...ke->...e", topv, onehot)


def moe_experts(p: Params, x: torch.Tensor, dense_w: torch.Tensor) -> torch.Tensor:
    """Every expert of `p` on every token of `x`, weighted by its column
    of `dense_w` (..., n_expert of p)."""
    ex = p["experts"]
    h1 = quantized_einsum("...d,eid->...ei", x, ex["fc_1"])
    h2 = quantized_einsum("...d,eid->...ei", x, ex["fc_2"])
    out = quantized_einsum("...ei,edi->...ed", F.silu(h1) * h2, ex["proj"])
    return torch.einsum("...ed,...e->...d", out, dense_w.to(out.dtype)).to(x.dtype)


def moe_stats(probs: torch.Tensor, onehot: torch.Tensor):
    """The aux's sums over tokens: (top-k assignments per expert,
    detached; router probability per expert), each (E,)."""
    E = probs.shape[-1]
    return onehot.detach().reshape(-1, E).sum(dim=0), probs.reshape(-1, E).sum(dim=0)


def moe_aux_loss(cfg: Config, assign: torch.Tensor, prob_sum: torch.Tensor,
                 n_tokens) -> torch.Tensor:
    """E * sum_e f_e * P_e from `moe_stats`' sums over `n_tokens` tokens
    (sums over several batches' shards give the whole batch's aux).  The
    sums over every rank of a split go in, never a mean of the ranks'
    auxes (f * P is not linear in the stats): the port's ranks run one
    after another in a process, so they hand back their raw stats and the
    caller sums them first, where the JAX package passes
    `moe_forward(stats_reduce=psum)`."""
    f = assign / (n_tokens * cfg.n_expert_per_token)
    pm = prob_sum / n_tokens
    return assign.shape[-1] * (f * pm).sum()


def _split_qkv(cfg: Config, qkv: torch.Tensor):
    """Un-interleave litGPT's fused QKV output (per KV group
    [q * q_per_kv, k, v]): q (B, T, n_head, hs), k/v (B, T, G, hs)."""
    B, T, _ = qkv.shape
    G = cfg.n_query_groups
    q_per_kv = cfg.n_head // G
    hs = cfg.head_size
    qkv = qkv.reshape(B, T, G, q_per_kv + 2, hs)
    q = qkv[:, :, :, :q_per_kv, :].reshape(B, T, cfg.n_head, hs)
    return q, qkv[:, :, :, q_per_kv, :], qkv[:, :, :, q_per_kv + 1, :]


def attention_forward(
    cfg: Config,
    p: Params,
    x: torch.Tensor,  # (B, T, D)
    pos: torch.Tensor,  # (B, T) absolute positions
    cos: torch.Tensor,  # (B, T, rope_n_elem) gathered for these positions
    sin: torch.Tensor,
    k_cache: Optional[torch.Tensor],  # this layer's cache: dense (B, G, S, hs)
    # or the paged pool (num_blocks, block_size, G, hs); None: no cache
    v_cache: Optional[torch.Tensor],
    input_pos: Optional[torch.Tensor] = None,  # (B,) chunk start (dense cache)
    paged_tables: Optional[torch.Tensor] = None,  # (B, max_blocks), or
    # (n_slots, max_blocks) with paged_ragged
    paged_kernel: Optional[bool] = None,
    paged_ragged: Optional[Tuple] = None,  # (q_slot, q_start, q_len): B == 1,
    # tokens packed slot-major, each reading/writing its own slot's table row
    paged_params=None,  # K1's split knobs (ops.tuning.KernelParams); None:
    # resolved for this call's geometry
    fresh_prefill: bool = False,
    use_flash: bool = False,
    flash_kernel: Optional[bool] = None,
    project: bool = True,  # False: the heads' output, before `proj`
) -> torch.Tensor:
    B, T, _ = x.shape
    q, k, v = attention_qkv(cfg, p, x, cos, sin)
    if paged_tables is not None:
        if paged_ragged is not None:
            # packed-tail padding carries a position past the table's
            # coverage, so its write lands in the trash block
            q_slot, q_start, q_len = paged_ragged
            paged_update(
                k_cache, v_cache, k[0][:, None], v[0][:, None],
                paged_tables[q_slot.long()], pos[0][:, None],
            )
            y = paged_prefill(
                q, k_cache, v_cache, paged_tables, q_slot, q_start, q_len, pos[0],
                use_kernel=paged_kernel, params=paged_params,
            )
        else:
            paged_update(k_cache, v_cache, k, v, paged_tables, pos)
            y = paged_attention(
                q, k_cache, v_cache, paged_tables, pos, use_kernel=paged_kernel,
                params=paged_params,
            )
    else:
        k, v = k.transpose(1, 2), v.transpose(1, 2)  # (B, G, T, hs)
        if k_cache is not None:
            # write this chunk into row b at slots input_pos[b] + [0, T) (the
            # cache may be narrower than the compute dtype)
            rows = torch.arange(B, device=x.device)[:, None]
            k_cache.transpose(1, 2)[rows, pos] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache.transpose(1, 2)[rows, pos] = v.transpose(1, 2).to(v_cache.dtype)
        if k_cache is not None and not fresh_prefill:
            # attend through the cache: slot j holds absolute position j
            y = multihead_attention(q, k_cache, v_cache, pos, input_pos + T)
        elif use_flash and T > 1:
            # a fresh chunk at offset 0 (q_pos == k_pos == arange(T))
            y = flash_attention(q, k, v, use_kernel=flash_kernel)
        else:
            # no cache, or a fresh prefill: attend the chunk itself
            y = multihead_attention(q, k, v, pos, k_pos=pos)
    return attention_out(cfg, p, y, x.dtype, project)


def attention_qkv(cfg: Config, p: Params, x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor):
    """The attention's projections with rope applied: q (B, n_head, T,
    hs), k and v (B, T, G, hs)."""
    q, k, v = _split_qkv(cfg, linear(x, p["qkv"]))
    q = q.transpose(1, 2)
    n_elem = cfg.rope_n_elem
    if n_elem > 0:
        cos_b, sin_b = cos[:, None], sin[:, None]
        q = torch.cat(
            [apply_rope(q[..., :n_elem], cos_b, sin_b), q[..., n_elem:]], dim=-1
        )
        kt = k.transpose(1, 2)
        k = torch.cat(
            [apply_rope(kt[..., :n_elem], cos_b, sin_b), kt[..., n_elem:]], dim=-1
        ).transpose(1, 2)
    return q, k, v


def attention_out(cfg: Config, p: Params, y: torch.Tensor, dtype,
                  project: bool = True) -> torch.Tensor:
    """The heads' output `y` (B, n_head, T, hs) as (B, T, n_head * hs) in
    `dtype`, through `proj` unless `project` is False."""
    B, _, T, _ = y.shape
    y = y.transpose(1, 2).reshape(B, T, cfg.n_head * cfg.head_size).to(dtype)
    return linear(y, p["proj"]) if project else y


def block_forward(cfg, p, x, pos, cos, sin, k_cache, v_cache,
                  collect_moe_aux: bool = False, moe_impl=None, **attn):
    """One transformer block, parallel-residual (GPT-NeoX) or sequential
    (Llama) form; `attn` goes to `attention_forward`.  With
    `collect_moe_aux` (MoE training) returns (x, this layer's aux loss)."""
    n1 = _norm(cfg, x, p["norm_1"])
    att = attention_forward(cfg, p["attn"], n1, pos, cos, sin, k_cache, v_cache, **attn)
    return block_finish(cfg, p, x, n1, att, collect_moe_aux, moe_impl)


def block_finish(cfg, p, x, n1, att, collect_moe_aux: bool = False, moe_impl=None):
    """The rest of a block after its attention output `att` (`n1` the
    block input `x` under `norm_1`): the residual, `norm_2` and the MLP
    (`moe_impl`: `mlp_forward`'s)."""
    if cfg.parallel_residual:
        n2 = n1 if cfg.shared_attention_norm else _norm(cfg, x, p["norm_2"])
        x = x + att
    else:
        x = x + att
        n2 = _norm(cfg, x, p["norm_2"])
    out = mlp_forward(cfg, p["mlp"], n2, moe_aux=collect_moe_aux, moe_impl=moe_impl)
    if collect_moe_aux:
        return x + out[0], out[1]
    return x + out


def tree_map(fn, tree: Params) -> Params:
    """`fn` applied to every leaf of a nested-dict parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Params) -> list:
    """The leaves of a nested-dict tree, in sorted-key order (the order
    `jax.tree_util.tree_leaves` gives the same tree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def slice_blocks(blocks: Params, start: int, stop: int) -> Params:
    """Layers [start, stop) of the layer-stacked block tree: a leading-axis
    slice of every leaf (views, no copy)."""
    return tree_map(lambda x: x[start:stop], blocks)


def unbind_layers(blocks: Params, L: int) -> list:
    """The L per-layer views of the layer-stacked block tree, one
    `torch.unbind` per leaf: under autograd the layers' gradients then
    come back as one stack per leaf, where indexing `x[i]` would build a
    zero-filled (L, ...) gradient for every layer."""
    views = tree_map(torch.unbind, blocks)  # leaves become L-tuples
    return [tree_map(lambda v: v[i], views) for i in range(L)]


def run_blocks(
    cfg, blocks, x, pos, cos, sin, kv: Optional[KVCache], remat: bool = False,
    collect_moe_aux: bool = False, moe_impl=None, **attn
):
    """The block stack, layer by layer, over the dense cache, the pooled
    cache or (kv None) none.  `remat` (training, kv None) recomputes each
    block in the backward instead of keeping its activations — the
    counterpart of the JAX package's `jax.checkpoint` around the scanned
    block: activation memory of one layer instead of L.

    `collect_moe_aux` (MoE training, kv None) returns (x, the layers'
    summed load-balancing aux in float32); each layer's aux comes back
    through its checkpointed block under remat."""
    if remat and kv is not None:
        raise ValueError("remat is a training path (kv must be None)")
    if collect_moe_aux and kv is not None:
        raise ValueError("collect_moe_aux is a training path (kv must be None)")
    L = blocks["norm_1"]["weight"].shape[0]
    layers = unbind_layers(blocks, L)
    block = functools.partial(block_forward, cfg, collect_moe_aux=collect_moe_aux,
                              moe_impl=moe_impl)
    aux_sum = None
    for i in range(L):
        if remat:
            # the forward has no randomness, so no RNG state to restore
            out = checkpoint(
                block, layers[i], x, pos, cos, sin, None, None,
                use_reentrant=False, preserve_rng_state=False, **attn,
            )
        else:
            out = block(
                layers[i], x, pos, cos, sin,
                None if kv is None else _layer_pool(kv["k"], i),
                None if kv is None else _layer_pool(kv["v"], i),
                **attn,
            )
        if collect_moe_aux:
            x, aux = out
            aux_sum = aux if aux_sum is None else aux_sum + aux
        else:
            x = out
    return (x, aux_sum) if collect_moe_aux else x


def embed(cfg: Config, params: Params, tokens: torch.Tensor, pos: torch.Tensor):
    return _embed_finish(cfg, params, params["wte"]["weight"][tokens.long()], pos)


def _embed_finish(cfg: Config, params: Params, x: torch.Tensor, pos: torch.Tensor):
    """The looked-up rows `x`, scaled and with learned positions added."""
    if cfg.scale_embeddings:
        # the JAX package multiplies by the scale cast to x's dtype; a 0-d
        # CPU tensor keeps that rounding and is read as a kernel argument,
        # where a device tensor made from a scalar would be a host-to-device
        # copy (refused inside a CUDA graph capture)
        x = x * torch.full((), cfg.n_embd**0.5, dtype=x.dtype)
    if cfg.pos_embedding == "learned":
        wpe = params["wpe"]["weight"]
        x = x + wpe[pos.long().clamp(0, wpe.shape[0] - 1)]
    return x


def head(cfg: Config, params: Params, x: torch.Tensor) -> torch.Tensor:
    return _head_logits(cfg, params, _norm(cfg, x, params["ln_f"]))


def _head_logits(cfg: Config, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The logits of the normed hidden states `x` (a rank's vocabulary
    slice when `params` is a tensor-parallel rank's tree)."""
    w = params["wte"] if cfg.tie_embeddings else params["lm_head"]
    logits = quantized_einsum("...d,vd->...v", x, w)
    if cfg.lm_head_bias:
        logits = logits + params["lm_head"]["bias"]
    return logits


def forward(
    cfg: Config,
    params: Params,
    tokens: torch.Tensor,  # (B, T)
    input_pos: torch.Tensor,  # (B,) chunk start, or (B, T) per-token positions
    kv: Optional[KVCache] = None,
    paged_tables: Optional[torch.Tensor] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    paged_kernel: Optional[bool] = None,
    paged_ragged: Optional[Tuple] = None,
    fresh_prefill: bool = False,
    use_flash: bool = False,
    flash_kernel: Optional[bool] = None,
    remat: bool = False,
    collect_moe_aux: bool = False,
    moe_impl=None,
):
    """Logits (B, T, padded_vocab); the cache in `kv` is updated in place.

    Without `paged_tables`, `kv` is the dense cache (`init_kv_cache`) or
    None: the chunk is written at each row's `input_pos`, and attention
    reads the cache up to `input_pos + T`.  `fresh_prefill` (caller
    contract: input_pos == 0, cache empty) attends the chunk itself
    instead, and with `use_flash` runs it through K2 (`flash_kernel`
    False: K2's plain version).

    With `paged_tables`, `kv` is the serving engine's pool.  With
    `paged_ragged` (the unified mixed step), `tokens` is a (1, T) packed
    batch and `input_pos` its (1, T) per-token positions; `paged_tables`
    is the (n_slots, max_blocks) table.

    Without any cache (`kv` None) the forward is the training one: it
    carries gradients, through K2-K4 with `use_flash` (ops/flash.py), and
    `remat` recomputes each block in the backward.  `collect_moe_aux` (MoE
    training) returns (logits, the layer-summed load-balancing aux): the
    JAX package's third return, the cache being updated in place here.
    `moe_impl` runs the MoE layers instead of `moe_forward` (the token
    dispatch of an ep mesh, `parallel/expert.ep_moe_forward`)."""
    B, T = tokens.shape
    if input_pos.dim() == 2:
        pos = input_pos.long()
    else:
        pos = input_pos.long()[:, None] + torch.arange(T, device=tokens.device)
    if rope is None:
        rope = get_rope_cache(cfg, device=tokens.device)
    # the gather clamps: padding tokens deliberately sit past the table
    cos, sin = gather_rope(rope[0], rope[1], pos)
    x = embed(cfg, params, tokens, pos)
    if paged_tables is not None:
        attn = dict(paged_tables=paged_tables, paged_kernel=paged_kernel,
                    paged_ragged=paged_ragged)
    else:
        attn = dict(input_pos=input_pos.long(), fresh_prefill=fresh_prefill,
                    use_flash=use_flash, flash_kernel=flash_kernel)
    out = run_blocks(cfg, params["blocks"], x, pos, cos, sin, kv, remat=remat,
                     collect_moe_aux=collect_moe_aux, moe_impl=moe_impl, **attn)
    if collect_moe_aux:
        return head(cfg, params, out[0]), out[1]
    return head(cfg, params, out)


# ---------------------------------------------------------------------------
# the tensor-parallel forward
# ---------------------------------------------------------------------------


def shard_config(cfg: Config, tp: int) -> Config:
    """A tensor-parallel rank's config: n_head/tp heads over
    n_query_groups/tp KV groups, and intermediate_size/tp (dense MLP) or
    n_expert/tp experts (MoE).  The head size, the top-k and every other
    field stay the model's."""
    if tp == 1:
        return cfg
    kw = dict(n_head=cfg.n_head // tp, n_query_groups=cfg.n_query_groups // tp)
    if cfg.mlp_class_name == "LLaMAMoE":
        kw["n_expert"] = cfg.n_expert // tp
    else:
        kw["intermediate_size"] = cfg.intermediate_size // tp
    return dataclasses.replace(cfg, **kw)


def _replicated(devices: Sequence[torch.device], fn: Callable[[int], Any]) -> List[Any]:
    """`fn(r)` for each rank r, computed once per distinct device and
    shared by the ranks on it (the value is a replicated one)."""
    memo: Dict[torch.device, Any] = {}
    for r, d in enumerate(devices):
        if d not in memo:
            memo[d] = fn(r)
    return [memo[d] for d in devices]


def _row_parallel(hs: Sequence[torch.Tensor], lins: Sequence[Params], rep,
                  group=None) -> List[torch.Tensor]:
    """A row-parallel linear over the ranks: each rank contracts its input
    slice `hs[r]` with its weight slice, the partial sums are all-reduced
    (over `group`'s processes too), and the bias (whole on every rank) is
    added once, after the sum.  A w8a8 weight quantizes every slice on the
    whole row's per-token max |h| (`ops.quant._w8a8`)."""
    amax = None
    if "weight_q8" in lins[0]:
        amax = all_reduce([h.float().abs().amax(dim=-1, keepdim=True) for h in hs],
                          op="max", group=group)
    y = all_reduce([
        quantized_einsum("...i,oi->...o", h, lin, amax=None if amax is None else amax[r])
        for r, (h, lin) in enumerate(zip(hs, lins))
    ], group=group)
    return rep(lambda r: y[r] + lins[r]["bias"] if "bias" in lins[r] else y[r])


class TPRanks:
    """The tensor-parallel ranks of one model replica that this process
    runs: `ranks` each rank's tree (`parallel.sharding.shard_params`, or a
    Trainer's views), in rank order, each on its device; `group` the
    processes that hold the replica's other ranks (a
    `parallel.collectives.CommGroup`, in tp order; None when this process
    holds them all).  `tp` counts the replica's ranks over every process,
    `offset` is this process's first rank, `cfg_r` a rank's config
    (`shard_config`).  A rank's tree may hold a pipeline stage's blocks
    only (`parallel.sharding.shard_ranks` of a `split_params` stage):
    `stage` runs them; `embed` and `head` need the whole rank tree."""

    def __init__(self, cfg: Config, ranks: Sequence[Params], group=None):
        self.cfg, self.ranks, self.group = cfg, list(ranks), group
        n_proc = 1 if group is None else group.size
        self.tp = len(self.ranks) * n_proc
        self.offset = 0 if group is None else group.index * len(self.ranks)
        self.cfg_r = shard_config(cfg, self.tp)
        self.devs = [next(iter(tree_leaves(p))).device for p in self.ranks]
        self.rep = functools.partial(_replicated, self.devs)

    def positions(self, tokens, input_pos, ropes=None):
        """Each rank's (pos, cos, sin) for a chunk at `input_pos`."""
        T = tokens.shape[1]
        if input_pos.dim() == 2:
            pos0 = input_pos.long()
        else:
            pos0 = input_pos.long()[:, None] + torch.arange(T, device=tokens.device)
        pos = self.rep(lambda r: pos0.to(self.devs[r]))
        if ropes is None:
            ropes = [get_rope_cache(self.cfg, device=d) for d in self.devs]
        # the gather clamps: padding tokens deliberately sit past the table
        cs = self.rep(lambda r: gather_rope(ropes[r][0], ropes[r][1], pos[r]))
        return pos, [c for c, _ in cs], [s_ for _, s_ in cs]

    def embed(self, tokens, pos) -> List[torch.Tensor]:
        """The vocabulary-parallel lookup: each rank gathers the rows of its
        vocabulary slice, zero where a token lies outside it, and the
        ranks' rows are summed (exactly one rank holds each token)."""
        parts = []
        for r, p in enumerate(self.ranks):
            w = p["wte"]["weight"]
            V = w.shape[0]
            t = tokens.to(w.device).long() - (self.offset + r) * V
            inside = (t >= 0) & (t < V)
            parts.append(torch.where(inside[..., None], w[t.clamp(0, V - 1)], 0.0))
        x = all_reduce(parts, group=self.group)
        return self.rep(lambda r: _embed_finish(self.cfg, self.ranks[r], x[r], pos[r]))

    def layers(self) -> List[list]:
        """Each rank's per-layer views (`unbind_layers`)."""
        L = self.ranks[0]["blocks"]["norm_1"]["weight"].shape[0]
        return [unbind_layers(p["blocks"], L) for p in self.ranks]

    def block(self, lay, x, pos, cos, sin, caches, attn, collect_moe_aux=False):
        """One block over the ranks: the attention of each rank's heads and
        the MLP of each rank's slice (or experts) are partial sums, each
        all-reduced once and then given its row-parallel bias; norms and
        residuals are replicated.  Both block shapes (parallel residual
        with or without a shared norm, and sequential) as `block_forward`.
        `collect_moe_aux` also returns the router's `moe_stats` (the whole
        router, computed once per device)."""
        x, n2 = self.block_attn(lay, x, pos, cos, sin, caches, attn)
        return self.block_mlp(lay, x, n2, collect_moe_aux)

    def block_attn(self, lay, x, pos, cos, sin, caches, attn):
        """A block up to its MLP: (the residual stream after the
        attention, its input to the MLP under `norm_2`), each per rank."""
        n1, n1c = self.norm_in(lay, x)
        heads = [attention_forward(self.cfg_r, lay[r]["attn"], n1c[r], pos[r], cos[r], sin[r],
                                   *caches[r], project=False, **attn[r])
                 for r in range(len(lay))]
        return self.attn_rest(lay, x, n1, heads)

    def norm_in(self, lay, x):
        """Each rank's block input under `norm_1` (once per device), and
        the same through `copy_to_ranks` for the column-parallel products."""
        n1 = self.rep(lambda r: _norm(self.cfg, x[r], lay[r]["norm_1"]))
        return n1, self.rep(lambda r: copy_to_ranks(n1[r], self.group))

    def block_rest(self, lay, x, n1, heads, collect_moe_aux=False):
        """A block after its attention: `heads` each rank's heads' output
        (B, T, n_head/tp * hs) before `proj`, `n1` the input under
        `norm_1` (`norm_in`); `block`'s return."""
        x, n2 = self.attn_rest(lay, x, n1, heads)
        return self.block_mlp(lay, x, n2, collect_moe_aux)

    def attn_rest(self, lay, x, n1, heads):
        """`heads` through the row-parallel `proj`, the residual and
        `norm_2`: `block_attn`'s return."""
        cfg, rep, tp = self.cfg, self.rep, len(lay)
        att = _row_parallel(heads, [lay[r]["attn"]["proj"] for r in range(tp)], rep, self.group)
        if cfg.parallel_residual:
            n2 = n1 if cfg.shared_attention_norm else rep(
                lambda r: _norm(cfg, x[r], lay[r]["norm_2"]))
            x = rep(lambda r: x[r] + att[r])
        else:
            x = rep(lambda r: x[r] + att[r])
            n2 = rep(lambda r: _norm(cfg, x[r], lay[r]["norm_2"]))
        return x, n2

    def block_mlp(self, lay, x, n2, collect_moe_aux=False):
        """A block's MLP on `n2` and its residual: `block`'s return."""
        cfg, cfg_r, rep, group, tp = self.cfg, self.cfg_r, self.rep, self.group, len(lay)
        n2c = rep(lambda r: copy_to_ranks(n2[r], group))
        stats = None
        if cfg.mlp_class_name == "LLaMAMoE":
            # the whole router once per device; each rank's experts give a
            # partial sum of the routed output
            route = rep(lambda r: moe_route(cfg, lay[r]["mlp"], n2[r]))
            dense_w = rep(lambda r: copy_to_ranks(route[r][2], group))
            n_e = cfg_r.n_expert
            out = all_reduce([
                moe_experts(lay[r]["mlp"], n2c[r],
                            dense_w[r][..., (self.offset + r) * n_e:(self.offset + r + 1) * n_e])
                for r in range(tp)], group=group)
            if collect_moe_aux:
                stats = moe_stats(route[0][0], route[0][1])
        else:
            hidden = [mlp_forward(cfg_r, lay[r]["mlp"], n2c[r], project=False)
                      for r in range(tp)]
            out = _row_parallel(hidden, [lay[r]["mlp"]["proj"] for r in range(tp)], rep, group)
        x = rep(lambda r: x[r] + out[r])
        return (x, stats) if collect_moe_aux else x

    def blocks(self, layers, x, pos, cos, sin, attn, start=0, stop=None, kv=None,
               remat=False, collect_moe_aux=False):
        """Layers [start, stop) of `layers` (`self.layers()`) over the
        ranks; `kv` each rank's cache.  `remat` recomputes each layer's
        rank group in the backward (one `torch.utils.checkpoint` per
        layer, as `run_blocks`).  With `collect_moe_aux` returns (x, the
        layers' `moe_stats` stacked (n_layers, 2, E))."""
        if remat and kv is not None:
            raise ValueError("remat is a training path (kv must be None)")
        stop = len(layers[0]) if stop is None else stop
        stats = []
        for i in range(start, stop):
            lay = [layers[r][i] for r in range(len(self.ranks))]
            caches = self.caches(kv, i)
            if remat:
                out = checkpoint(self.block, lay, x, pos, cos, sin, caches, attn,
                                 collect_moe_aux, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = self.block(lay, x, pos, cos, sin, caches, attn, collect_moe_aux)
            if collect_moe_aux:
                x, st = out
                stats.append(torch.stack(st))
            else:
                x = out
        return (x, torch.stack(stats)) if collect_moe_aux else x

    def caches(self, kv, i: int) -> list:
        """Each rank's (k, v) cache of layer `i`, (None, None) without `kv`."""
        return [(None, None) if kv is None
                else (_layer_pool(kv[r]["k"], i), _layer_pool(kv[r]["v"], i))
                for r in range(len(self.ranks))]

    def stage(self, layers, x, pos, cos, sin, kv, **attn) -> torch.Tensor:
        """The layers `layers` (`self.layers()`: a pipeline stage's slice)
        over the ranks from one copy of the activations `x` and of `pos`,
        `cos` and `sin`, each moved to every rank's device, rank r through
        its cache `kv[r]` with the attention keywords `attn` (tensors and
        tuples of tensors moved likewise): the output on the first rank's
        device, where the ranks' copies are equal after each block's
        all-reduce."""

        def move(r, v):
            if isinstance(v, torch.Tensor):
                return v.to(self.devs[r], non_blocking=True)
            if isinstance(v, tuple):
                return tuple(move(r, a) for a in v)
            return v

        args = [self.rep(lambda r, t=t: move(r, t)) for t in (x, pos, cos, sin)]
        attn_r = self.rep(lambda r: {k: move(r, v) for k, v in attn.items()})
        return self.blocks(layers, *args, attn_r, kv=kv)[0]

    def head(self, x) -> torch.Tensor:
        """The logits (B, T, padded_vocab) on the first rank's device: each
        rank's vocabulary slice of the normed states, gathered."""
        cfg, rep = self.cfg, self.rep
        normed = rep(lambda r: copy_to_ranks(_norm(cfg, x[r], self.ranks[r]["ln_f"]),
                                             self.group))
        return all_gather([_head_logits(cfg, self.ranks[r], normed[r])
                           for r in range(len(self.ranks))], -1, self.group)[0]


def sharded_forward(
    cfg: Config,
    ranks: Sequence[Params],
    tokens: torch.Tensor,
    input_pos: torch.Tensor,
    kv: Optional[Sequence[KVCache]] = None,
    paged_tables: Optional[torch.Tensor] = None,
    ropes: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    paged_kernel: Optional[bool] = None,
    paged_ragged: Optional[Tuple] = None,
    paged_params=None,
    fresh_prefill: bool = False,
    use_flash: bool = False,
    flash_kernel: Optional[bool] = None,
    remat: bool = False,
    collect_moe_aux: bool = False,
    group=None,
):
    """`forward` over the tp ranks of one Megatron split: `ranks` holds
    each rank's tree (`parallel.sharding.shard_params`), in rank order,
    each on its device; `kv` each rank's cache, dense `(L, B, G/tp, S,
    hs)` or the paged pool `(L, NB, BS, G/tp, hs)`, updated in place;
    `ropes` each rank's rope tables.  Returns the logits (B, T,
    padded_vocab) on rank 0's device.

    Each rank runs the layer code of `forward` on its slice through the
    rank config (`shard_config`): its heads over its KV groups (the fused
    qkv keeps whole groups in a contiguous row slice), K1 on its pool
    slice or K2 on its prefill, its MLP slice or its experts.  Partial
    sums meet in one all-reduce after each row-parallel product (the
    attention and MLP `proj`), whose bias is then added once; the
    embedding is a vocabulary-parallel lookup summed across ranks, and
    the head's vocabulary slices are gathered.  K1's split knobs are
    resolved on the model's whole geometry (`ops.tuning.
    global_kernel_params`) unless `paged_params` gives them.

    Without a cache it is the training forward (`training.Trainer` on a
    mesh): it carries gradients, through K2-K4 per rank with `use_flash`,
    `remat` recomputes each layer's rank group in the backward, and
    `collect_moe_aux` returns (logits, the layers' `moe_stats` (L, 2,
    E)).  `group` holds the replica's ranks in other processes
    (`TPRanks`)."""
    tr = TPRanks(cfg, ranks, group)
    devs = tr.devs
    pos, cos, sin = tr.positions(tokens, input_pos, ropes)
    x = tr.embed(tokens, pos)
    if paged_tables is not None:
        if paged_params is None and devs[0].type != "cpu" and paged_kernel is not False:
            from mdi_llm_tpu_torch.ops import tuning
            from mdi_llm_tpu_torch.ops.ragged_paged_attention import _pool_parts

            pool = _pool_parts(kv[0]["k"])[0]  # (L, NB, BS, G/tp, hs)
            paged_params = tuning.global_kernel_params(
                cfg.n_head, cfg.n_query_groups, cfg.head_size, pool.shape[2],
                x[0].dtype, pool.dtype, devs[0])
        attn = tr.rep(lambda r: dict(
            paged_tables=paged_tables.to(devs[r]), paged_kernel=paged_kernel,
            paged_ragged=(None if paged_ragged is None
                          else tuple(a.to(devs[r]) for a in paged_ragged)),
            paged_params=paged_params))
    else:
        attn = tr.rep(lambda r: dict(
            input_pos=input_pos.long().to(devs[r]), fresh_prefill=fresh_prefill,
            use_flash=use_flash, flash_kernel=flash_kernel))
    out = tr.blocks(tr.layers(), x, pos, cos, sin, attn, kv=kv, remat=remat,
                    collect_moe_aux=collect_moe_aux)
    if collect_moe_aux:
        return tr.head(out[0]), out[1]
    return tr.head(out)


def replicas_forward(cfg: Config, units: Sequence[TPRanks], moe, tokens, input_pos,
                     kv=None, ropes=None, fresh_prefill: bool = False, use_flash: bool = False,
                     flash_kernel: Optional[bool] = None, remat: bool = False,
                     collect_moe_aux: bool = False):
    """`sharded_forward` over the dp replicas of an ep mesh beside tp or dp
    (the JAX Generator's and Trainer's `ep_moe_forward` under GSPMD):
    `units` holds each replica's `TPRanks` (of one rank at tp = 1), which
    takes its contiguous rows of `tokens` (B, T) and `input_pos` (B,);
    `kv` and `ropes` hold each replica's per-rank caches and rope tables,
    as `sharded_forward`'s.  `moe` is (impl, mlp): the token dispatch
    (`parallel.expert.ep_moe_forward` bound to its mesh) and the whole
    tree's layer-stacked `blocks.mlp` subtree.

    Each layer runs every replica's attention over its tp ranks
    (`TPRanks.block_attn`), then one dispatch over every replica's rows
    under `norm_2` at once, in replica order: the whole batch, as the JAX
    dispatch routes it (at a finite capacity factor which assignments
    drop depends on every row).  The dispatch runs on the first rank's
    device over the whole router and every expert, split over ep by the
    dispatch and never over tp, and its output goes to every rank of its
    rows' replica as it is: no partial sums, no all-reduce.  `remat`
    recomputes each layer, every replica, in the backward.  Returns the
    logits (B, T, padded_vocab) on the first rank's device; with
    `collect_moe_aux` also the layers' summed aux (the dispatch's, from
    the whole batch's router stats)."""
    impl, mlp = moe
    n = len(units)
    rows = tokens.shape[0] // n
    sls = [slice(d * rows, (d + 1) * rows) for d in range(n)]
    pcs = [u.positions(tokens[sl], input_pos[sl], None if ropes is None else ropes[d])
           for d, (u, sl) in enumerate(zip(units, sls))]
    x = [u.embed(tokens[sl], pc[0]) for u, sl, pc in zip(units, sls, pcs)]
    attn = [u.rep(lambda r, u=u, sl=sl: dict(
        input_pos=input_pos[sl].long().to(u.devs[r]), fresh_prefill=fresh_prefill,
        use_flash=use_flash, flash_kernel=flash_kernel)) for u, sl in zip(units, sls)]
    memo: Dict[int, list] = {}  # replicas that are one object unbind once
    for u in units:
        if id(u) not in memo:
            memo[id(u)] = u.layers()
    layers = [memo[id(u)] for u in units]
    L = mlp["gate"]["weight"].shape[0]
    moe_layers = unbind_layers(mlp, L)
    dev = units[0].devs[0]

    def layer(i, lay, moe_lay, x):
        mids = [u.block_attn(lay[d], x[d], *pcs[d], u.caches(None if kv is None else kv[d], i),
                             attn[d]) for d, u in enumerate(units)]
        out = impl(cfg, moe_lay, torch.cat([n2[0].to(dev) for _, n2 in mids]),
                   with_aux=collect_moe_aux)
        y = out[0] if collect_moe_aux else out
        xs = []
        for d, (u, (h, _)) in enumerate(zip(units, mids)):
            part = y[sls[d]]
            xs.append(u.rep(lambda r, u=u, h=h, part=part: h[r] + part.to(u.devs[r])))
        return (xs, out[1]) if collect_moe_aux else xs

    aux = []
    for i in range(L):
        lay = [[lr[i] for lr in ls] for ls in layers]
        if remat:
            out = checkpoint(layer, i, lay, moe_layers[i], x, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = layer(i, lay, moe_layers[i], x)
        if collect_moe_aux:
            x, a = out
            aux.append(a)
        else:
            x = out
    logits = torch.cat([u.head(h).to(dev) for u, h in zip(units, x)])
    return (logits, torch.stack(aux).sum()) if collect_moe_aux else logits


def sp_forward(cfg: Config, units: Sequence[TPRanks], tokens, input_pos,
               use_flash: bool = False, flash_kernel: Optional[bool] = None,
               remat: bool = False, collect_moe_aux: bool = False, group=None):
    """The cache-less forward over a sequence-parallel group (training and
    eval, the JAX `forward(sp_axis="sp")` under `shard_map`): sp rank s
    holds the chunk `tokens[s]` (B, T) that starts at `input_pos[s]` (B,)
    and runs its layers over its tensor-parallel ranks `units[s]` (a
    `TPRanks`, of one rank at tp = 1).  Each layer runs every sp rank's
    norm and q/k/v on each of its tp ranks, then, per tp rank, the ring
    attention over the sp ranks' chunks of that rank's heads
    (`ops/ring_attention.ring_attention` with q_pos == k_pos: K2 with the
    LSE per block under `use_flash`, K3 and K4 in the backward), then each
    sp rank's rest of the block.  `remat` recomputes each layer, all its
    ranks, in the backward.  Returns each sp rank's logits (B, T,
    padded_vocab) on its first device; with `collect_moe_aux` also the
    router's `moe_stats` of every layer summed over the sp ranks, (L, 2,
    E), for the aux of the whole sequence (`moe_aux_loss`).

    With `group` (a `parallel.collectives.CommGroup` of the processes that
    hold the sp ranks, each a contiguous range of equal chunks, contiguous
    in position), `units`, `tokens` and `input_pos` are this process's sp
    ranks: the ring gathers the other processes' K/V chunks
    (`ring_attention(group=...)`), and the sums over sp ranks are this
    process's."""
    pcs = [u.positions(t, ip) for u, t, ip in zip(units, tokens, input_pos)]
    pos, cos, sin = ([pc[j] for pc in pcs] for j in range(3))
    x = [u.embed(t, p) for u, t, p in zip(units, tokens, pos)]
    memo: Dict[int, list] = {}  # units that are one object unbind once
    for u in units:
        if id(u) not in memo:
            memo[id(u)] = u.layers()
    layers = [memo[id(u)] for u in units]

    def layer(lay, x, pos, cos, sin):
        return _sp_layer(units, lay, x, pos, cos, sin, use_flash, flash_kernel,
                         collect_moe_aux, group)

    stats = []
    for i in range(len(layers[0][0])):
        lay = [[lr[i] for lr in ls] for ls in layers]
        if remat:
            out = checkpoint(layer, lay, x, pos, cos, sin, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = layer(lay, x, pos, cos, sin)
        if collect_moe_aux:
            x, st = out
            stats.append(st)
        else:
            x = out
    logits = [u.head(h) for u, h in zip(units, x)]
    return (logits, torch.stack(stats)) if collect_moe_aux else logits


def _ring_positions(pos, t: int, group) -> list:
    """Every sp rank's key positions on tp rank t: this process's, or
    across processes each rank's chunk after the one before it."""
    mine = [p[t] for p in pos]
    if group is None or group.size == 1:
        return mine
    first, T = group.index * len(mine), mine[0].shape[-1]
    return [mine[0] + (j - first) * T for j in range(len(mine) * group.size)]


def _sp_layer(units, lay, x, pos, cos, sin, use_flash, flash_kernel, collect_moe_aux,
              group=None):
    """One layer of `sp_forward` over every sp rank (`units`) and tp rank."""
    tp = len(units[0].ranks)
    normed = [u.norm_in(lay[s], x[s]) for s, u in enumerate(units)]
    qkv = [[attention_qkv(u.cfg_r, lay[s][t]["attn"], normed[s][1][t], cos[s][t], sin[s][t])
            for t in range(tp)] for s, u in enumerate(units)]
    ys = [ring_attention([q[t][0] for q in qkv], [q[t][1].transpose(1, 2) for q in qkv],
                         [q[t][2].transpose(1, 2) for q in qkv], [p[t] for p in pos],
                         _ring_positions(pos, t, group), use_flash=use_flash,
                         use_kernel=flash_kernel, group=group)
          for t in range(tp)]
    outs = [u.block_rest(lay[s], x[s], normed[s][0],
                         [attention_out(u.cfg_r, lay[s][t]["attn"], ys[t][s], x[s][t].dtype,
                                        project=False) for t in range(tp)],
                         collect_moe_aux)
            for s, u in enumerate(units)]
    if not collect_moe_aux:
        return outs
    dev = outs[0][1][0].device
    return [h for h, _ in outs], sum(torch.stack(st).to(dev) for _, st in outs)


class SPRanks:
    """The sequence-parallel ranks of one model replica: each rank holds
    the whole weights (`params`, one tree per rank, shared by the ranks of
    one device) and a contiguous chunk of the sequence, with its cache
    shard.  The layer-by-layer runner beside `TPRanks`: ring attention
    needs every rank's K/V of a layer before any rank can finish that
    layer, so `blocks` runs each layer's projections on every rank, then
    the attention over the ranks (`attend`), then each rank's rest of the
    block.  A replicated input (a decode token, the same on every rank)
    runs once per device (`replicated=True`)."""

    def __init__(self, cfg: Config, params: Sequence[Params]):
        self.cfg, self.params = cfg, list(params)
        self.P = len(self.params)
        self.devs = [next(iter(tree_leaves(p))).device for p in self.params]
        self.rep = functools.partial(_replicated, self.devs)
        L = self.params[0]["blocks"]["norm_1"]["weight"].shape[0]
        self._layers = self.rep(lambda r: unbind_layers(self.params[r]["blocks"], L))

    def each(self, replicated: bool):
        """How a per-rank step runs: once per device for a replicated
        input, else once per rank."""
        return self.rep if replicated else (lambda fn: [fn(r) for r in range(self.P)])

    def positions(self, pos: Sequence[torch.Tensor], ropes, replicated=False):
        """Each rank's (cos, sin) at its positions `pos[r]`; the gather
        clamps, since padded bucket positions run past the table."""
        cs = self.each(replicated)(lambda r: gather_rope(ropes[r][0], ropes[r][1], pos[r]))
        return [c for c, _ in cs], [s_ for _, s_ in cs]

    def embed(self, tokens, pos, replicated=False) -> List[torch.Tensor]:
        return self.each(replicated)(
            lambda r: embed(self.cfg, self.params[r], tokens[r], pos[r]))

    def blocks(self, x, cos, sin, attend, replicated=False) -> List[torch.Tensor]:
        """Every layer over the ranks: `x`, `cos`, `sin` per rank;
        `attend(i, qs, ks, vs)` (layer i, each rank's q (B, n_head, T, hs)
        and k, v (B, G, T, hs)) returns each rank's heads' output."""
        cfg, each = self.cfg, self.each(replicated)
        for i in range(len(self._layers[0])):
            lay = [self._layers[r][i] for r in range(self.P)]
            n1 = each(lambda r: _norm(cfg, x[r], lay[r]["norm_1"]))
            qkv = each(lambda r: attention_qkv(cfg, lay[r]["attn"], n1[r], cos[r], sin[r]))
            ys = attend(i, [q for q, _, _ in qkv], [k.transpose(1, 2) for _, k, _ in qkv],
                        [v.transpose(1, 2) for _, _, v in qkv])
            x = each(lambda r: block_finish(
                cfg, lay[r], x[r], n1[r],
                attention_out(cfg, lay[r]["attn"], ys[r], x[r].dtype)))
        return x

    def head(self, x: torch.Tensor, r: int = 0) -> torch.Tensor:
        """The logits of the hidden states `x` through rank r's head."""
        return head(self.cfg, self.params[r], x)

    def forward(self, tokens, input_pos, use_flash=False, flash_kernel=None, remat=False,
                collect_moe_aux=False):
        """The cache-less forward (training and eval): each rank's chunk
        `tokens[r]` (B, T) starting at `input_pos[r]` (B,), ring attention
        with q_pos == k_pos (`sp_forward`, each rank one `TPRanks` of
        tp = 1); each rank's logits (B, T, padded_vocab).  With
        `collect_moe_aux` also the layer-summed aux of the router stats
        summed over the ranks (the whole sequence's, as the JAX package's
        `stats_reduce` psum over sp gives it)."""
        units = [TPRanks(self.cfg, [p]) for p in self.params]
        out = sp_forward(self.cfg, units, tokens, input_pos, use_flash, flash_kernel, remat,
                         collect_moe_aux)
        if not collect_moe_aux:
            return out
        logits, stats = out
        n = sum(t.numel() for t in tokens)
        return logits, sum(moe_aux_loss(self.cfg, st[0], st[1], n) for st in stats)


@functools.lru_cache(maxsize=16)
def _rope_cache_memo(block_size: int, n_elem: int, base: int, ratio: int):
    return build_rope_cache(block_size, n_elem, base, ratio)


def get_rope_cache(cfg: Config, seq_len: Optional[int] = None, device="cpu"):
    """(cos, sin) float32 tables for a config, on `device`."""
    cos, sin = _rope_cache_memo(
        seq_len or cfg.block_size, cfg.rope_n_elem, cfg.rope_base,
        cfg.rope_condense_ratio,
    )
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def init_params(
    cfg: Config,
    seed: int,
    dtype=torch.float32,
    device="cpu",
    n_layer: Optional[int] = None,
    experts: Optional[Tuple[int, int]] = None,
) -> Params:
    """Random weights from `seed` in the JAX package's tree layout:
    normal(0, 0.02), output projections scaled by 1/sqrt(2 * n_layer),
    norms at one, biases at zero.  Drawn on `device` with a
    `torch.Generator` (the values differ from the JAX package's draws).
    A leaf is drawn in float32 and cast, except the MoE expert stacks,
    which are drawn one (layer, expert) matrix at a time into the `dtype`
    stack: a whole float32 draw of Mixtral's (L, E, I, D) would not fit
    beside the weights on one card.  `experts` = (first, count) keeps
    only those experts in the stacks (a process of an ep mesh over
    processes, `parallel.expert.owned_experts`): the others are still
    drawn, one matrix at a time, and dropped, so every kept value is the
    whole tree's."""
    check_supported(cfg)
    L = cfg.n_layer if n_layer is None else n_layer
    D, V, I = cfg.n_embd, cfg.padded_vocab_size, cfg.intermediate_size
    std = 0.02
    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(shape, s=std):
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    def w_stack(shape, s=std):  # (L, E, ...), one (layer, expert) draw at a time
        e0, n = (0, shape[1]) if experts is None else experts
        out = torch.empty((shape[0], n) + shape[2:], dtype=dtype, device=device)
        for i in range(shape[0]):
            for e in range(shape[1]):
                m = torch.randn(shape[2:], generator=gen, device=device)
                if e0 <= e < e0 + n:
                    out[i, e - e0] = m * s
        return out

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def lin(out_d, in_d, s=std, bias=cfg.bias):
        p = {"weight": w((L, out_d, in_d), s)}
        if bias:
            p["bias"] = zeros((L, out_d))
        return p

    def norm_p(lead=(L,)):
        p = {"weight": torch.ones(lead + (D,), dtype=dtype, device=device)}
        if cfg.norm_class_name == "LayerNorm" and cfg.bias:
            p["bias"] = zeros(lead + (D,))
        return p

    attn = {"qkv": lin(cfg.qkv_size, D), "proj": lin(D, cfg.attn_out_size, proj_std)}
    if cfg.mlp_class_name == "GptNeoxMLP":
        mlp = {"fc": lin(I, D), "proj": lin(D, I, proj_std)}
    elif cfg.mlp_class_name == "LLaMAMoE":
        E = cfg.n_expert
        mlp = {
            "gate": {"weight": w((L, E, D))},
            "experts": {
                "fc_1": {"weight": w_stack((L, E, I, D))},
                "fc_2": {"weight": w_stack((L, E, I, D))},
                "proj": {"weight": w_stack((L, E, D, I), proj_std)},
            },
        }
    else:
        mlp = {
            "fc_1": lin(I, D, bias=False),
            "fc_2": lin(I, D, bias=False),
            "proj": lin(D, I, proj_std, bias=False),
        }
    blocks = {"norm_1": norm_p(), "attn": attn, "mlp": mlp}
    if not cfg.shared_attention_norm:
        blocks["norm_2"] = norm_p()
    params: Params = {"wte": {"weight": w((V, D))}, "blocks": blocks, "ln_f": norm_p(())}
    if cfg.pos_embedding == "learned":
        params["wpe"] = {"weight": w((cfg.block_size, D))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": w((V, D))}
        if cfg.lm_head_bias:
            params["lm_head"]["bias"] = zeros((V,))
    elif cfg.lm_head_bias:
        params["lm_head"] = {"bias": zeros((V,))}
    return params


def init_kv_cache(
    cfg: Config,
    batch_size: int,
    max_seq_length: int,
    dtype=torch.bfloat16,
    device="cpu",
    n_layer: Optional[int] = None,
) -> KVCache:
    """Zeroed dense cache for sequential generation: k/v each
    (L, B, G, S, hs)."""
    L = cfg.n_layer if n_layer is None else n_layer
    shape = (L, batch_size, cfg.n_query_groups, max_seq_length, cfg.head_size)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_paged_kv_cache(
    cfg: Config,
    num_blocks: int,
    block_size: int,
    dtype=torch.bfloat16,
    device="cpu",
    n_layer: Optional[int] = None,
) -> KVCache:
    """Pooled block cache for the serving engine: k/v each
    (L, num_blocks, block_size, G, hs) of a floating dtype (float8
    included), or with `dtype="int8"` each the quantized pool `{"q": int8
    (L, num_blocks, block_size, G, hs), "scale": float32 (L, num_blocks,
    G)}`.  Block 0 is the allocator's write-only trash block
    (`serving.kv_pool.KVPool`)."""
    L = cfg.n_layer if n_layer is None else n_layer
    shape = (L, num_blocks, block_size, cfg.n_query_groups, cfg.head_size)
    if dtype == "int8":
        return {
            side: {
                "q": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.zeros(shape[:2] + shape[3:4], device=device),
            }
            for side in ("k", "v")
        }
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(
            f"paged pool dtype {dtype!r}: a floating dtype or 'int8'"
        )
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _layer_pool(pool, i: int):
    """Layer i's slice of a stacked pool: views, so the in-place writes of
    the forward land in the pool."""
    if isinstance(pool, dict):
        return {"q": pool["q"][i], "scale": pool["scale"][i]}
    return pool[i]


def count_params(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def cast_params(params: Params, dtype) -> Params:
    """Cast float leaves; integer leaves (quantized weights) pass through
    untouched."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def param_dtype(params: Params) -> torch.dtype:
    """dtype of the first floating weight leaf, in sorted-key order.  The
    f32 "scale" leaves of quantized linears are skipped: they would win the
    sorted order and silently make KV caches and pools float32."""
    for leaf in _weight_leaves(params):
        if leaf.dtype.is_floating_point:
            return leaf.dtype
    raise ValueError("no floating weight leaves in param tree")


def _weight_leaves(tree: Params):
    if not isinstance(tree, dict):
        yield tree
        return
    for k in sorted(tree):
        if k != "scale":
            yield from _weight_leaves(tree[k])
