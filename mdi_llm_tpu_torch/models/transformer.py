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
large matrix products (`F.linear`).  Mixture-of-experts configs are
refused.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

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
from mdi_llm_tpu_torch.ops.rope import apply_rope, build_rope_cache, gather_rope

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(x, p["weight"], p.get("bias"))


def _norm(cfg: Config, x: torch.Tensor, p: Params) -> torch.Tensor:
    if cfg.norm_class_name == "RMSNorm":
        return rms_norm(
            x, p["weight"], cfg.norm_eps, add_unit_offset=cfg.rmsnorm_add_unit_offset
        )
    return layer_norm(x, p["weight"], p.get("bias"), cfg.norm_eps)


def _gelu(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if cfg.gelu_approximate == "tanh" else "none")


def check_supported(cfg: Config) -> None:
    """Refuse configs whose layers the port does not carry yet."""
    if cfg.mlp_class_name not in ("GptNeoxMLP", "LLaMAMLP", "GemmaMLP"):
        raise ValueError(
            f"{cfg.name}: mlp_class_name={cfg.mlp_class_name!r} is not ported "
            "(mixture-of-experts waits for a later slice, ROADMAP Queue 1)"
        )


def mlp_forward(cfg: Config, p: Params, x: torch.Tensor) -> torch.Tensor:
    kind = cfg.mlp_class_name
    if kind == "GptNeoxMLP":
        return linear(_gelu(cfg, linear(x, p["fc"])), p["proj"])
    if kind == "LLaMAMLP":
        return linear(F.silu(linear(x, p["fc_1"])) * linear(x, p["fc_2"]), p["proj"])
    if kind == "GemmaMLP":
        return linear(_gelu(cfg, linear(x, p["fc_1"])) * linear(x, p["fc_2"]), p["proj"])
    check_supported(cfg)
    raise ValueError(f"unknown mlp_class_name {kind!r}")


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
    fresh_prefill: bool = False,
    use_flash: bool = False,
    flash_kernel: Optional[bool] = None,
) -> torch.Tensor:
    B, T, _ = x.shape
    q, k, v = _split_qkv(cfg, linear(x, p["qkv"]))  # k, v: (B, T, G, hs)
    q = q.transpose(1, 2)  # (B, n_head, T, hs)
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
                use_kernel=paged_kernel,
            )
        else:
            paged_update(k_cache, v_cache, k, v, paged_tables, pos)
            y = paged_attention(
                q, k_cache, v_cache, paged_tables, pos, use_kernel=paged_kernel
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
    y = y.transpose(1, 2).reshape(B, T, cfg.n_head * cfg.head_size)
    return linear(y.to(x.dtype), p["proj"])


def block_forward(cfg, p, x, pos, cos, sin, k_cache, v_cache, **attn) -> torch.Tensor:
    """One transformer block, parallel-residual (GPT-NeoX) or sequential
    (Llama) form; `attn` goes to `attention_forward`."""
    n1 = _norm(cfg, x, p["norm_1"])
    att = attention_forward(cfg, p["attn"], n1, pos, cos, sin, k_cache, v_cache, **attn)
    if cfg.parallel_residual:
        n2 = n1 if cfg.shared_attention_norm else _norm(cfg, x, p["norm_2"])
        return x + att + mlp_forward(cfg, p["mlp"], n2)
    x = x + att
    return x + mlp_forward(cfg, p["mlp"], _norm(cfg, x, p["norm_2"]))


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


def unbind_layers(blocks: Params, L: int) -> list:
    """The L per-layer views of the layer-stacked block tree, one
    `torch.unbind` per leaf: under autograd the layers' gradients then
    come back as one stack per leaf, where indexing `x[i]` would build a
    zero-filled (L, ...) gradient for every layer."""
    views = tree_map(torch.unbind, blocks)  # leaves become L-tuples
    return [tree_map(lambda v: v[i], views) for i in range(L)]


def run_blocks(
    cfg, blocks, x, pos, cos, sin, kv: Optional[KVCache], remat: bool = False, **attn
) -> torch.Tensor:
    """The block stack, layer by layer, over the dense cache, the pooled
    cache or (kv None) none.  `remat` (training, kv None) recomputes each
    block in the backward instead of keeping its activations — the
    counterpart of the JAX package's `jax.checkpoint` around the scanned
    block: activation memory of one layer instead of L."""
    if remat and kv is not None:
        raise ValueError("remat is a training path (kv must be None)")
    L = blocks["norm_1"]["weight"].shape[0]
    layers = unbind_layers(blocks, L)
    for i in range(L):
        if remat:
            # the forward has no randomness, so no RNG state to restore
            x = checkpoint(
                functools.partial(block_forward, cfg), layers[i], x, pos, cos, sin,
                None, None, use_reentrant=False, preserve_rng_state=False, **attn,
            )
        else:
            x = block_forward(
                cfg, layers[i], x, pos, cos, sin,
                None if kv is None else _layer_pool(kv["k"], i),
                None if kv is None else _layer_pool(kv["v"], i),
                **attn,
            )
    return x


def embed(cfg: Config, params: Params, tokens: torch.Tensor, pos: torch.Tensor):
    x = params["wte"]["weight"][tokens.long()]
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
    x = _norm(cfg, x, params["ln_f"])
    w = params["wte"] if cfg.tie_embeddings else params["lm_head"]
    logits = F.linear(x, w["weight"])
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
) -> torch.Tensor:
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
    `remat` recomputes each block in the backward."""
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
    x = run_blocks(cfg, params["blocks"], x, pos, cos, sin, kv, remat=remat, **attn)
    return head(cfg, params, x)


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
) -> Params:
    """Random weights from `seed` in the JAX package's tree layout:
    normal(0, 0.02), output projections scaled by 1/sqrt(2 * n_layer),
    norms at one, biases at zero.  Drawn on `device` with a
    `torch.Generator` (the values differ from the JAX package's draws)."""
    check_supported(cfg)
    L = cfg.n_layer if n_layer is None else n_layer
    D, V, I = cfg.n_embd, cfg.padded_vocab_size, cfg.intermediate_size
    std = 0.02
    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(shape, s=std):
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

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
    """Cast float leaves; integer leaves pass through untouched."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def param_dtype(params: Params) -> torch.dtype:
    """dtype of the first floating leaf, in sorted-key order."""
    if not isinstance(params, dict):
        return params.dtype
    for k in sorted(params):
        dt = param_dtype(params[k])
        if dt.is_floating_point:
            return dt
    raise ValueError("no floating weight leaves in param tree")
