"""Megatron sharding rules for tensor-parallel inference and training.

Port of `mdi_llm_tpu/parallel/sharding.py`.  The rule table keeps the
JAX package's PartitionSpec vocabulary, so the two read line by line
side by side: a spec `P(...)` names, per dimension of a leaf, the mesh
axis that splits it or None (replicated).  Where the JAX package hands
the specs to `jax.device_put(..., NamedSharding)` and lets XLA insert the
collectives, the port slices the leaves itself (`shard_params`): each
mesh position gets a tree holding its contiguous slice of every leaf, on
its own device, and the sharded forward (`models/transformer.
sharded_forward`) sums the partial results (`parallel/collectives.py`).

Rules (laid over the layer-stacked tree):

- qkv, fc, fc_1 and fc_2 split their output features on `tp` (column
  parallel): litGPT's fused qkv groups [q * q_per_kv, k, v] per KV group,
  so a contiguous slice of its rows holds whole groups when G % tp == 0;
- the attention and MLP `proj` split their input features on `tp` (row
  parallel); their biases stay whole and are added once, after the sum;
- `wte` and `lm_head` split the vocabulary on `tp`;
- MoE experts split their expert axis on `ep` (default: the `tp` axis);
- norms replicate;
- the serving pool `(L, NB, BS, G, hs)` splits its KV-group axis on `tp`
  (`paged_kv_spec`), the int8 pool's `(L, NB, G)` scales the same axis
  (`paged_kv_scale_spec`), and the block tables replicate
  (`block_table_spec`): the host allocator knows nothing of devices.

A pipeline stage's tree (`partition.split_params`) keeps the layer axis
of every block leaf, so `shard_ranks` slices it under the same rules: the
counterpart of the JAX ring's `adapt_specs_to_tree(..., leading_axes=1)`,
whose extra leading axis is the stage axis the port does not stack.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from mdi_llm_tpu_torch.config import Config

__all__ = [
    "P",
    "param_specs",
    "validate_tp_divisibility",
    "adapt_specs_to_tree",
    "shard_params",
    "split_dims",
    "tp_slice",
    "regroup_w4_row_scales",
    "shard_ranks",
    "batch_spec",
    "paged_kv_spec",
    "paged_kv_scale_spec",
    "block_table_spec",
]


class P(tuple):
    """A PartitionSpec: one mesh axis name (or None) per leading dimension
    of a leaf; dimensions past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def param_specs(
    cfg: Config, tp_axis: Optional[str] = "tp", ep_axis: Optional[str] = None
) -> Dict[str, Any]:
    """PartitionSpec tree matching the params tree.  Every block leaf has a
    leading layer axis (never split).  tp_axis=None: fully replicated."""
    t = tp_axis
    e = ep_axis or tp_axis

    def lin_col(bias: bool):  # output features split
        d = {"weight": P(None, t, None)}
        if bias:
            d["bias"] = P(None, t)
        return d

    def lin_row(bias: bool):  # input features split
        d = {"weight": P(None, None, t)}
        if bias:
            d["bias"] = P(None, None)
        return d

    def norm():
        d = {"weight": P(None, None)}
        if cfg.norm_class_name == "LayerNorm" and cfg.bias:
            d["bias"] = P(None, None)
        return d

    attn = {"qkv": lin_col(cfg.bias), "proj": lin_row(cfg.bias)}
    if cfg.mlp_class_name == "GptNeoxMLP":
        mlp = {"fc": lin_col(cfg.bias), "proj": lin_row(cfg.bias)}
    elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
        mlp = {
            "fc_1": {"weight": P(None, t, None)},
            "fc_2": {"weight": P(None, t, None)},
            "proj": {"weight": P(None, None, t)},
        }
    else:  # LLaMAMoE: experts split over ep
        mlp = {
            "gate": {"weight": P(None, None, None)},
            "experts": {
                "fc_1": {"weight": P(None, e, None, None)},
                "fc_2": {"weight": P(None, e, None, None)},
                "proj": {"weight": P(None, e, None, None)},
            },
        }
    blocks = {"norm_1": norm(), "attn": attn, "mlp": mlp}
    if not cfg.shared_attention_norm:
        blocks["norm_2"] = norm()

    specs: Dict[str, Any] = {
        "wte": {"weight": P(t, None)},
        "blocks": blocks,
        "ln_f": {
            "weight": P(None),
            **({"bias": P(None)} if cfg.norm_class_name == "LayerNorm" and cfg.bias else {}),
        },
    }
    if cfg.pos_embedding == "learned":
        specs["wpe"] = {"weight": P(None, None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"weight": P(t, None)}
        if cfg.lm_head_bias:
            specs["lm_head"]["bias"] = P(t)
    elif cfg.lm_head_bias:
        specs["lm_head"] = {"bias": P(t)}
    return specs


def validate_tp_divisibility(cfg: Config, tp: int, check_vocab: bool = False):
    """Reject configs whose split dimensions do not divide by tp: heads and
    KV groups always; the expert axis of an MoE config, else the
    intermediate dim; the vocabulary where the embedding and head are
    split (`check_vocab`, the Generator)."""
    if tp <= 1:
        return
    moe = cfg.mlp_class_name == "LLaMAMoE"
    dims = [
        ("n_head", cfg.n_head),
        ("n_query_groups", cfg.n_query_groups),
        ("n_expert", cfg.n_expert) if moe
        else ("intermediate_size", cfg.intermediate_size),
    ]
    if check_vocab:
        dims.append(("padded_vocab_size", cfg.padded_vocab_size))
    bad = [name for name, dim in dims if dim % tp]
    if bad:
        raise ValueError(f"tp={tp} does not divide {', '.join(bad)} of {cfg.name}")


def adapt_specs_to_tree(
    specs: Any,
    params: Any,
    leading_axes: int = 0,
    axis_sizes: Optional[Dict[str, int]] = None,
):
    """A `param_specs` tree (standard "weight" leaves) adapted to the
    actual params tree, which may hold quantized layouts (weight_q /
    weight_q8 int8, weight_q4 packed nibbles, + scale; ops/quant.py).  The
    quantized layouts keep the weight's axis order, so one rule covers
    every mode:

    - `weight_q*` takes the weight's spec (int4's packed axis is still the
      contracted input axis);
    - `scale` takes the first `ndim` entries of the weight's spec: a
      per-out-channel scale (L, out) follows a column-parallel weight's
      out split and replicates for a row-parallel one, and int4 group
      scales (L, out, groups) also split their group axis where the
      contracted axis is split.

    `leading_axes` counts extra stacked axes before every leaf's own.
    `axis_sizes` (mesh axis -> size) un-splits any dimension the mesh
    cannot divide: int4's group axis collapses to one group when the
    input dim is at most the group width, and its packed axis is half the
    input dim, so a tp-divisible input dim does not make it divisible."""

    def fit_spec(base, v):
        entries = list(base[: v.dim() - leading_axes])
        if axis_sizes:
            shape = tuple(v.shape)[leading_axes:]
            entries = [
                a if a is None or shape[i] % axis_sizes.get(a, 1) == 0 else None
                for i, a in enumerate(entries)
            ]
        return P(*entries)

    def walk(s_node, p_node):
        if not isinstance(p_node, dict):
            return s_node
        if any(k.startswith("weight_q") for k in p_node):
            base = s_node["weight"]
            out = {}
            for k, v in p_node.items():
                if k == "scale" or k.startswith("weight_q"):
                    out[k] = fit_spec(base, v)
                else:  # bias etc. keep their standard spec
                    out[k] = s_node[k]
            return out
        return {k: walk(s_node[k], v) for k, v in p_node.items()}

    return walk(specs, params)


def _shard_leaf(x: torch.Tensor, spec, coords: Dict[str, int], sizes: Dict[str, int],
               device) -> torch.Tensor:
    """The slice of `x` that the mesh position `coords` holds under `spec`,
    on `device`: dimension i split into sizes[spec[i]] contiguous chunks,
    chunk coords[spec[i]] kept.  A slice on the leaf's own device is a
    view (no copy)."""
    index = []
    for i, axis in enumerate(spec):
        if axis is None or sizes.get(axis, 1) == 1:
            index.append(slice(None))
            continue
        n = x.shape[i] // sizes[axis]
        c = coords[axis]
        index.append(slice(c * n, (c + 1) * n))
    return x[tuple(index)].to(device)


def shard_params(
    params: Any,
    cfg: Config,
    mesh,
    tp_axis: Optional[str] = "tp",
    ep_axis: Optional[str] = None,
) -> Dict[int, Any]:
    """{position: tree} over the mesh's positions, row-major (position p is
    `mesh.devices.flat[p]`): each tree holds the position's slice of every
    leaf under the tp/ep rules, on the position's device.  Quantized trees
    follow `adapt_specs_to_tree`."""
    tp = tp_axis if (tp_axis and tp_axis in mesh.axis_names) else None
    ep = ep_axis if (ep_axis and ep_axis in mesh.axis_names) else None
    sizes = dict(mesh.shape)
    specs = adapt_specs_to_tree(param_specs(cfg, tp, ep), params, axis_sizes=sizes)

    def walk(p_node, s_node, coords, device):
        if isinstance(p_node, dict):
            return {k: walk(v, s_node[k], coords, device) for k, v in p_node.items()}
        return _shard_leaf(p_node, s_node, coords, sizes, device)

    return {
        i: walk(params, specs, coords, dev)
        for i, (coords, dev) in enumerate(zip(mesh.positions(), mesh.device_list()))
    }


def split_dims(cfg: Config, params: Any, tp_axis: str = "tp",
               ep_axis: Optional[str] = None) -> Any:
    """The tree of each leaf's dimension that the tp rules split, None
    where the leaf is replicated over tp (norms, row-parallel biases, the
    MoE router; with `ep_axis`, the experts too: they split over ep)."""
    specs = adapt_specs_to_tree(param_specs(cfg, tp_axis, ep_axis), params)

    def walk(p_node, s_node):
        if isinstance(p_node, dict):
            return {k: walk(v, s_node[k]) for k, v in p_node.items()}
        return s_node.index(tp_axis) if tp_axis in s_node else None

    return walk(params, specs)


def tp_slice(x: torch.Tensor, dim: Optional[int], n: int, i: int) -> torch.Tensor:
    """Slice `i` of `n` contiguous slices of `x` along `dim` (a view; `x`
    itself where `dim` is None or `n` is 1)."""
    if dim is None or n == 1:
        return x
    w = x.shape[dim] // n
    return x.narrow(dim, i * w, w)


def batch_spec(dp_axis: str = "dp", sp_axis: Optional[str] = None) -> P:
    return P(dp_axis, sp_axis)


def paged_kv_spec(tp_axis: Optional[str] = "tp") -> P:
    """The serving pool `(L, num_blocks, block_size, G, hs)`: the KV-group
    axis splits on `tp`, as the dense (L, B, G, S, hs) cache's does, so
    each device holds its group slice of EVERY block and the host-side
    allocator (block ids, free lists, prefix hashes) needs no notion of
    devices.  Needs n_query_groups % tp == 0 (`validate_tp_divisibility`)."""
    return P(None, None, None, tp_axis, None)


def paged_kv_scale_spec(tp_axis: Optional[str] = "tp") -> P:
    """The int8 pool's per-block-per-group scales `(L, num_blocks, G)`:
    the group axis splits on `tp` as the payload's does, so each device
    dequantizes its own group slice with its own scales."""
    return P(None, None, tp_axis)


def block_table_spec() -> P:
    """Block tables ((n_slots, max_blocks) int32) replicate: every device
    resolves the same block ids; only the KV bytes split."""
    return P(None, None)


# the row-parallel linears of a block: (subtree, key); their input axis is split
ROW_PARALLEL = (("attn", "proj"), ("mlp", "proj"))


def regroup_w4_row_scales(params: Any, shards: Dict[int, Any], mesh,
                          tp_axis: str = "tp") -> Dict[int, Any]:
    """Fit each rank's int4 row-parallel scales to its slice, in place.

    An int4 row-parallel weight whose scale-group count the tp size does
    not divide keeps its whole group axis (`adapt_specs_to_tree`) while its
    packed input axis is split, so a rank's input slice may start inside a
    group.  Each such rank's tree gets the scales of its own input
    positions, at the finest group width that both the group width g and
    the rank's input width divide (gcd): every finer group lies inside one
    of the weight's groups and takes its scale, so the product is the
    same.  A packed axis the tp size does not divide (an odd per-rank
    input width) is refused."""
    tp = int(mesh.shape.get(tp_axis, 1))
    if tp == 1:
        return shards
    for sub, key in ROW_PARALLEL:
        full = params["blocks"][sub].get(key)
        if not full or "weight_q4" not in full:
            continue
        in_d, n_g = full["weight_q4"].shape[-1] * 2, full["scale"].shape[-1]
        if n_g % tp == 0:
            continue
        if (in_d // 2) % tp:
            raise NotImplementedError(
                f"int4 {sub}.{key}: an input width of {in_d} over tp={tp} puts "
                "an odd number of input positions on each rank, which splits "
                "the packed nibble pairs; use int8 weights or another tp size"
            )
        g, in_r = in_d // n_g, in_d // tp
        gp = math.gcd(g, in_r)
        for i, coords in enumerate(mesh.positions()):
            start = coords.get(tp_axis, 0) * in_r
            idx = (start + torch.arange(in_r // gp) * gp) // g
            leaf = shards[i]["blocks"][sub][key]
            scale = full["scale"]
            leaf["scale"] = scale.index_select(-1, idx.to(scale.device)).to(
                leaf["weight_q4"].device)
    return shards


def shard_ranks(cfg: Config, tree: Any, devices) -> list:
    """Each tensor-parallel rank's slice of `tree` (the whole model's, or a
    pipeline stage's `partition.split_params` tree), rank r on
    `devices[r]`, in rank order: `shard_params` over a 1-D tp mesh of
    those devices (views where a rank shares the tree's device), then
    `regroup_w4_row_scales`."""
    import numpy as np

    from mdi_llm_tpu_torch.parallel.mesh import Mesh

    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    mesh = Mesh(grid, ("tp",))
    shards = regroup_w4_row_scales(tree, shard_params(tree, cfg, mesh), mesh)
    return [shards[i] for i in range(len(devices))]
