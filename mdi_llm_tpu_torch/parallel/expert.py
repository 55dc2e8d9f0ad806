"""Token-dispatch expert parallelism (ep) over the ranks of an `ep` mesh
axis.

Port of `mdi_llm_tpu/parallel/expert.py`.  The dense formulation
(`models/transformer.moe_forward`) runs every expert on every token; this
is the sparse, sharded one, the GShard/Switch dispatch:

- the experts split over the `ep` ranks, rank e holding experts
  [e * E/ep, (e + 1) * E/ep) (`place_ep`, the JAX `_place_ep_quantized`:
  by position, so quantized layouts need no table of their own);
- the tokens split over the ranks (over dp x ep with `dp_axis`); each
  rank routes its shard (top-k and renormalisation, the dense path's
  arithmetic), packs the tokens into an (E, C, D) buffer of C slots per
  expert, and the buffers are exchanged (`collectives.all_to_all`);
- each rank runs only its E/ep experts, through `quantized_einsum` (the
  dense path's contractions, so int8, w8a8 and int4 expert stacks work
  unchanged), and a second exchange returns the outputs for the weighted
  combine at the tokens' home ranks.

Capacity: `C = max(1, ceil(cf * n_local * k / E))` slots per (expert,
source rank); `capacity_factor=None` gives `C = n_local`, where nothing
is dropped and the output is the dense path's up to rounding.  A finite
factor drops the assignments past C (each contributes nothing, its
router weight lost, as in Switch Transformer); which ones are dropped is
the JAX package's choice, token for token: an assignment's slot is its
rank among the assignments to its expert in the flat (token, k) order.

The JAX package runs the per-rank body inside a `shard_map` over the
mesh's devices.  The port runs the ranks one after another in this
process, each on its mesh position's device: a rank's experts are views
of the expert stacks (copies only for a rank on another device), and the
exchange is index arithmetic on the tensors.  Autograd differentiates
the whole dispatch (the exchange's backward is the reverse exchange), so
this path trains.

Over the processes of a job (`group`, a `collectives.CommGroup` of the
processes that split the ep axis; the mesh a `make_mesh(...,
process_id, num_processes)` one) a process runs the ranks it owns
(`Mesh.owned`, a contiguous range) and holds only their experts
(`owned_experts`; a process draws or loads only those,
`transformer.init_params(experts=)`, `utils.checkpoint.
load_checkpoint(experts=)`, or cuts a whole tree with `local_experts`).
Its input is its dp rows' whole batch, the same on every process of the
group: it routes its ranks' shards, the dispatch and the return cross
processes in one `CommGroup.all_to_all` each per dp row, and the
combined rows of its ranks are all-gathered (`gather_from_ranks`), so
every process goes on with its rows' whole batch.  Under autograd the
layer's input and the router's weights enter through `copy_to_ranks`:
the processes' shares of their gradients are summed there, so
everything outside the experts gets its rows' gradient on every
process, while each expert's gradient (every token of those rows routed
to it) stays on its owner.  The aux's stats are summed over the group.

The layouts this takes, beside the tp ranks a process runs (the group
is then the processes holding the same tp ranks, `training.MeshLayout`
and the `Generator` build it): every ep rank in each process (the
processes split tp only; no exchange crosses them), a range of the ep
ranks with every dp row (`{"ep": 2, "dp": 2}` over two processes, ep
beside a whole tp group, `{"ep": 2, "tp": 2}`), or with the dp axis
split too (`dp_group`: `{"dp": 2, "ep": 2}` over four processes, one
position each): a process then holds its dp rows only, the exchange
stays among the processes of those rows, and the dp group sums the
aux's counts, while the Trainer sums the gradients over it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.ops.quant import EP_DOWN, EP_UP, quantized_einsum
from mdi_llm_tpu_torch.parallel.collectives import (
    CommGroup,
    all_to_all,
    copy_to_ranks,
    gather_from_ranks,
    reduce_from_ranks,
)

__all__ = ["expert_capacity", "ep_moe_forward", "place_ep", "local_experts", "ep_dims",
           "owned_experts", "replicated"]

Params = Any


def expert_capacity(cfg: Config, n_local: int, capacity_factor: Optional[float]) -> int:
    """Per-(expert, source rank) dispatch slots."""
    if capacity_factor is None:
        return max(1, n_local)
    need = capacity_factor * n_local * cfg.n_expert_per_token / cfg.n_expert
    return max(1, math.ceil(need))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def place_ep(params: Params, mesh, n_expert: int, axis: str = "ep") -> Dict[int, Params]:
    """{position: tree} over the mesh's positions, row-major (the JAX
    `_place_ep_quantized`): every leaf of two or more dims under an
    "experts" subtree keeps the position's ep slice of axis 1 (the expert
    axis, after the stacked layer axis), every other leaf whole, each on
    the position's device: views of the one tree where that is the
    tree's device.  By position rather than leaf name, so weight_q /
    scale / weight_q4 layouts need no table; guarded by shape: a layout
    whose axis 1 is not the expert axis is refused, not mis-split."""
    ep = int(mesh.shape[axis])

    def walk(node, in_experts, e, device):
        if isinstance(node, dict):
            return {k: walk(v, in_experts or k == "experts", e, device) for k, v in node.items()}
        if in_experts and node.dim() >= 2:
            if node.shape[1] != n_expert:
                raise ValueError(
                    f"expert-subtree leaf has axis-1 size {node.shape[1]}, expected "
                    f"n_expert={n_expert}; this storage layout needs its own ep "
                    "placement rule")
            n = n_expert // ep
            node = node.narrow(1, e * n, n)
        return node.to(device)

    return {i: walk(params, False, c[axis], torch.device(d))
            for i, (c, d) in enumerate(zip(mesh.positions(), mesh.device_list()))}


def ep_dims(params: Params) -> Params:
    """The tree of each leaf's ep split dimension: 1 (the expert axis
    after the stacked layer axis) for a leaf of two or more dims under an
    "experts" subtree, None for a leaf every ep rank holds whole."""

    def walk(node, in_experts):
        if isinstance(node, dict):
            return {k: walk(v, in_experts or k == "experts") for k, v in node.items()}
        return 1 if in_experts and node.dim() >= 2 else None

    return walk(params, False)


def _owned_ranks(mesh, axis: str) -> List[int]:
    """The `axis` coordinates of the mesh positions this process owns."""
    owned = mesh.owned()
    return sorted({c[axis] for i, c in enumerate(mesh.positions()) if i in owned})


def owned_experts(mesh, n_expert: int, axis: str = "ep") -> Optional[Tuple[int, int]]:
    """(first expert, count) of the experts this process's ep ranks hold
    (`Mesh.owned`, contiguous), or None when it holds every rank."""
    ranks = _owned_ranks(mesh, axis)
    if len(ranks) == int(mesh.shape[axis]):
        return None
    n = n_expert // int(mesh.shape[axis])
    return ranks[0] * n, len(ranks) * n


def local_experts(params: Params, mesh, n_expert: int, axis: str = "ep") -> Params:
    """The tree a process of an ep mesh over processes holds: every leaf
    whole, each expert leaf cut to the experts of the ep ranks it owns
    (`owned_experts`), as a copy, so the whole stacks can go.  A tree that
    already holds only those experts (drawn or loaded so) is kept as it
    is; an expert leaf of any other size on axis 1 is refused."""
    owned = owned_experts(mesh, n_expert, axis)
    if owned is None:
        return params
    start, count = owned

    def cut(x, d):
        if d is None or x.shape[d] == count:
            return x
        if x.shape[d] != n_expert:
            raise ValueError(f"expert-subtree leaf has axis-{d} size {x.shape[d]}: neither "
                             f"n_expert={n_expert} nor this process's {count} experts")
        return x.narrow(d, start, count).clone()

    return _zip_map(cut, params, ep_dims(params))


def replicated(params: Params) -> Params:
    """`params` without its expert stacks (the leaves `ep_dims` splits):
    what every process of an ep mesh over processes holds alike."""
    if not isinstance(params, dict):
        return params
    return {k: replicated(v) for k, v in params.items()
            if not (k == "experts" and isinstance(v, dict))}


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _rank_devices(mesh, axis: str, dp_axis: Optional[str]) -> List[List[torch.device]]:
    """[dp coordinate][ep coordinate] -> the device of that mesh position
    (coordinate 0 on every other axis)."""
    dp = int(mesh.shape[dp_axis]) if dp_axis else 1
    out = [[None] * int(mesh.shape[axis]) for _ in range(dp)]
    for c, d in zip(mesh.positions(), mesh.device_list()):
        if all(v == 0 for a, v in c.items() if a not in (axis, dp_axis)):
            out[c.get(dp_axis, 0) if dp_axis else 0][c[axis]] = torch.device(d)
    return out


def _rank_params(experts: Params, i: int, device, gate: Params) -> Params:
    """The i-th of this process's ranks' part of one layer's MoE params: the
    whole router `gate` and the rank's slice of `experts` (every expert
    leaf split once along its expert axis, a layout `place_ep` accepts:
    the ranks' slices are outputs of one split, so the backward builds one
    full-size gradient per leaf, not one per rank), on `device`."""
    return {"gate": _tree_map(lambda a: a.to(device), gate),
            "experts": _tree_map(lambda a: a[i].to(device), experts)}


def _route(cfg: Config, gate: Params, x: torch.Tensor, valid: torch.Tensor, C: int):
    """One rank's routing of its n tokens `x` (n, D), `valid` (n,) False
    on padding rows (which take no slot and emit nothing): (the (E, C, D)
    dispatch buffer, the slot index expert * C + slot of each (token, k)
    assignment, its combine weight, and the aux's raw stats (pre-drop
    assignments per expert, router probability sums, valid tokens))."""
    n, D = x.shape
    E, k = cfg.n_expert, cfg.n_expert_per_token
    # the dense path's routing (transformer.moe_route)
    router = quantized_einsum("ni,ei->ne", x, gate).float()
    probs = torch.softmax(router, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    flat_e = topi.reshape(-1)  # (n * k,) global expert ids, token-major
    flat_valid = valid[:, None].expand(n, k).reshape(-1)
    flat_w = torch.where(flat_valid, topv.reshape(-1), torch.zeros_like(topv.reshape(-1)))
    # an assignment's slot: its rank among the earlier assignments to its
    # expert in the flat (token, k) order (the JAX cumsum)
    onehot = F.one_hot(flat_e, E) * flat_valid[:, None]
    ranks = onehot.cumsum(dim=0) - onehot
    pos_in_e = ranks.gather(1, flat_e[:, None])[:, 0]
    keep = (pos_in_e < C) & flat_valid
    slot = flat_e * C + pos_in_e.clamp(max=C - 1)
    contrib = keep.to(x.dtype)
    # a dropped or padding assignment adds zeros to a slot
    disp = torch.zeros(E * C, D, dtype=x.dtype, device=x.device).index_add(
        0, slot, x[:, None].expand(n, k, D).reshape(n * k, D) * contrib[:, None])
    w = (flat_w * contrib.float()).to(x.dtype)
    stats = torch.stack([onehot.float().sum(dim=0),
                         (probs * valid[:, None].float()).sum(dim=0),
                         valid.float().sum().expand(E)])
    return disp.reshape(E, C, D), slot, w, stats


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The rank's experts on their slots `buf` (E_loc, M, D): SwiGLU with
    the dense path's expert weights, contracted per expert."""
    pe = p["experts"]
    h1 = quantized_einsum(EP_UP, buf, pe["fc_1"])
    h2 = quantized_einsum(EP_UP, buf, pe["fc_2"])
    return quantized_einsum(EP_DOWN, F.silu(h1) * h2, pe["proj"])


def ep_moe_forward(
    cfg: Config,
    p: Params,
    x: torch.Tensor,  # (B, T, D)
    mesh,
    axis: str = "ep",
    capacity_factor: Optional[float] = None,
    with_aux: bool = False,
    dp_axis: Optional[str] = None,
    group: Optional[CommGroup] = None,
    dp_group: Optional[CommGroup] = None,
):
    """Expert-parallel MoE layer, a drop-in for `transformer.moe_forward`
    (pass it as `moe_impl=` through `transformer.forward`): one layer's
    params `p`, the tokens split over the `axis` ranks of `mesh` (a
    `parallel.mesh.make_mesh` Mesh), the experts dispatched by
    `all_to_all`.  Returns the (B, T, D) output on x's device, or (output,
    aux) with `with_aux`: the load-balancing loss of the dense path's
    formula from the stats summed over every rank.

    `dp_axis` (training on a (dp, ep) mesh): the tokens split over both
    axes, N / (dp * ep) per rank, shard d * ep + e to position (d, e); the
    exchange stays within each dp row, and the aux's stats sum over both
    axes.

    `group` (a mesh over processes): the processes holding this
    process's dp rows' other ep ranks; this process runs its own ranks,
    `p` holding their experts only (the module docstring).  `dp_group`
    (the dp axis split over the processes too): the processes holding the
    other dp rows beside the same ep ranks; `x` then holds this process's
    rows only (its dp coordinates', whose tokens are exactly its ranks'
    shards: B * T divides by dp * ep), and the aux is this process's
    part of the whole batch's: the assignments and token counts summed
    over every process, the router's probabilities over its rows, so that
    the parts sum to the aux over the dp group."""
    ep = int(mesh.shape[axis])
    E = cfg.n_expert
    if E % ep:
        raise ValueError(f"n_expert={E} not divisible by {axis}={ep}")
    dp = int(mesh.shape[dp_axis]) if dp_axis else 1
    B, T, D = x.shape
    mine = range(ep)  # the ep ranks this process runs
    rows = range(dp)  # and the dp rows, x's
    if group is not None and group.size > 1:
        mine = _owned_ranks(mesh, axis)
    if dp_group is not None and dp_group.size > 1:
        rows = _owned_ranks(mesh, dp_axis)
    N = B * T * dp // len(rows)  # the whole batch's tokens
    if len(rows) < dp and N % (dp * ep):
        raise ValueError(f"the dp axis split over the processes: the batch's {N} tokens "
                         f"must divide by dp x {axis} = {dp * ep}, so that each process's "
                         "rows hold its ranks' shards")
    n_loc = -(-N // (dp * ep))
    Np = n_loc * len(rows) * ep  # x's tokens, padded
    C = expert_capacity(cfg, n_loc, capacity_factor)
    E_loc = E // ep
    xf = F.pad(x.reshape(B * T, D), (0, 0, 0, Np - B * T))
    valid = torch.arange(Np, device=x.device) < B * T
    devs = _rank_devices(mesh, axis, dp_axis)
    gate = p["gate"]
    if len(mine) < ep and torch.is_grad_enabled():
        xf = copy_to_ranks(xf, group)
        gate = _tree_map(lambda a: copy_to_ranks(a, group), gate)
    experts = _tree_map(lambda a: a.split(E_loc), p["experts"])  # this process's ranks'
    outs, stats = [], []
    for j, d in enumerate(rows):
        ps = [_rank_params(experts, e - mine[0], devs[d][e], gate) for e in mine]
        routed = []
        for e, pe in zip(mine, ps):
            sl = slice((j * ep + e) * n_loc, (j * ep + e + 1) * n_loc)
            routed.append(_route(cfg, pe["gate"], xf[sl].to(devs[d][e]),
                                 valid[sl].to(devs[d][e]), C))
        # to the experts' owners: experts are owner-major on the leading
        # axis, expert g on rank g // E_loc
        recv = all_to_all([r[0].reshape(ep, E_loc, C, D) for r in routed], group=group)
        outb = [_experts(pe, recv[i].transpose(0, 1).reshape(E_loc, ep * C, D))
                for i, pe in enumerate(ps)]
        # and back: rank e's slots of source j's tokens go to rank j
        back = all_to_all([o.reshape(E_loc, ep, C, D).transpose(0, 1) for o in outb],
                          group=group)
        row = []
        for i, (_disp, slot, w, st) in enumerate(routed):
            y = back[i].reshape(E * C, D)[slot] * w[:, None]
            row.append(y.reshape(n_loc, -1, D).sum(dim=1).to(x.device))
            stats.append(st.to(x.device))
        outs.append(torch.cat(row))
    out = torch.stack(outs)  # (rows, this process's ranks' tokens, D)
    if len(mine) < ep:  # every process goes on with its rows' whole batch
        out = gather_from_ranks(out, 1, group)
    out = out.reshape(Np, D)[:B * T].reshape(B, T, D)
    if not with_aux:
        return out
    total = sum(stats)
    if len(mine) < ep:
        total = reduce_from_ranks(total, group)
    assign, prob_sum, n_valid = total
    if len(rows) < dp:  # the counts of the other processes' rows
        counts = dp_group.all_reduce_(torch.stack([assign, n_valid]).detach().clone())
        assign, n_valid = counts[0], counts[1]
    k = cfg.n_expert_per_token
    f = assign / torch.clamp(n_valid * k, min=1.0)
    pm = prob_sum / torch.clamp(n_valid, min=1.0)
    return out, E * (f * pm).sum()
