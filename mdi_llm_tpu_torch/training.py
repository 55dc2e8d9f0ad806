"""Training: the pre-training loop, on one device or on a dp/tp/pp mesh.

Port of `mdi_llm_tpu/training.py`: init from scratch or from given
params, AdamW with weight decay masked to weight matrices, a cosine
learning rate with linear warmup, gradient accumulation with the
micro-batch gradients summed in float32, global-norm clipping, periodic
eval with `estimate_loss`, checkpoint-on-best with patience early stop,
and the TFLOP/s estimate of the log lines.

Meshes (`Trainer(mesh=parallel.mesh.make_mesh(axes, devices))`), the
JAX Trainer's dp, tp, dp x tp, GPipe pp / pp x tp, dp x sp (x tp) and
dp x ep (x tp):
- dp: the global batch is sampled as without a mesh; each dp position
  takes its contiguous rows, and the loss is the global mean, so the
  gradients are the unmeshed ones.  tp: each rank runs its slice of every
  layer (`transformer.sharded_forward`, `TPRanks`), with its attention on
  K2-K4 where the flash route is on.  pp: the balanced split of the JAX
  ring (the larger stages last), S micro-batches per dp shard in the
  ring's order (stage s runs micro-batch t - s at micro-step t, embed at
  stage 0, the head and the loss on the last stage's outputs); the
  bubbles and the JAX ring's zero-padded layers compute exact zeros
  there and are skipped here, so no padded layer exists to train.
- sp (the JAX `_sp_loss_fn`): each sp rank holds a contiguous chunk of
  each of its dp rows, its positions from rank * T/sp, and attention
  rides the ring over the sp ranks (`transformer.sp_forward`, each sp
  rank running its tp ranks); the loss is the cross-entropy summed over
  every rank over the global token count, and the MoE aux's router stats
  sum over dp and sp before the aux is formed.  ep: each MoE layer's
  tokens split over the dp x ep ranks and go to their experts by
  all_to_all (`parallel.expert.ep_moe_forward`, at `moe_capacity_factor`),
  the aux's stats summed over both axes, one dispatch a layer over the
  whole batch; attention and the other layers run per dp row, over its
  tp ranks (`transformer.replicas_forward`).  The ranks' expert slices
  are views of the one tree, so a rank's AdamW moments are the same
  slice of the tree's.
- One tree per process (`parallel/sharding.split_dims`): the standard
  layout where the process holds every tp rank (one process: always),
  else its slice of the tp axis; the ranks' trees are views of it, so
  one card keeps one copy of the weights, and AdamW's moments and the
  gradients follow those leaves.  Checkpoints are in the standard layout
  on every mesh, so a run resumes on any other.
- Across processes (`mesh` from `make_mesh(..., process_id,
  num_processes)` after `parallel/nodes.init_distributed`), each process
  holds a contiguous block of positions (`MeshLayout`): dp coordinates,
  and either every stage with contiguous parts of the tp, sp and ep axes,
  or a contiguous range of stages each with its whole tp group (the
  mesh's axes in the order dp, pp, tp).  The tp collectives then run
  through `torch.distributed` under autograd (`parallel/collectives.py`),
  the gradients are summed over the processes that hold the same stages,
  tp and ep slice (other replicas, other sp chunks; once per step, after
  accumulation), the clip's norm counts each leaf once over the groups
  that replicate it, and process 0 writes the checkpoint after a gather.
  Every process samples the same global batch and keeps its dp rows.
- sp over processes: a process runs its ranks' chunks only; each
  layer's K/V chunks pass between the processes under autograd
  (`ring_attention(group=...)`, an all-gather whose backward sums the
  cotangent over them); the loss and the MoE aux's assignments sum over
  the sp processes as over dp.  A process may hold part of each sp
  rank's tp group (`{"dp": 1, "sp": 2, "tp": 2}` over four processes,
  one position each): the ring then runs per tp rank over the processes
  holding that rank (the sp group), the tp partial sums meet in the tp
  group.  ep over processes: a process holds its ranks' expert slices
  only (`parallel.expert.local_experts`; the tree's split leaves,
  gathered for `save` over the ep group as tp slices are over the tp
  group), runs its dp rows' replicated layers over its tp ranks, and
  exchanges its ranks' tokens with the processes holding the other ep
  ranks of those rows (`ep_moe_forward(group=...)`): the gradients
  outside the experts come out whole for its rows on every such process,
  each expert's on its owner.  The layouts: `{"ep": 2, "tp": 2}` over two
  processes (one ep rank with its whole tp group each), `{"tp": 2, "ep":
  2}` (one tp rank with every expert: the experts, whole over tp, are
  replicated leaves there), `{"ep": 2, "dp": 2}` (one ep rank with both
  dp rows) and `{"dp": 2, "ep": 2}` over two (one dp row with every ep
  rank) or four processes (one position each: the tokens split over dp x
  ep as the JAX dispatch's `dp_axis` splits them, the exchange within
  each dp row, the aux's counts and the gradients summed over the dp
  group).  Started by `cli/train.py --mesh ... --coordinator host:port
  --num-processes N --process-id I`, one command per process.
- GPipe stages on other processes: a process holds the layers of its
  stages only (the embedding with stage 0; the final norm and the head,
  and a tied embedding, with the last), runs only those stages in the
  ring's order, and updates only those leaves.  The hop is the Megatron
  schedule: a stage sends its outputs on (`CommGroup.send`); the next
  process receives them as a leaf that requires grad; after the forward
  the last stage differentiates the loss, every other process receives
  the gradients of what it sent, in the order it sent it, and
  differentiates its outputs with them; the gradients of its received
  leaves go back to their sender.  The loss reaches every process (a sum
  over the pp group), the clip's norm sums over it (a tied embedding's
  gradients of stage 0 and the last stage summed first and counted
  once), and `save` gathers every stage's leaves and AdamW moments on
  process 0, in the standard layout.
- `layer_runs` counts each layer a rank of this process runs on a
  micro-batch: on the flash route each launches K2 once (twice with
  remat) and K3 and K4 once.  On an sp mesh a tp rank's layer runs the
  ring's P^2 blocks, each one such run; on an ep mesh the layers run
  once over the whole batch.  `grad_sync_s` sums the host seconds of the
  gradient all-reduce across processes (waiting for the slowest peer
  included).

What differs from the JAX package:
- The flash route on a mesh.  The JAX Trainer refuses `use_flash` on a
  dp/tp/pp mesh (GSPMD cannot partition the Pallas call) and runs those
  meshes on its dense route; the port's ranks run their own layer code,
  so a mesh takes the unmeshed gate below.  Losses differ by rounding.
- MoE configs train with the load-balancing aux weighted by
  `moe_aux_weight` (its router statistics summed over the dp shards
  before the aux is formed, the JAX package's whole-batch aux), in the
  dense formulation (`transformer.moe_forward`) except on an ep mesh;
  `moe_capacity_factor` acts only on an ep mesh's dispatch.  Eval is pure
  cross-entropy, as the JAX Trainer's.
- ep beside tp (`{"ep": N, "tp": M}`, `{"dp": D, "ep": N, "tp": M}`, in
  one process or over processes) keeps the experts whole over tp, as the
  JAX Trainer lays them (`param_specs(tp, ep_axis="ep")`).  ep beside sp
  or pp is refused in the JAX Trainer's words.
- The optimizer is written out (`AdamW`) with optax's arithmetic:
  `clip_by_global_norm` divides by the norm itself (torch's
  `clip_grad_norm_` adds 1e-6), the moments are float32, the update of
  step n uses `lr_schedule(n)` counted from 0, and bfloat16 params are
  updated in float32 and rounded once.
- With `use_flash`, attention runs through the autograd Functions of
  `ops/flash.py`: K2 forward with the LSE, K3 and K4 in the backward.
  `remat` recomputes each block in the backward (`torch.utils.checkpoint`),
  so K2 runs twice per layer and micro-batch and K3, K4 once.
- Checkpoints are the port's own files: `params.pt` and
  `model_config.yaml` (`utils/checkpoint.save_checkpoint`, read back by
  `load_checkpoint`), `opt_state.pt` (`torch.save`) and
  `train_state.json` with the JAX package's keys.
- Random init draws from a `torch.Generator` (`transformer.init_params`),
  so a scratch run starts from other numbers than the JAX package's; the
  parity tests hand both the same params.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.parallel.collectives import CommGroup
from mdi_llm_tpu_torch.parallel.mesh import Mesh
from mdi_llm_tpu_torch.parallel.sharding import (
    split_dims,
    tp_slice,
    validate_tp_divisibility,
)
from mdi_llm_tpu_torch.utils import data_loader
from mdi_llm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NORMS = frozenset({"norm_1", "norm_2", "ln_f"})


@dataclass
class TrainingConfig:
    """Hyper-parameters (the JAX package's `TrainingConfig`)."""

    batch_size: int = 8
    block_size: Optional[int] = None  # None → cfg.block_size
    grad_acc_steps: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 1e-1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    decay_lr: bool = True
    warmup_iters: int = 2000
    lr_decay_iters: int = 600000
    min_lr: float = 6e-5
    max_iters: int = 600000
    eval_iters: int = 20
    ckpt_interval: int = 1000
    log_interval: int = 10
    patience: int = 5
    seed: int = 10137
    dtype: str = "bfloat16"  # params/compute dtype
    remat: bool = True
    # attention through K2 forward + the K3/K4 backward (ops/flash.py)
    # instead of the dense torch route; None → CUDA and block_size >= 2048
    use_flash: Optional[bool] = None
    # MoE: the load-balancing aux weight (0 for dense configs, as in the
    # JAX package); the capacity factor of an ep mesh's token dispatch
    # (None: exact, no dropped assignment; ignored without an ep axis)
    moe_aux_weight: float = 0.01
    moe_capacity_factor: Optional[float] = None


def get_lr(it: int, tc: TrainingConfig) -> float:
    """Cosine schedule with linear warmup."""
    if not tc.decay_lr:
        return tc.learning_rate
    if it < tc.warmup_iters:
        return tc.learning_rate * it / tc.warmup_iters
    if it > tc.lr_decay_iters:
        return tc.min_lr
    ratio = (it - tc.warmup_iters) / (tc.lr_decay_iters - tc.warmup_iters)
    coeff = 0.5 * (1.0 + np.cos(np.pi * ratio))
    return tc.min_lr + coeff * (tc.learning_rate - tc.min_lr)


def lr_schedule(tc: TrainingConfig):
    """Twin of `get_lr` in float32, as the JAX package's optax schedule
    computes it: a function of the update count (the constant learning rate
    when `decay_lr` is off)."""
    if not tc.decay_lr:
        return tc.learning_rate
    f = np.float32

    def sched(count):
        it = f(count)
        warm = f(tc.learning_rate) * it / f(max(tc.warmup_iters, 1))
        ratio = (it - f(tc.warmup_iters)) / f(max(tc.lr_decay_iters - tc.warmup_iters, 1))
        ratio = np.clip(ratio, f(0.0), f(1.0))
        coeff = f(0.5) * (f(1.0) + np.cos(f(np.pi) * ratio))
        cos_lr = f(tc.min_lr) + coeff * (f(tc.learning_rate) - f(tc.min_lr))
        return warm if it < tc.warmup_iters else cos_lr

    return sched


def cross_entropy_loss(
    cfg: Config, params, tokens, targets, remat=True, use_flash=False,
    flash_kernel: Optional[bool] = None, moe_aux_weight: float = 0.0, moe_impl=None,
) -> torch.Tensor:
    """Mean next-token CE in float32 over the padded vocabulary (the
    padding columns only enter the softmax normalizer).  `moe_aux_weight`
    > 0 adds that weight times the layer-mean load-balancing aux of an
    LLaMAMoE config; `moe_impl` runs its MoE layers instead of the dense
    formulation (`parallel.expert.ep_moe_forward` on an ep mesh)."""
    B = tokens.shape[0]
    collect = moe_aux_weight > 0 and cfg.mlp_class_name == "LLaMAMoE"
    out = transformer.forward(
        cfg, params, tokens, torch.zeros(B, dtype=torch.long, device=tokens.device),
        remat=remat, use_flash=use_flash, flash_kernel=flash_kernel,
        collect_moe_aux=collect, moe_impl=moe_impl,
    )
    logits = out[0] if collect else out
    loss = F.cross_entropy(logits.float().flatten(0, 1), targets.flatten().long())
    if collect:
        loss = loss + moe_aux_weight * out[1] / cfg.n_layer
    return loss


def decay_mask(params) -> dict:
    """True where AdamW decays the leaf: `weight` leaves of two or more
    dims outside the norm subtrees.  The stacked layout makes per-layer
    norm weights and biases 2-D, so the rule goes by path, not by ndim
    alone (the JAX package's `leaf_mask`)."""

    def walk(tree, keys):
        return {
            k: walk(v, keys | {k}) if isinstance(v, dict)
            else k == "weight" and v.dim() >= 2 and not (keys | {k}) & NORMS
            for k, v in tree.items()
        }

    return walk(params, frozenset())


class AdamW:
    """`make_optimizer` of the JAX package: optax's
    `chain(clip_by_global_norm(grad_clip), adamw(lr_schedule, b1, b2,
    weight_decay, mask=decay_mask))`, step for step in float32.  The
    moments are float32, one per param leaf in `transformer.tree_leaves`
    order."""

    def __init__(self, tc: TrainingConfig, params):
        self.tc = tc
        self.lr = lr_schedule(tc)
        self.count = 0
        self.decay = transformer.tree_leaves(decay_mask(params))
        leaves = transformer.tree_leaves(params)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update to the `params` leaves in place; `grads` are the
        float32 gradients (clipped in place) and `norm` their global norm
        (default: over `grads`; a mesh's slices need the norm of the whole
        tree)."""
        tc = self.tc
        if norm is None:
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        if not bool(norm < tc.grad_clip):
            for g in grads:
                g.div_(norm).mul_(tc.grad_clip)
        lr = self.lr(self.count) if callable(self.lr) else tc.learning_rate
        self.count += 1
        f = np.float32
        bc1 = float(f(1.0) - f(tc.beta1) ** f(self.count))
        bc2 = float(f(1.0) - f(tc.beta2) ** f(self.count))
        for p, g, mu, nu, decay in zip(params, grads, self.mu, self.nu, self.decay):
            mu.mul_(tc.beta1).add_(g, alpha=1.0 - tc.beta1)
            nu.mul_(tc.beta2).addcmul_(g, g, value=1.0 - tc.beta2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(1e-8))
            if decay:
                u.add_(p * tc.weight_decay)  # the decay term in p's dtype, as optax
            u.mul_(-float(lr))
            p.copy_(u.add_(p))  # p + u in float32, rounded once to p's dtype

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for mine, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for x, y in zip(mine, saved, strict=True):
                x.copy_(y)


def estimate_flops_per_token(cfg: Config, T: int) -> float:
    """PaLM-style estimate: 6N + 12·L·H·hs·T."""
    N = cfg.estimate_params()
    return 6.0 * N + 12.0 * cfg.n_layer * cfg.n_head * cfg.head_size * T


TRAIN_AXES = ("dp", "tp", "pp", "sp", "ep")


class MeshLayout:
    """How a training mesh's positions fall on this process.

    Sizes `dp`, `tp`, `pp`, `sp`, `ep` (1 where the mesh lacks the axis); this
    process's dp coordinates `dp_coords`, its stages `stages` (a range
    (s0, s1) of the pp axis), its tp coordinates `tp_start`, `tp_start
    + tp_local`, its sp ranks `sp_start`, `sp_start + sp_local` and its ep
    ranks `ep_start`, `ep_start + ep_local`.  The
    `parallel.collectives.CommGroup`s, each None when this process holds
    the whole axis: `tp_group`, the processes holding the other tp ranks
    of its stages and replicas; `dp_group`, those holding the same stages,
    tp and ep ranks of the other replicas and the other sp chunks (the
    gradients, the loss and the aux's assignments sum over it);
    `pp_group`, those holding the other stages of its replica and tp
    ranks, in stage order (`pp_stages` their stage ranges); `sp_group`,
    those holding the other sp ranks of its replicas (the ring);
    `ep_group`, those holding the other ep ranks (the expert exchange);
    `tie_group` (with `tie`, the tied embedding) the first and last of
    the pp group.  Every process builds every group, in one order.

    A process holds dp coordinates and either every stage with contiguous
    parts of the tp, sp and ep axes (any of them split over the processes
    beside the others: ep beside tp or dp, sp beside a split tp group), or
    a contiguous range of stages each with its whole tp group (the mesh's
    axes then in the order dp, pp, tp)."""

    def __init__(self, mesh: Mesh, tie: bool = False):
        for axis, size in mesh.shape.items():
            if axis not in TRAIN_AXES:
                raise ValueError(f"mesh axis {axis!r} (size {size}): a training mesh "
                                 f"has the axes {TRAIN_AXES}")
        self.dp, self.tp, self.pp, self.sp, self.ep = (int(mesh.shape.get(a, 1))
                                                       for a in TRAIN_AXES)
        coords = list(mesh.positions())
        spans = [self._span(mesh, coords, p) for p in range(mesh.num_processes)]
        (self.dp_coords, self.stages, (self.tp_start, self.tp_local),
         (self.sp_start, self.sp_local), (self.ep_start, self.ep_local)) = spans[mesh.process_id]
        self.tp_group = self.dp_group = self.pp_group = self.tie_group = None
        self.sp_group = self.ep_group = None
        self.pp_stages = [self.stages]
        if mesh.num_processes == 1:
            return
        # per kind of group: {what its members share: [(where they differ, process)]}
        tables: Dict[str, Dict[tuple, list]] = {k: {} for k in ("tp", "dp", "pp", "sp", "ep")}
        for p, (dps, sts, tp, sp, ep) in enumerate(spans):
            tables["tp"].setdefault((dps, sts, sp, ep), []).append((tp, p))
            tables["dp"].setdefault((sts, tp, ep), []).append(((sp, dps), p))
            tables["pp"].setdefault((dps, tp, sp, ep), []).append((sts, p))
            tables["sp"].setdefault((dps, sts, tp, ep), []).append((sp, p))
            tables["ep"].setdefault((dps, sts, tp, sp), []).append((ep, p))
        for kind, size in (("tp", self.tp), ("sp", self.sp), ("ep", self.ep)):
            for key, members in tables[kind].items():
                starts = sorted(a for (a, _), _ in members)
                if starts != list(range(0, size, members[0][0][1])):
                    raise ValueError(f"the processes holding {key} do not hold each {kind} "
                                     f"rank once: {members}")
        for key, members in tables["dp"].items():
            held = sorted((d, s) for ((s0, k), dps), _ in members
                          for d in dps for s in range(s0, s0 + k))
            if held != [(d, s) for d in range(self.dp) for s in range(self.sp)]:
                raise ValueError(f"the processes holding stages, tp and ep ranks {key} do not "
                                 f"hold each dp coordinate and sp rank once: {members}")
        for key, members in tables["pp"].items():
            edges = sorted(members)
            if [a for (a, _), _ in edges] != [0] + [b for (_, b), _ in edges[:-1]] \
                    or edges[-1][0][1] != self.pp:
                raise ValueError(f"the processes holding dp coordinates and tp ranks {key} "
                                 f"do not hold each stage once: {members}")
        # every process builds every group, in one order
        for kind in ("tp", "dp", "pp", "sp", "ep"):
            for key in sorted(tables[kind]):
                ranks = [p for _, p in sorted(tables[kind][key])]
                if len(ranks) == 1:
                    continue
                group = CommGroup(ranks)
                if mesh.process_id in ranks:
                    setattr(self, f"{kind}_group", group)
                    if kind == "pp":
                        self.pp_stages = [sts for sts, _ in sorted(tables[kind][key])]
                if kind == "pp" and tie:
                    tied = CommGroup([ranks[0], ranks[-1]])
                    if mesh.process_id in tied.ranks:
                        self.tie_group = tied

    def _span(self, mesh: Mesh, coords, p: int):
        """Process p's (dp coordinates, (first stage, end), and (start,
        count) of its tp, sp and ep ranks)."""
        own = [coords[i] for i in mesh.owned(p)]
        dps = tuple(sorted({c.get("dp", 0) for c in own}))
        sts = sorted({c.get("pp", 0) for c in own})
        held = {a: sorted({c.get(a, 0) for c in own}) for a in ("tp", "sp", "ep")}
        where = f"process {p} of {mesh.num_processes} holds the mesh positions {own}"
        size = {"tp": self.tp, "sp": self.sp, "ep": self.ep}
        if (len(own) != len(dps) * len(sts) * math.prod(len(v) for v in held.values())
                or sts != list(range(sts[0], sts[-1] + 1))
                or any(v != list(range(v[0], v[-1] + 1)) or size[a] % len(v)
                       for a, v in held.items())):
            raise ValueError(
                f"{where}: a process holds whole dp coordinates, a contiguous range of "
                "stages and contiguous parts of the tp, sp and ep axes (order the mesh's "
                "axes dp, pp, sp, ep, tp)")
        tps = held["tp"]
        if len(sts) < self.pp:
            names = [a for a in mesh.axis_names if mesh.shape[a] > 1]
            if names != [a for a in ("dp", "pp", "tp") if a in names]:
                raise ValueError(
                    f"{where}: a process that holds part of the pp axis needs the mesh's "
                    f"axes in the order dp, pp, tp (got {names}), so that it holds one "
                    "replica's consecutive stages and passes their activations to the "
                    "process of the next ones")
            if len(tps) != self.tp:
                raise ValueError(
                    f"{where}: a process that holds part of the pp axis holds each of its "
                    "stages with the whole tp group (a stage hop between processes that "
                    "each hold part of a tp group is not ported)")
        return (dps, (sts[0], sts[-1] + 1),
                *((v[0], len(v)) for v in (held["tp"], held["sp"], held["ep"])))

    @property
    def split_stages(self) -> bool:
        """Whether the pp axis is split over processes."""
        return self.pp_group is not None

    def shard(self, axis: str) -> Tuple[int, int]:
        """How this process's tree is cut over `axis` ("tp" or "ep"): (the
        number of slices, its slice)."""
        size, start, local = (getattr(self, axis), getattr(self, f"{axis}_start"),
                              getattr(self, f"{axis}_local"))
        return size // local, start // local


def mesh_experts(mesh: Optional[Mesh], cfg: Config) -> Optional[Tuple[int, int]]:
    """(first expert, count) that a process of `mesh` holds when the mesh's
    ep axis splits an MoE config's experts over the processes
    (`parallel.expert.owned_experts`), else None: the whole stacks."""
    if (mesh is None or mesh.num_processes == 1 or mesh.shape.get("ep", 1) == 1
            or cfg.mlp_class_name != "LLaMAMoE"):
        return None
    from mdi_llm_tpu_torch.parallel.expert import owned_experts

    return owned_experts(mesh, cfg.n_expert)


def _zip_tree(fn, tree, other):
    """`fn(leaf, other's leaf)` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _with_leaves(tree, leaves):
    """`tree`'s structure holding `leaves` (in `transformer.tree_leaves`
    order)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


class Trainer:
    """The trainer, on one device or on a dp/tp/pp mesh (the module
    docstring).

    `device` None means CUDA (and raises without a GPU), or the mesh's
    device; pass "cpu" to run on the CPU.  `flash_kernel=False` sends the
    flash route through the plain versions of K2-K4 on any device (the
    on-card parity check)."""

    def __init__(
        self,
        cfg: Config,
        tc: TrainingConfig,
        mesh: Optional[Mesh] = None,
        params: Optional[Any] = None,
        out_dir: Optional[Path] = None,
        device=None,
        flash_kernel: Optional[bool] = None,
    ):
        transformer.check_supported(cfg)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh={mesh!r}: pass a parallel.mesh.make_mesh Mesh")
        self.mesh = mesh
        self.layout = None if mesh is None else MeshLayout(mesh, tie=cfg.tie_embeddings)
        if mesh is not None:
            here = {torch.device(mesh.device_list()[i]) for i in mesh.owned()}
            if len(here) > 1:
                raise ValueError(f"{mesh}: a training mesh puts every position of a "
                                 "process on its one device (one process per card)")
            first = resolve_device(here.pop())
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device={device!r} is not the mesh's device {first}")
            device = first
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.block_size = int(tc.block_size or cfg.block_size)
        self.out_dir = Path(out_dir) if out_dir else None
        self.iter_num = 0
        self.best_val_loss = float("inf")
        # the JAX gate with the TPU read as CUDA: the dense route wins below
        # 2048 there, and the threshold is kept until this card measures it
        # (on a mesh too: the module docstring)
        self.use_flash = (
            self.device.type == "cuda" and self.block_size >= 2048
            if tc.use_flash is None
            else bool(tc.use_flash)
        )
        self.flash_kernel = flash_kernel
        # the aux term applies to MoE configs only, as in the JAX package
        self.moe_aux_weight = tc.moe_aux_weight if cfg.mlp_class_name == "LLaMAMoE" else 0.0
        self.layer_runs = 0
        self.grad_sync_s = 0.0
        if self.layout is not None:
            self._check_mesh()
        dtype = DTYPES[tc.dtype]
        # the ep axis split over the processes: this process's experts only,
        # drawn so, or cut from the tree it is given (`mesh_experts`)
        experts = mesh_experts(mesh, cfg)
        if params is None:
            params = transformer.init_params(cfg, tc.seed, dtype=dtype, device=self.device,
                                             experts=experts)
        else:
            if experts is not None:
                from mdi_llm_tpu_torch.parallel.expert import local_experts

                params = local_experts(params, mesh, cfg.n_expert)
            # a private copy: the optimizer updates the params in place
            params = transformer.tree_map(
                lambda x: x.detach().to(device=self.device, dtype=dtype, copy=True),
                params,
            )
        # the whole standard tree's shapes; each leaf's tp split dimension
        # (the experts whole over tp beside an ep axis) and, with the ep
        # axis split over the processes, its ep one (the experts')
        ep_mesh = mesh is not None and mesh.shape.get("ep", 1) > 1
        dims = split_dims(cfg, params, ep_axis="ep" if ep_mesh else None)
        if experts is not None:
            from mdi_llm_tpu_torch.parallel.expert import ep_dims, replicated

            e_dims = ep_dims(params)
            self._meta = _zip_tree(lambda x, d: torch.empty(
                x.shape[:1] + (cfg.n_expert,) + x.shape[2:] if d is not None else x.shape,
                dtype=x.dtype, device="meta"), params, e_dims)
        else:
            e_dims = transformer.tree_map(lambda x: None, params)
            self._meta = transformer.tree_map(lambda x: torch.empty_like(x, device="meta"),
                                              params)
        self._dims = transformer.tree_leaves(self._stage_tree(dims))
        self._ep_dims = transformer.tree_leaves(self._stage_tree(e_dims))
        if self.layout is not None and mesh.num_processes > 1:
            import torch.distributed as dist

            from mdi_llm_tpu_torch.parallel import nodes

            # every process must start from the same weights (its own
            # experts aside)
            nodes.check_params_consistency(
                params if experts is None else replicated(params), nodes.RingGroup(
                    dist.get_rank(), dist.get_world_size(), dist.get_backend(), self.device))
            params = self._to_local_tree(params)
        transformer.tree_map(lambda x: x.requires_grad_(True), params)
        self.params = params
        self.optimizer = AdamW(tc, params)
        # with the pp axis split: the tied embedding's leaf index, and the
        # activations this micro-batch received and sent (`_micro_grads`)
        self._wte_index = None
        if self.layout is not None and self.layout.tie_group is not None:
            index = _with_leaves(params, range(len(self._dims)))
            self._wte_index = index["wte"]["weight"]
        self._pp_io: tuple = ([], [])

    # ------------------------------------------------------------------
    # the mesh's layout
    # ------------------------------------------------------------------

    def _check_mesh(self) -> None:
        """The JAX constructor's checks (`mdi_llm_tpu/training.py`), in its
        words."""
        lay, cfg, tc = self.layout, self.cfg, self.tc
        axes = self.mesh.axis_names
        if "ep" in axes:
            if cfg.mlp_class_name != "LLaMAMoE":
                raise ValueError(f"'ep' mesh axis needs an MoE config; {cfg.name} has "
                                 f"mlp_class_name={cfg.mlp_class_name!r}")
            if "sp" in axes or "pp" in axes:
                raise ValueError("ep composes with dp only (ep×sp/pp: future work)")
            if cfg.n_expert % lay.ep:
                raise ValueError(f"n_expert={cfg.n_expert} not divisible by ep={lay.ep}")
            if len(lay.dp_coords) < lay.dp and tc.batch_size // lay.dp * self.block_size % lay.ep:
                raise ValueError(
                    f"the dp axis split over the processes beside ep={lay.ep}: a dp row's "
                    f"{tc.batch_size // lay.dp} x {self.block_size} tokens must divide by ep, "
                    "so that each process's rows hold its ep ranks' shards of the dispatch")
        if "pp" in axes and "sp" in axes:
            raise ValueError("pp composes with dp/tp only (pp×sp: future work)")
        if self.block_size % lay.sp:
            raise ValueError(f"block_size {self.block_size} must divide by sp={lay.sp}: each "
                             "sp rank takes a contiguous chunk of every row")
        if lay.tp > 1:
            validate_tp_divisibility(cfg, lay.tp)
        if lay.pp > 1:
            S = lay.pp
            # balanced split (NOT the inference table): the larger stages last
            base, rem = divmod(cfg.n_layer, S)
            self.pp_counts = [base + (1 if s >= S - rem else 0) for s in range(S)]
            self.pp_starts = np.cumsum([0] + self.pp_counts).tolist()
            if tc.batch_size % (lay.dp * S):
                raise ValueError(
                    f"pp training microbatches each dp shard over the stages: "
                    f"batch_size {tc.batch_size} must divide by dp×pp={lay.dp * S}"
                )
            if self.moe_aux_weight:
                print(
                    "warning: moe_aux_weight is not applied on pp training "
                    "meshes (MoE trains dense, pure CE there); set "
                    "moe_aux_weight=0 to silence",
                    file=sys.stderr,
                )
                self.moe_aux_weight = 0.0
        elif tc.batch_size % lay.dp:
            raise ValueError(f"batch_size {tc.batch_size} must divide by dp={lay.dp}: each "
                             "dp position takes its contiguous rows")

    def _stage_tree(self, tree, stages=None):
        """The part of a standard-layout `tree` (tensors, or any leaves) that
        the stages `stages` (default: this process's) hold: their layers'
        slice of every block leaf, the embedding with stage 0, the final
        norm and the head (and a tied embedding) with the last stage."""
        lay = self.layout
        if lay is None or lay.pp == 1:
            return tree
        s0, s1 = lay.stages if stages is None else stages
        if (s0, s1) == (0, lay.pp):
            return tree
        unknown = set(tree) - {"wte", "wpe", "blocks", "ln_f", "lm_head"}
        if unknown:
            raise ValueError(f"parameter tree keys {sorted(unknown)}: no stage holds them")
        keep = set()
        if s0 == 0:
            keep |= {"wte", "wpe"}
        if s1 == lay.pp:
            keep |= {"ln_f", "lm_head"} | ({"wte"} if self.cfg.tie_embeddings else set())
        a, b = self.pp_starts[s0], self.pp_starts[s1]
        out = {k: v for k, v in tree.items() if k in keep}
        out["blocks"] = transformer.tree_map(
            lambda x: x[a:b] if isinstance(x, torch.Tensor) else x, tree["blocks"])
        return out

    @property
    def _split(self) -> bool:
        """Whether this process holds part of the tree."""
        lay = self.layout
        return lay is not None and (lay.tp_local < lay.tp or lay.ep_local < lay.ep
                                    or lay.stages != (0, lay.pp))

    def _local(self, leaves) -> List[torch.Tensor]:
        """This process's part of the whole tree's standard-layout
        `leaves`: its stages, its tp slice of the leaves the tp axis splits
        and its ep slice of the experts (copies; expert leaves that hold
        only its experts already are kept)."""
        lay = self.layout
        leaves = transformer.tree_leaves(self._stage_tree(_with_leaves(self._meta, leaves)))
        metas = transformer.tree_leaves(self._stage_tree(self._meta))
        out = []
        for x, m, d, e in zip(leaves, metas, self._dims, self._ep_dims):
            if e is not None and x.shape[e] == m.shape[e]:
                x = tp_slice(x, e, *lay.shard("ep"))
            elif e is None:
                x = tp_slice(x, d, *lay.shard("tp"))
            out.append(x.clone())
        return out

    def _to_local_tree(self, params):
        if not self._split:
            return params
        return _with_leaves(self._stage_tree(self._meta),
                            self._local(transformer.tree_leaves(params)))

    def _standard(self, leaves) -> List[torch.Tensor]:
        """`leaves` of this process's tree in the standard layout (collective
        over the tp and ep groups, `_gathered`)."""
        if self.layout is None:
            return list(leaves)
        return [self._gathered(i, x) for i, x in enumerate(leaves)]

    def _gathered(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf `i` of this process's tree, `x`, in the standard layout: an
        expert leaf gathered over the ep group that splits it, a leaf the
        tp axis splits over the tp group, any other as it is (collective
        over the group that gathers it)."""
        lay, d, e = self.layout, self._dims[i], self._ep_dims[i]
        if e is not None:
            return lay.ep_group.all_gather(x.detach(), e)
        if d is not None and lay.tp_group is not None:
            return lay.tp_group.all_gather(x.detach(), d)
        return x

    def _whole(self, leaves, dtype=None) -> Optional[List[torch.Tensor]]:
        """The whole tree's standard-layout leaves from this process's
        `leaves` (of `dtype`, default the params'): gathered over the tp
        group, then over the pp group on process 0 (the others get None;
        collective over both groups)."""
        leaves = self._standard(leaves)
        lay = self.layout
        if lay is None or not lay.split_stages:
            return leaves
        pp = lay.pp_group
        if pp.ranks[0] != 0:  # another replica's stages: process 0 has its own
            return None
        if pp.index > 0:
            for x in leaves:
                pp.send(x.detach(), 0)
            return None
        trees = [_with_leaves(self.params, leaves)]
        for j in range(1, pp.size):
            part = self._stage_tree(self._meta, lay.pp_stages[j])
            trees.append(_with_leaves(part, [pp.recv(m.shape, dtype or m.dtype, self.device, j)
                                             for m in transformer.tree_leaves(part)]))
        whole = {k: next(t[k] for t in trees if k in t) for k in self._meta if k != "blocks"}
        whole["blocks"] = _with_leaves(self._meta["blocks"], [
            torch.cat(parts) for parts in zip(*(transformer.tree_leaves(t["blocks"])
                                                for t in trees))])
        return transformer.tree_leaves(whole)

    def _standard_params(self):
        """The params in the standard layout, whatever the mesh (None on a
        process other than 0 when the pp axis is split)."""
        leaves = self._whole(transformer.tree_leaves(self.params))
        return None if leaves is None else _with_leaves(self._meta, leaves)

    def _rank_trees(self) -> List[Any]:
        """Each of this process's tp ranks' trees: views of `self.params`."""
        k = self.layout.tp_local
        leaves = transformer.tree_leaves(self.params)
        return [_with_leaves(self.params,
                             [tp_slice(x, d, k, r) for x, d in zip(leaves, self._dims)])
                for r in range(k)]

    # ------------------------------------------------------------------

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _loss(self, x, y, remat: bool, aux_weight: Optional[float] = None) -> torch.Tensor:
        """The loss of a batch: without a mesh the unmeshed
        `cross_entropy_loss`; on a mesh this process's part of it
        (`_mesh_loss`)."""
        w = self.moe_aux_weight if aux_weight is None else aux_weight
        if self.layout is not None:
            return self._mesh_loss(x, y, remat, w)
        return cross_entropy_loss(
            self.cfg, self.params, x, y, remat=remat, use_flash=self.use_flash,
            flash_kernel=self.flash_kernel, moe_aux_weight=w,
        )

    def _mesh_loss(self, x, y, remat: bool, aux_weight: float) -> torch.Tensor:
        """This process's part of the global loss of the batch (x, y): the
        cross-entropy summed over its dp positions' rows, over the
        batch's whole token count, plus its part of the aux (the router's
        assignments summed over every dp shard, its own probabilities);
        summed over the dp group it is the unmeshed loss."""
        cfg, lay = self.cfg, self.layout
        if lay.ep > 1:
            return self._ep_loss(x, y, remat, aux_weight)
        B, T = x.shape
        rows = B // lay.dp
        collect = aux_weight > 0
        ranks = transformer.TPRanks(cfg, self._rank_trees(), lay.tp_group)
        ce, stats = torch.zeros((), device=self.device), 0.0
        for d in lay.dp_coords:
            xd, yd = x[d * rows:(d + 1) * rows], y[d * rows:(d + 1) * rows]
            if lay.sp > 1:
                # each sp rank of this process its contiguous chunk of the
                # rows, at its offset; the ring's K/V cross the sp group
                Tl = T // lay.sp
                mine = range(lay.sp_start, lay.sp_start + lay.sp_local)
                starts = [torch.full((rows,), s * Tl, dtype=torch.long, device=xd.device)
                          for s in mine]
                xs_, ys_ = xd.split(Tl, dim=1), yd.split(Tl, dim=1)
                out = transformer.sp_forward(
                    cfg, [ranks] * lay.sp_local, [xs_[s] for s in mine], starts,
                    use_flash=self.use_flash, flash_kernel=self.flash_kernel, remat=remat,
                    collect_moe_aux=collect, group=lay.sp_group)
                self.layer_runs += cfg.n_layer * lay.sp_local * lay.sp * lay.tp_local
                logits_s = out[0] if collect else out
                if collect:
                    stats = stats + out[1]
                for logits, ys in zip(logits_s, [ys_[s] for s in mine]):
                    ce = ce + F.cross_entropy(logits.float().flatten(0, 1),
                                              ys.flatten().long(), reduction="sum")
                continue
            if lay.pp > 1:
                logits = self._pp_logits(ranks, xd, remat)
                if logits is None:  # the last stage is another process's
                    continue
            else:
                out = transformer.sharded_forward(
                    cfg, ranks.ranks, xd, torch.zeros(rows, dtype=torch.long, device=xd.device),
                    use_flash=self.use_flash, flash_kernel=self.flash_kernel, remat=remat,
                    collect_moe_aux=collect, group=lay.tp_group)
                self.layer_runs += cfg.n_layer * lay.tp_local
                logits = out[0] if collect else out
                if collect:
                    stats = stats + out[1]
            ce = ce + F.cross_entropy(logits.float().flatten(0, 1), yd.flatten().long(),
                                      reduction="sum")
        loss = ce / float(B * T)
        if collect:  # stats (L, 2, E): assignments, probabilities
            assign = stats[:, 0]
            if lay.dp_group is not None:
                assign = lay.dp_group.all_reduce_(assign.clone())
            aux = transformer.moe_aux_loss(cfg, assign, stats[:, 1], B * T)
            loss = loss + aux_weight * aux / cfg.n_layer
        return loss

    def _ep_loss(self, x, y, remat: bool, aux_weight: float) -> torch.Tensor:
        """The loss of the batch on a (dp, ep[, tp]) mesh: each dp row's
        rows run over the tp ranks (one rank at tp = 1, the whole tree),
        layer by layer, and every MoE layer's one dispatch takes the whole
        batch's tokens split over the dp x ep ranks to their experts
        (`transformer.replicas_forward`, `parallel.expert.ep_moe_forward`,
        the aux's stats summed over both axes)."""
        from functools import partial

        from mdi_llm_tpu_torch.parallel.expert import ep_moe_forward

        cfg, lay = self.cfg, self.layout
        impl = partial(ep_moe_forward, mesh=self.mesh,
                       capacity_factor=self.tc.moe_capacity_factor,
                       dp_axis="dp" if "dp" in self.mesh.axis_names else None,
                       group=lay.ep_group, dp_group=lay.dp_group)
        collect = aux_weight > 0
        B, T = x.shape
        rows = B // lay.dp
        # this process's dp rows (every row unless the dp axis splits over
        # the processes: its part of the loss, summed over the dp group)
        xs, ys = (torch.cat([a[d * rows:(d + 1) * rows] for d in lay.dp_coords])
                  for a in (x, y))
        ranks = transformer.TPRanks(cfg, self._rank_trees(), lay.tp_group)
        out = transformer.replicas_forward(
            cfg, [ranks] * len(lay.dp_coords), (impl, self.params["blocks"]["mlp"]), xs,
            torch.zeros(xs.shape[0], dtype=torch.long, device=x.device),
            use_flash=self.use_flash, flash_kernel=self.flash_kernel, remat=remat,
            collect_moe_aux=collect)
        self.layer_runs += cfg.n_layer * lay.tp_local * len(lay.dp_coords)
        logits = out[0] if collect else out
        loss = F.cross_entropy(logits.float().flatten(0, 1), ys.flatten().long(),
                               reduction="sum") / float(B * T)
        if collect:
            loss = loss + aux_weight * out[1] / cfg.n_layer
        return loss

    def _pp_logits(self, ranks, x, remat: bool) -> Optional[torch.Tensor]:
        """The GPipe ring over one dp shard's rows `x`: S micro-batches,
        stage s running micro-batch t - s at micro-step t (bubbles
        skipped), embed at stage 0; the head over the last stage's outputs
        in micro-batch order (None where another process holds the last
        stage).  Only this process's stages run: a stage whose input is
        another process's receives it (`CommGroup.recv`; a leaf that
        requires grad when grad is on), and its last stage sends its
        outputs on, in micro-batch order; both are recorded in `_pp_io`
        for the backward (`_micro_grads`)."""
        lay = self.layout
        S, (s0, s1), pp = lay.pp, lay.stages, lay.pp_group
        mu, T = x.shape[0] // S, x.shape[1]
        pos, cos, sin = ranks.positions(x[:mu], torch.zeros(mu, dtype=torch.long,
                                                             device=x.device))
        attn = ranks.rep(lambda r: dict(input_pos=torch.zeros(mu, dtype=torch.long,
                                                              device=ranks.devs[r]),
                                        use_flash=self.use_flash,
                                        flash_kernel=self.flash_kernel))
        layers = ranks.layers()
        base = self.pp_starts[s0]  # this process's layers start there
        grad = torch.is_grad_enabled()
        entering: List[Any] = [None] * S  # the activation entering each stage
        emitted: List[Any] = [None] * S
        for t in range(2 * S - 1):
            for s in reversed(range(s0, s1)):  # stage s + 1 reads what s emitted last step
                mb = t - s
                if not 0 <= mb < S:
                    continue
                if s == 0:
                    h = ranks.embed(x[mb * mu:(mb + 1) * mu], pos)
                elif s == s0:
                    got = pp.recv((mu, T, self.cfg.n_embd), DTYPES[self.tc.dtype],
                                  ranks.devs[0], pp.index - 1)
                    if grad:
                        got.requires_grad_(True)
                        self._pp_io[0].append(got)
                    h = ranks.rep(lambda r: got.to(ranks.devs[r]))
                else:
                    h = entering[s]
                h = ranks.blocks(layers, h, pos, cos, sin, attn, start=self.pp_starts[s] - base,
                                 stop=self.pp_starts[s + 1] - base, remat=remat)
                self.layer_runs += self.pp_counts[s] * len(ranks.ranks)
                if s == S - 1:
                    emitted[mb] = h
                elif s == s1 - 1:
                    pp.send(h[0], pp.index + 1)
                    if grad:
                        self._pp_io[1].append(h[0])
                else:
                    entering[s + 1] = h
        if s1 < S:
            return None
        return ranks.head(ranks.rep(lambda r: torch.cat([e[r] for e in emitted])))

    def _micro_grads(self, x, y, leaves):
        """(this process's part of the loss of the batch (x, y), the
        gradients of `leaves`).  With the pp axis split, the Megatron
        schedule: the process of the last stage differentiates the loss;
        a process that sent activations receives their gradients, in the
        order it sent them, and differentiates its outputs with them; the
        gradients of the activations it received go back to their
        sender, in the order they came."""
        lay = self.layout
        if lay is None or not lay.split_stages:
            loss = self._loss(x, y, self.tc.remat)
            return loss, torch.autograd.grad(loss, leaves, allow_unused=True)
        self._pp_io = ([], [])
        loss = self._loss(x, y, self.tc.remat)
        (got, sent), pp = self._pp_io, lay.pp_group
        self._pp_io = ([], [])
        inputs = list(leaves) + got
        if sent:
            back = [pp.recv(h.shape, h.dtype, h.device, pp.index + 1) for h in sent]
            grads = torch.autograd.grad(sent, inputs, grad_outputs=back, allow_unused=True)
        else:
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        for h, g in zip(got, grads[len(leaves):]):
            pp.send(torch.zeros_like(h) if g is None else g, pp.index - 1)
        return loss, grads[:len(leaves)]

    def _grad_norm(self, grads) -> torch.Tensor:
        """The global norm of the whole tree's gradients: split leaves
        summed over the tp (or ep) group, replicated leaves counted once,
        each stage's leaves on its process (summed over the pp group), a
        tied embedding once (on stage 0's process)."""
        lay = self.layout
        skip = self._wte_index if lay.stages[0] > 0 else None
        # a leaf counts on the first process of each group that replicates it
        first_tp, first_ep = (g is None or g.index == 0 for g in (lay.tp_group, lay.ep_group))
        terms = [g.square().sum() for i, (g, d, e) in enumerate(zip(grads, self._dims,
                                                                      self._ep_dims))
                 if (d is not None or first_tp) and (e is not None or first_ep) and i != skip]
        # (a process past the first of both its tp and ep groups may count none)
        sq = torch.stack(terms).sum() if terms else torch.zeros((), device=self.device)
        for group in (lay.tp_group, lay.ep_group, lay.pp_group):
            if group is not None:
                group.all_reduce_(sq)
        return sq.sqrt()

    def _global_value(self, loss: torch.Tensor) -> torch.Tensor:
        """A detached per-process loss summed over the dp group (other
        replicas and sp chunks), then over the pp group (only the last
        stage's processes hold a part)."""
        v = loss.detach().clone()
        for group in (() if self.layout is None
                      else (self.layout.dp_group, self.layout.pp_group)):
            if group is not None:
                group.all_reduce_(v)
        return v

    def train_step(self, xs: np.ndarray, ys: np.ndarray) -> float:
        """One optimizer step over (grad_acc_steps, batch, T) token arrays
        (the global batch on a mesh): the micro-batch gradients are summed
        in float32 and averaged."""
        xs, ys = self._tokens(xs), self._tokens(ys)
        leaves = transformer.tree_leaves(self.params)
        # the float32 sum lives for the step only: the first micro-batch's
        # gradients start it (float32 ones are taken as they are)
        accs: Optional[List[torch.Tensor]] = None
        losses = []
        for m in range(xs.shape[0]):
            loss, grads = self._micro_grads(xs[m], ys[m], leaves)
            if accs is None:  # an unused leaf's gradient is zero
                accs = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                        for p, g in zip(leaves, grads)]
            else:
                for acc, g in zip(accs, grads):
                    if g is not None:
                        acc.add_(g)
            del grads
            losses.append(loss.detach())
        if self.layout is not None and self.layout.dp_group is not None:
            t0 = time.perf_counter()  # once per step, after accumulation
            self.layout.dp_group.all_reduce_many_(accs)
            self.grad_sync_s += time.perf_counter() - t0
        for acc in accs:
            acc.div_(xs.shape[0])
        if self._wte_index is not None:
            # the tied embedding's gradients of stage 0 and the last stage
            self.layout.tie_group.all_reduce_(accs[self._wte_index])
        norm = None if self.layout is None else self._grad_norm(accs)
        self.optimizer.update(leaves, accs, norm=norm)
        del accs
        self.iter_num += 1
        return float(self._global_value(torch.stack(losses).mean()))

    @torch.no_grad()
    def eval_loss(self, x, y) -> float:
        """The cross-entropy of one batch (no aux, as the JAX Trainer's
        eval), without gradients and without remat."""
        return float(self._global_value(
            self._loss(self._tokens(x), self._tokens(y), remat=False, aux_weight=0.0)))

    @staticmethod
    def _sample_batch(data, batch_size, block_size, rng):
        """Accepts a token array (NumPy path) or any object exposing
        `.get_batch(batch, block)` (e.g. the native C++ loader)."""
        if hasattr(data, "get_batch"):
            return data.get_batch(batch_size, block_size)
        return data_loader.get_batch(data, batch_size, block_size, rng)

    def estimate_loss(self, data, rng) -> float:
        """Mean loss over eval_iters random batches."""
        losses = []
        for _ in range(self.tc.eval_iters):
            x, y = self._sample_batch(data, self.tc.batch_size, self.block_size, rng)
            losses.append(self.eval_loss(x, y))
        return float(np.mean(losses))

    def fit(
        self,
        train_data,
        val_data=None,
        max_iters: Optional[int] = None,
        log_cb=None,
    ) -> Dict[str, Any]:
        """Run the training loop: eval and checkpoint every ckpt_interval
        iterations (save on a new best, stop when patience runs out), a
        history entry every log_interval."""
        tc = self.tc
        max_iters = max_iters if max_iters is not None else tc.max_iters
        rng = np.random.default_rng(tc.seed + 1)
        flops_tok = estimate_flops_per_token(self.cfg, self.block_size)
        toks_per_iter = tc.grad_acc_steps * tc.batch_size * self.block_size
        patience_left = tc.patience
        history = []
        t0 = time.perf_counter()

        while self.iter_num < max_iters:
            if (
                self.iter_num % tc.ckpt_interval == 0
                and val_data is not None
                and self.iter_num > 0
            ):
                val_loss = self.estimate_loss(val_data, rng)
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    patience_left = tc.patience
                    if self.out_dir:
                        self.save(self.out_dir)
                else:
                    patience_left -= 1
                    if patience_left <= 0:
                        break
                history.append({"iter": self.iter_num, "val_loss": val_loss})

            xs = np.empty((tc.grad_acc_steps, tc.batch_size, self.block_size), np.int32)
            ys = np.empty_like(xs)
            for m in range(tc.grad_acc_steps):
                xs[m], ys[m] = self._sample_batch(
                    train_data, tc.batch_size, self.block_size, rng
                )
            loss = self.train_step(xs, ys)
            if self.iter_num % tc.log_interval == 0:
                dt = time.perf_counter() - t0
                tflops = flops_tok * toks_per_iter * self.iter_num / dt / 1e12
                history.append({"iter": self.iter_num, "loss": loss, "tflops": tflops})
                if log_cb:
                    log_cb(history[-1])
        return {
            "iter_num": self.iter_num,
            "best_val_loss": self.best_val_loss,
            "history": history,
        }

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, out_dir) -> Path:
        """Write the checkpoint in the standard layout, whatever the mesh:
        collective across processes (a gather of the tp slices), and
        process 0 alone writes."""
        params = self._standard_params()
        state = self.optimizer.state_dict()
        state = dict(state, mu=self._whole(state["mu"], torch.float32),
                     nu=self._whole(state["nu"], torch.float32))
        out_dir = Path(out_dir).resolve()
        if self.mesh is not None and self.mesh.process_id != 0:
            return out_dir
        out_dir = save_checkpoint(params, self.cfg, out_dir)
        torch.save(state, out_dir / "opt_state.pt")
        (out_dir / "train_state.json").write_text(
            json.dumps(
                {
                    "iter_num": self.iter_num,
                    "best_val_loss": self.best_val_loss,
                    "training_config": asdict(self.tc),
                }
            )
        )
        return out_dir

    @classmethod
    def resume(cls, out_dir, mesh: Optional[Mesh] = None, device=None) -> "Trainer":
        """A Trainer continuing the checkpoint in `out_dir` on `mesh` (any
        mesh, or none: checkpoints are in the standard layout)."""
        out_dir = Path(out_dir).resolve()
        state = json.loads((out_dir / "train_state.json").read_text())
        tc = TrainingConfig(**state["training_config"])
        if mesh is not None and device is None:
            device = mesh.device_list()[mesh.owned()[0]]
        cfg = Config.from_checkpoint(out_dir)
        cfg, params = load_checkpoint(out_dir, cfg=cfg, device=resolve_device(device),
                                      experts=mesh_experts(mesh, cfg))
        tr = cls(cfg, tc, mesh=mesh, params=params, out_dir=out_dir, device=device)
        del params
        if tr._split:  # the moments mapped, only this process's part read
            opt = torch.load(out_dir / "opt_state.pt", map_location="cpu", mmap=True)
            opt = dict(opt, mu=tr._local(opt["mu"]), nu=tr._local(opt["nu"]))
        else:
            opt = torch.load(out_dir / "opt_state.pt", map_location=tr.device)
        tr.optimizer.load_state_dict(opt)
        tr.iter_num = state["iter_num"]
        tr.best_val_loss = state["best_val_loss"]
        return tr
