"""The port's static plan auditor (`mdi-audit`'s counterpart): evaluate a
(Config, mesh, parallel plan, ServingConfig) tuple WITHOUT touching a card
or allocating anything.

Port of `mdi_llm_tpu/analysis/audit.py`: every code of `AUDIT_RULES` with
its severity, each check carried over onto the port's own functions.  Three
checker families over the abstract-shape IR (`analysis/plan.py`):

1. **Sharding consistency** — every `parallel/sharding.param_specs` leaf is
   checked against the declared mesh: axis names exist, each sharded dim is
   divisible by its axis size (heads % tp, experts % ep, vocab % tp where
   the head shards, n_layer % stages via `partition.stage_layers`), no dim
   uses one axis twice, and coverage is total.
2. **Memory budgeting** — analytic per-device footprint (params by
   dtype/quantized storage layout, dense KV cache or paged pool priced by
   `ServingConfig.block_bytes`/`pool_bytes_per_device`, the per-rank tp
   pool per device, an activation high-water mark) checked against an
   optional `--hbm-gb` budget, with the max batch / blocks that fit.
3. **Schedule soundness** — symbolic execution of the stage-ring
   permutation: every send has a matching receive, the ring is one cycle,
   per-rank op traces are identical, and the paper's recurrent-pipeline
   invariant `n_samples >= n_stages` is reported with the bubble fraction.

Where the JAX audit prices the Pallas kernel's VMEM against the TPU's,
`bad-kernel-tuning` here checks K1's entry of the card the plan names
(`ops/tuning.validate_kernel_params` on what `resolve_kernel_params`
resolves), the head sizes and pool dtypes K1 is built for, and K1's
dynamic shared memory per block (`ops/ragged_paged_attention.smem_bytes`,
the size its launch requests) against the card's opt-in limit.  With
`liveness=True` (`--liveness`), as in the JAX audit, the activation term
of a serving plan the engine can enumerate (tp and pp meshes) is the worst
step's temporaries' peak from the liveness pass over the traced steps
(`analysis/liveness.py`, on the meta device) instead of the heuristic.

Findings reuse the lint's `Finding`/`Baseline` machinery (analysis/core.py).
Runnable as `python -m mdi_llm_tpu_torch.analysis audit`; `cli.serve`,
`cli.server` and `cli.starter` call :func:`preflight` before loading any
weight and refuse (or warn, with ``--no-preflight``) to launch a failing
plan.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from mdi_llm_tpu_torch.analysis.core import Baseline, Finding
from mdi_llm_tpu_torch.analysis.plan import (
    H100,
    SMEM_OPTIN_BYTES,
    MeshSpec,
    PlanSpec,
    abstract_params,
    iter_leaves,
    resolve_dtype,
    ring_permutation,
)
from mdi_llm_tpu_torch.config import Config, ServingConfig, dtype_bytes

__all__ = [
    "AUDIT_RULES",
    "AuditReport",
    "audit_detail",
    "audit_plan",
    "enforce_preflight",
    "preflight",
    "refusal_text",
    "main",
]

ERROR, WARNING = "error", "warning"

# code -> (severity, summary).  ERROR findings make preflight refuse to
# launch; WARNING findings are reported but never block.
AUDIT_RULES: Dict[str, Tuple[str, str]] = {
    "bad-mesh-axis": (
        ERROR, "a declared mesh axis has size < 1 (make_mesh rejects it; "
        "resolve -1 inference to a concrete size before auditing)"),
    "unknown-mesh-axis": (
        ERROR, "a PartitionSpec references an axis the mesh does not declare "
        "(the runtime silently replicates instead of sharding)"),
    "indivisible-dim": (
        ERROR, "a sharded dimension is not divisible by its mesh axis size"),
    "duplicate-axis": (
        ERROR, "one leaf shards two dimensions on the same mesh axis"),
    "missing-spec": (
        ERROR, "a params leaf has no PartitionSpec (silent full replication)"),
    "stale-spec": (
        WARNING, "param_specs names a leaf the params tree does not have"),
    "spec-rank-mismatch": (
        ERROR, "a PartitionSpec has more entries than the leaf has dims"),
    "bad-stage-split": (
        ERROR, "the layer->stage partition is invalid (empty stage or "
        "n_stages > n_layer)"),
    "hbm-over-budget": (
        ERROR, "the analytic per-device footprint exceeds the HBM budget"),
    "unmatched-permute": (
        ERROR, "a ring send schedule has a send without a matching recv "
        "(not a permutation of the ranks)"),
    "broken-ring": (
        ERROR, "the ring permutation is a bijection but not one cycle — "
        "activations never return to stage 0"),
    "schedule-divergence": (
        ERROR, "ranks execute different collective sequences (deadlock)"),
    "pipeline-underfill": (
        WARNING, "n_samples < n_stages: the recurrent ring runs with "
        "bubbles (paper invariant, MDI-LLM README)"),
    "bad-serving-config": (
        ERROR, "the paged-KV ServingConfig cannot be instantiated"),
    "bad-token-budget": (
        ERROR, "the unified serving step's token budget cannot fit one "
        "decode token per max_batch slot plus any prefill chunk token "
        "(prefill could never progress)"),
    "bad-serving-mesh": (
        ERROR, "the serving plan's mesh cannot shard the paged-KV pool "
        "(n_query_groups % tp != 0, or a dp/other >1 axis the engine "
        "does not support)"),
    "bad-server-config": (
        ERROR, "the open-system server config cannot serve: the admission "
        "queue bound rejects everything, or it keeps every slot occupied "
        "over a pool too small to hold all slots' reservation headroom "
        "(sustained preemption thrash)"),
    "bad-host-tier": (
        ERROR, "the host KV block tier cannot work as configured: "
        "host_pool_mib exceeds the --host-gb budget, prefix spill is on "
        "without prefix_caching (no hash chains to key spilled blocks), "
        "or the swap cost model sees a zero-bandwidth host link (it "
        "would never choose to swap)"),
    "bad-kernel-tuning": (
        ERROR, "K1 cannot run this serving plan on the card: its tuning-table "
        "entry is invalid (ops/tuning.validate_kernel_params), the head "
        "size or pool dtype is one it is not built for, or its dynamic "
        "shared memory exceeds the card's opt-in limit per block"),
}

GiB = float(1 << 30)


@dataclasses.dataclass
class AuditReport:
    plan: PlanSpec
    findings: List[Finding]
    breakdown: Dict[str, Any]

    def severity(self, f: Finding) -> str:
        return AUDIT_RULES.get(f.rule, (ERROR, ""))[0]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if self.severity(f) == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if self.severity(f) == WARNING]

    def render_findings(self) -> List[str]:
        return [
            f"{f.path}: {self.severity(f)}: {f.rule}: {f.message}"
            for f in self.findings
        ]

    def render_text(self) -> str:
        lines = [f"plan: {self.plan.describe()}"]
        dev = self.breakdown.get("per_device", {})
        if dev:
            lines.append("per-device HBM footprint:")
            for k in ("params_bytes", "kv_bytes", "act_bytes", "total_bytes"):
                label = k.replace("_bytes", "").replace("act", "activations")
                lines.append(f"  {label:<12} {dev[k] / GiB:9.3f} GiB")
            budget = self.breakdown.get("budget_bytes")
            if budget:
                lines.append(
                    f"  budget       {budget / GiB:9.3f} GiB "
                    f"({self.breakdown['budget_utilization']:.0%} used)"
                )
                fits = self.breakdown.get("fits", {})
                if fits:
                    lines.append(
                        "  fits: " + ", ".join(f"{k}={v}" for k, v in fits.items())
                    )
        if self.breakdown.get("stage_layers"):
            lines.append(f"stage layers: {self.breakdown['stage_layers']}")
        if "bubble_fraction" in self.breakdown:
            lines.append(
                f"ring lanes: {self.breakdown['ring_lanes']} "
                f"(bubble fraction {self.breakdown['bubble_fraction']:.2f})"
            )
        if self.findings:
            lines.extend(self.render_findings())
        else:
            lines.append("findings: none")
        return "\n".join(lines)

    def as_json(self) -> Dict[str, Any]:
        return {
            "plan": self.plan.describe(),
            "findings": [
                {**f.__dict__, "severity": self.severity(f)} for f in self.findings
            ],
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "breakdown": self.breakdown,
        }


def _finding(plan: PlanSpec, code: str, message: str) -> Finding:
    assert code in AUDIT_RULES, code
    return Finding(
        rule=code, path=plan.origin, line=0, col=0,
        message=message, line_text=plan.describe(),
    )


# ---------------------------------------------------------------------------
# checker 1: sharding consistency
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    """PartitionSpec entry → axis names (None → (), 'tp' → ('tp',),
    ('dp','tp') → both)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _spec_axis_names(specs) -> List[str]:
    names: List[str] = []
    for _, spec in iter_leaves(specs):
        for entry in tuple(spec):
            for ax in _axes_of(entry):
                if ax not in names:
                    names.append(ax)
    return names


def _check_mesh(plan: PlanSpec, findings: List[Finding]) -> None:
    """Every declared axis size must be a concrete >= 1 — the IR can
    represent a nonsensical mesh, but the audit must flag it: every
    divisibility/memory check below is vacuous at size <= 1, so a 0 or -1
    axis would otherwise audit green and then die in `make_mesh`."""
    for name, size in plan.mesh.axes:
        if size < 1:
            findings.append(_finding(
                plan, "bad-mesh-axis",
                f"mesh axis {name!r} has size {size}; sizes must be >= 1 "
                "(the runtime's make_mesh rejects this mesh — pass the "
                "resolved size instead of -1 inference)",
            ))


def _check_sharding(plan: PlanSpec, findings: List[Finding]) -> None:
    from mdi_llm_tpu_torch.parallel.sharding import adapt_specs_to_tree, param_specs

    cfg, mesh = plan.cfg, plan.mesh
    specs = param_specs(cfg, tp_axis=plan.tp_axis, ep_axis=plan.ep_axis)
    shapes = abstract_params(cfg, plan.dtype)  # standard (semantic) layout

    # -- axis existence: one finding per axis the mesh does not declare ----
    unknown = [a for a in _spec_axis_names(specs) if a not in mesh.names]
    for a in unknown:
        findings.append(_finding(
            plan, "unknown-mesh-axis",
            f"plan shards on axis {a!r} but the mesh ({mesh.describe()}) "
            "does not declare it — the runtime would silently replicate "
            "every leaf sharded on it (shard_params drops unknown axes)",
        ))
    unknown_set = set(unknown)

    # -- coverage + per-leaf divisibility/duplicates -----------------------
    missing: List[str] = []
    stale: List[str] = []
    indiv: Dict[str, List[str]] = {}
    dups: Dict[str, List[str]] = {}

    def leaf_paths(node, path):
        return [p for p, _ in iter_leaves(node, path)]

    def walk(spec_node, shape_node, path, check_div):
        if isinstance(shape_node, dict):
            if not isinstance(spec_node, dict):
                missing.extend(leaf_paths(shape_node, path))
                return
            for k, v in shape_node.items():
                sub = f"{path}.{k}" if path else k
                if k not in spec_node:
                    missing.extend(leaf_paths(v, sub))
                else:
                    walk(spec_node[k], v, sub, check_div)
            for k in spec_node:
                if k not in shape_node:
                    stale.append(f"{path}.{k}" if path else k)
            return
        # leaf
        entries = tuple(spec_node) if not isinstance(spec_node, dict) else None
        if entries is None:
            missing.append(path)
            return
        shape = tuple(shape_node.shape)
        if len(entries) > len(shape):
            findings.append(_finding(
                plan, "spec-rank-mismatch",
                f"{path}: spec {entries} has {len(entries)} entries but the "
                f"leaf has shape {shape}",
            ))
            return
        seen: Dict[str, int] = {}
        for i, entry in enumerate(entries):
            for ax in _axes_of(entry):
                if ax in seen:
                    dups.setdefault(ax, []).append(
                        f"{path} dims {seen[ax]} and {i}"
                    )
                else:
                    seen[ax] = i
                if ax in unknown_set or not check_div:
                    continue
                size = mesh.size(ax)
                if size > 1 and shape[i] % size:
                    indiv.setdefault(ax, []).append(
                        f"{path} dim{i}={shape[i]}"
                    )

    # head/embedding leaves replicate in the pipeline engine: their specs
    # only bind when the Generator mesh path consumes the plan
    def check_div_for(key):
        return plan.shard_head or key == "blocks"

    for k, v in shapes.items():
        if k in specs:
            walk(specs[k], v, k, check_div_for(k))
        else:
            missing.extend(leaf_paths(v, k))
    for k in specs:
        if k not in shapes:
            stale.append(k)

    # -- semantic dims (mirror parallel.sharding.validate_tp_divisibility):
    # head/group counts must divide even when the fused leaf dim happens to
    # (the interleaved qkv layout makes a divisible row count insufficient)
    t = plan.tp_axis
    if t and t in mesh.names and mesh.size(t) > 1:
        tp = mesh.size(t)
        moe = cfg.mlp_class_name == "LLaMAMoE"
        dims = [("n_head", cfg.n_head), ("n_query_groups", cfg.n_query_groups)]
        if not moe:
            dims.append(("intermediate_size", cfg.intermediate_size))
        if plan.shard_head:
            dims.append(("padded_vocab_size", cfg.padded_vocab_size))
        for name, dim in dims:
            if dim % tp:
                indiv.setdefault(t, []).insert(0, f"{name}={dim}")
    e = plan.ep_axis or plan.tp_axis
    if (cfg.mlp_class_name == "LLaMAMoE" and e and e in mesh.names
            and mesh.size(e) > 1 and cfg.n_expert % mesh.size(e)):
        indiv.setdefault(e, []).insert(0, f"n_expert={cfg.n_expert}")
    sp = plan.sp_axis
    if sp and sp in mesh.names and mesh.size(sp) > 1 and plan.seq_len % mesh.size(sp):
        indiv.setdefault(sp, []).insert(
            0, f"sequence length {plan.seq_len} (ring attention chunks)"
        )

    # aggregate: ONE finding per axis / per failure family, so one root
    # cause (e.g. heads % tp) reads as one actionable report
    for ax, items in indiv.items():
        shown = items[:6] + ([f"... {len(items) - 6} more"] if len(items) > 6 else [])
        findings.append(_finding(
            plan, "indivisible-dim",
            f"mesh axis {ax!r} (size {mesh.size(ax)}) does not divide: "
            + "; ".join(shown),
        ))
    for ax, items in dups.items():
        findings.append(_finding(
            plan, "duplicate-axis",
            f"mesh axis {ax!r} used on two dims of one leaf: "
            + "; ".join(items[:6]),
        ))
    for p in missing:
        findings.append(_finding(
            plan, "missing-spec",
            f"params leaf {p!r} has no PartitionSpec — it would be "
            "silently fully replicated on every device",
        ))
    for p in stale:
        findings.append(_finding(
            plan, "stale-spec",
            f"param_specs names {p!r} but the params tree has no such leaf",
        ))

    # -- quantized storage coverage: the adapted specs must still cover the
    # int8/int4 layout (weight_q*/scale leaves inherit the weight's spec)
    if plan.quantize and plan.quantize != "none" and not missing:
        storage = abstract_params(cfg, plan.dtype, plan.quantize)
        adapted = adapt_specs_to_tree(specs, storage, axis_sizes=mesh.sizes)
        for (p, _), (_, spec) in zip(iter_leaves(storage), iter_leaves(adapted)):
            if spec is None:
                findings.append(_finding(
                    plan, "missing-spec",
                    f"quantized storage leaf {p!r} has no adapted spec",
                ))


# ---------------------------------------------------------------------------
# checker 2: memory budgeting
# ---------------------------------------------------------------------------


def _sharded_nbytes(leaf, spec, sizes: Dict[str, int]) -> int:
    """Per-device bytes of a leaf under its PartitionSpec: divide by every
    axis size that actually divides its dim (indivisible shardings are
    dropped by the runtime — `adapt_specs_to_tree` — so count them whole)."""
    denom = 1
    shape = tuple(leaf.shape)
    for i, entry in enumerate(tuple(spec)[: len(shape)]):
        for ax in _axes_of(entry):
            s = sizes.get(ax, 1)
            if s > 1 and shape[i] % s == 0:
                denom *= s
    return int(leaf.nbytes) // denom


def _check_memory(
    plan: PlanSpec, findings: List[Finding], breakdown: Dict[str, Any],
    liveness: bool = False,
) -> None:
    from mdi_llm_tpu_torch.parallel.partition import stage_layers
    from mdi_llm_tpu_torch.parallel.sharding import adapt_specs_to_tree, param_specs

    cfg, mesh = plan.cfg, plan.mesh
    sizes = mesh.sizes
    par_item = dtype_bytes(plan.dtype)
    try:
        kv_item = dtype_bytes(plan.kv_dtype)
    except ValueError:
        if plan.serving is None:
            raise  # dense plans have no checker reporting dtype problems
        kv_item = 0  # already a bad-serving-config finding; budget KV as 0
    storage = abstract_params(cfg, plan.dtype, plan.quantize)
    try:
        specs = adapt_specs_to_tree(
            param_specs(cfg, tp_axis=plan.tp_axis, ep_axis=plan.ep_axis),
            storage,
            axis_sizes=sizes,
        )
    except (KeyError, TypeError):
        # incomplete spec tree — already reported as missing-spec by the
        # sharding checker; budget conservatively as fully replicated
        specs = None
    def leaf_spec_pairs(storage_sub, specs_sub):
        leaves = list(iter_leaves(storage_sub))
        if specs_sub is None:
            return [(leaf, ()) for _, leaf in leaves]  # replicated fallback
        return [
            (leaf, spec)
            for (_, leaf), (_, spec) in zip(leaves, iter_leaves(specs_sub))
        ]

    S = max(1, plan.n_stages)
    tp = mesh.size(plan.tp_axis) if plan.tp_axis else 1

    if plan.is_pipeline:
        try:
            counts = stage_layers(cfg.n_layer, S)
        except ValueError:
            return  # bad-stage-split already reported; no meaningful budget
        l_max = max(counts)
        # blocks: per-device = per-layer bytes * l_max (zero-padded stage
        # stack, parallel/partition.pad_stage_blocks), tp-sharded per spec
        blocks_dev = sum(
            _sharded_nbytes(leaf, spec, sizes) // cfg.n_layer * l_max
            for leaf, spec in leaf_spec_pairs(
                storage["blocks"], specs["blocks"] if specs else None
            )
        )
        # embeddings/final norm/head are replicated on every stage
        head_dev = sum(
            int(leaf.nbytes)
            for k, v in storage.items() if k != "blocks"
            for _, leaf in iter_leaves(v)
        )
        params_dev = blocks_dev + head_dev
        # per-stage rotating KV: (l_max, n_slots, M, G, seq, hs) x2, the
        # group dim tp-sharded when divisible (PipelineEngine._init_kv)
        G = cfg.n_query_groups
        g_denom = tp if (tp > 1 and G % tp == 0) else 1
        kv_dev = (
            2 * l_max * (S + 1) * plan.samples_per_slot * (G // g_denom)
            * plan.cache_len * cfg.head_size * kv_item
        )
        act_batch = plan.samples_per_slot
    else:
        params_dev = sum(
            _sharded_nbytes(leaf, spec, sizes)
            for leaf, spec in leaf_spec_pairs(storage, specs)
        )
        if plan.serving is not None:
            # an invalid pool geometry is already a bad-serving-config
            # finding; budget it as zero instead of dividing by block_size
            # (an unknown kv_dtype likewise — the serving checker reported
            # it).  Per DEVICE: the pool's KV-group axis shards over tp
            # (paged_kv_spec, int8 scale arrays included), so each chip
            # holds exactly 1/tp of the pool
            try:
                kv_dev = max(0, (
                    plan.serving.pool_bytes_per_device(
                        cfg, _serving_tp(plan), plan.seq_len, plan.kv_dtype
                    )
                    if plan.serving.block_size >= 1 else 0
                ))
            except ValueError:
                kv_dev = 0
            pp = _serving_pp(plan)
            if pp > 1 and cfg.n_layer >= pp:
                # pipelined serving: each device holds ONE stage's shard —
                # l_max zero-padded layer slots instead of all n_layer.
                # Pool bytes are layer-proportional and divisible by
                # n_layer, so the rescale is exact (== the kv_pool
                # breakdown's pool_bytes_per_device)
                l_max = max(stage_layers(cfg.n_layer, pp))
                kv_dev = kv_dev // cfg.n_layer * l_max
        else:
            kv_dev = cfg.estimate_kv_bytes(plan.batch, plan.cache_len, plan.kv_dtype)
        act_batch = plan.batch

    # activation high-water mark (rough, per live layer — not cumulative):
    # residual stream + qkv/attn-out + widest MLP intermediate, plus the
    # head's logits row.  Decode keeps T=1; prefill passes its bucket width.
    T = max(1, plan.act_seq_len)
    mlp_live = (
        2 * cfg.intermediate_size
        if cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP", "LLaMAMoE")
        else cfg.intermediate_size
    )
    act_dev = act_batch * T * (
        4 * cfg.n_embd + cfg.qkv_size + cfg.attn_out_size + mlp_live
    ) * par_item + act_batch * cfg.padded_vocab_size * par_item
    act_source = "heuristic"
    if liveness:
        # engine-enumerable (Config, mesh, ServingConfig) tuples get the
        # liveness-derived per-step high-water instead of the analytic
        # term; everything else keeps the heuristic
        lv = _liveness_act_bytes(plan)
        if lv is not None:
            act_dev, act_source = int(lv), "liveness"

    total = params_dev + kv_dev + act_dev
    breakdown["per_device"] = {
        "params_bytes": int(params_dev),
        "kv_bytes": int(kv_dev),
        "act_bytes": int(act_dev),
        "act_source": act_source,
        "total_bytes": int(total),
    }
    breakdown["n_devices"] = mesh.n_devices

    if plan.hbm_gb is None:
        return
    budget = int(plan.hbm_gb * GiB)
    breakdown["budget_bytes"] = budget
    breakdown["budget_utilization"] = round(total / budget, 4) if budget else None
    avail = budget - params_dev - act_dev
    fits: Dict[str, Any] = {}
    if plan.serving is not None:
        # per-device block cost under the tp-sharded pool layout (the
        # itemized ServingConfig.block_bytes — payload AND int8 scale side
        # arrays, the same formula pool_bytes uses, so the fit and the
        # estimate can never disagree): the HBM budget is per chip, so
        # blocks-that-fit scales with the tp degree
        try:
            per_block = plan.serving.block_bytes(
                cfg, plan.kv_dtype, tp=_serving_tp(plan)
            )["total_bytes"]
            pp = _serving_pp(plan)
            if pp > 1 and cfg.n_layer >= pp:
                # per-device block cost is one STAGE's slice (l_max layer
                # slots) under pipelined serving — exact, see kv_dev above
                per_block = per_block // cfg.n_layer * max(
                    stage_layers(cfg.n_layer, pp)
                )
        except ValueError:
            per_block = 0  # unknown kv_dtype: bad-serving-config reported
        fits["max_pool_blocks"] = max(0, int(avail // per_block)) if per_block else 0
        if "kv_pool" in breakdown:
            breakdown["kv_pool"]["blocks_at_budget"] = fits["max_pool_blocks"]
    else:
        if plan.is_pipeline:
            per_lane = kv_dev // max(1, plan.samples_per_slot)
            fits["max_samples_per_slot"] = max(0, int(avail // per_lane)) if per_lane else 0
        else:
            per_seq = cfg.estimate_kv_bytes(1, plan.cache_len, plan.kv_dtype)
            per_tok = cfg.estimate_kv_bytes(plan.batch, 1, plan.kv_dtype)
            fits["max_batch"] = max(0, int(avail // per_seq)) if per_seq else 0
            fits["max_context"] = max(0, int(avail // per_tok)) if per_tok else 0
    breakdown["fits"] = fits

    if total > budget:
        dev = breakdown["per_device"]
        findings.append(_finding(
            plan, "hbm-over-budget",
            f"per-device footprint {total / GiB:.2f} GiB exceeds the "
            f"{plan.hbm_gb:g} GiB budget (params {dev['params_bytes'] / GiB:.2f}"
            f" + kv {dev['kv_bytes'] / GiB:.2f} + activations "
            f"{dev['act_bytes'] / GiB:.2f}); fits: "
            + (", ".join(f"{k}={v}" for k, v in fits.items()) or "nothing"),
        ))


# ---------------------------------------------------------------------------
# checker 3: schedule soundness
# ---------------------------------------------------------------------------


def _check_permutation(plan, perm, n, what, findings) -> bool:
    """Validate `perm` as a full bijection over `n` ranks; returns True when
    sound.  Aggregates all problems into ONE unmatched-permute finding."""
    problems: List[str] = []
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    for r in set(srcs) | set(dsts):
        if not (0 <= r < n):
            problems.append(f"rank {r} out of range [0, {n})")
    for r in sorted(set(srcs)):
        if srcs.count(r) > 1:
            problems.append(f"rank {r} sends twice in one permutation")
    for r in sorted(set(dsts)):
        if dsts.count(r) > 1:
            problems.append(f"rank {r} receives two sends")
    for r in range(n):
        if r not in srcs:
            problems.append(f"rank {r} never sends (its neighbor's recv is unmatched)")
        if r not in dsts:
            problems.append(f"rank {r} never receives (it decodes garbage/zeros)")
    if problems:
        findings.append(_finding(
            plan, "unmatched-permute",
            f"{what} permutation {list(perm)} over {n} ranks is not a "
            "permutation: " + "; ".join(dict.fromkeys(problems)),
        ))
        return False
    return True


def _check_schedule(
    plan: PlanSpec, findings: List[Finding], breakdown: Dict[str, Any]
) -> None:
    S, M = plan.n_stages, plan.samples_per_slot

    if S > 1 or plan.ring_perm is not None:
        n = max(S, 1)
        perm = tuple(plan.ring_perm) if plan.ring_perm is not None else ring_permutation(n)
        if _check_permutation(plan, perm, n, "stage-ring", findings):
            # symbolic execution: follow stage 0's activation around the
            # ring — it must visit every stage and return in exactly n hops
            nxt = dict(perm)
            rank, orbit = 0, [0]
            for _ in range(n):
                rank = nxt[rank]
                if rank == 0:
                    break
                orbit.append(rank)
            if len(orbit) < n:
                findings.append(_finding(
                    plan, "broken-ring",
                    f"stage-ring permutation is a bijection but splits into "
                    f"disjoint cycles (stage 0's orbit is {orbit}, not all "
                    f"{n} stages): the head never sees stages outside its "
                    "cycle",
                ))
            else:
                breakdown["ring_rotation_steps"] = n

    if plan.rank_programs:
        progs = plan.rank_programs
        ref = progs[0]
        for r, prog in enumerate(progs[1:], start=1):
            if prog != ref:
                step = next(
                    (i for i, (a, b) in enumerate(zip(ref, prog)) if a != b),
                    min(len(ref), len(prog)),
                )
                findings.append(_finding(
                    plan, "schedule-divergence",
                    f"rank {r}'s collective sequence diverges from rank 0 "
                    f"at step {step}: every rank must issue the identical "
                    "op sequence per edge or the ring deadlocks",
                ))
                break

    if S > 1:
        lanes = S * M
        inflight = min(plan.n_samples, lanes)
        bubble = 1.0 - inflight / lanes if lanes else 1.0
        breakdown["ring_lanes"] = lanes
        breakdown["bubble_fraction"] = round(bubble, 4)
        if plan.n_samples < S:
            findings.append(_finding(
                plan, "pipeline-underfill",
                f"n_samples={plan.n_samples} < n_stages={S}: the recurrent "
                f"ring idles {bubble:.0%} of its {lanes} lanes (the paper's "
                "full-utilization invariant is n_samples >= n_stages; "
                f"{lanes} samples saturate this plan)",
            ))

    # pipelined serving (serving/pipeline.py): the scheduler's decode
    # lanes are the ring's fill, so the paper invariant reads
    # max_batch >= pp — below it, every ring sweep idles stages
    if plan.serving is not None:
        pp = _serving_pp(plan)
        if pp > 1:
            lanes = plan.serving.max_batch
            bubble = max(0.0, 1.0 - min(max(lanes, 0), pp) / pp)
            breakdown["serving_ring"] = {
                "stages": pp,
                "lanes": lanes,
                "bubble_fraction": round(bubble, 4),
            }
            if lanes < pp:
                findings.append(_finding(
                    plan, "pipeline-underfill",
                    f"max_batch={lanes} < pp={pp}: the serving ring idles "
                    f"{bubble:.0%} of its stages every sweep (decode lanes "
                    "are the pipeline's fill — set max_batch >= pp to "
                    "saturate it)",
                ))


def _check_stages(plan: PlanSpec, findings: List[Finding], breakdown) -> None:
    from mdi_llm_tpu_torch.parallel.partition import stage_layers

    if plan.n_stages < 1:
        findings.append(_finding(
            plan, "bad-stage-split", f"n_stages={plan.n_stages} must be >= 1"
        ))
        return
    try:
        counts = stage_layers(plan.cfg.n_layer, plan.n_stages)
    except ValueError as e:
        findings.append(_finding(plan, "bad-stage-split", str(e)))
        return
    if plan.n_stages > 1:
        breakdown["stage_layers"] = counts


def _serving_tp(plan: PlanSpec) -> int:
    """The tp degree a serving plan shards its pool over: the declared tp
    axis when the KV-group axis divides (the `paged_kv_spec` layout),
    else 1 — mirroring the runtime's drop-indivisible-sharding rule so the
    byte estimates stay exact even on a plan the mesh checker flags."""
    tp = plan.mesh.size(plan.tp_axis) if plan.tp_axis else 1
    if tp > 1 and plan.cfg.n_query_groups % tp == 0:
        return tp
    return 1


def _serving_pp(plan: PlanSpec) -> int:
    """The serving plan's pipeline degree: the 'pp' mesh axis
    (serving/pipeline.py stacks a per-stage pool shard over it)."""
    return max(1, plan.mesh.size("pp"))


def _check_serving_mesh(plan: PlanSpec, findings: List[Finding]) -> None:
    """The serving engine's mesh contract (`serving.engine.
    validate_serving_mesh` + `paged_kv_spec`), checked statically: only tp
    (which must divide n_query_groups — the pool shards its KV-group axis;
    an indivisible G would silently replicate the pool, tp-fold the HBM
    the budget promised) and pp (which must not exceed n_layer — every
    ring stage needs >= 1 transformer block) may exceed 1, alone or
    composed."""
    sv = plan.serving
    if sv is None:
        return
    tp = plan.mesh.size(plan.tp_axis) if plan.tp_axis else 1
    if tp > 1 and plan.cfg.n_query_groups % tp:
        findings.append(_finding(
            plan, "bad-serving-mesh",
            f"tp={tp} does not divide n_query_groups="
            f"{plan.cfg.n_query_groups} of {plan.cfg.name}: the paged pool "
            "shards its KV-group axis (paged_kv_spec), so serving would "
            "silently replicate the whole pool on every chip",
        ))
    pp = _serving_pp(plan)
    if pp > 1:
        from mdi_llm_tpu_torch.parallel.partition import stage_layers

        try:
            stage_layers(plan.cfg.n_layer, pp)
        except ValueError as e:
            findings.append(_finding(
                plan, "bad-serving-mesh",
                f"pp={pp} cannot stage {plan.cfg.name}: {e}",
            ))
    for name, size in plan.mesh.axes:
        if name == plan.tp_axis or name == "pp" or size <= 1:
            continue
        what = ("dp>1 serving is unsupported (requests are scheduler-"
                "routed, not batch-split; run one engine per replica)"
                if name == (plan.dp_axis or "dp")
                else "only tp (the pool's KV-group axis) and pp "
                "(per-stage pool shards) serve the paged pool, alone or "
                "composed")
        findings.append(_finding(
            plan, "bad-serving-mesh",
            f"serving mesh axis {name!r} (size {size}): {what} — "
            "Generator.serve() refuses this mesh",
        ))


def k1_geometry(plan: PlanSpec, pool_dtype: str) -> Dict[str, Any]:
    """The K1 calls a serving plan makes: q's and the pool's dtypes (the
    names `ops.tuning.geometry_key` uses) and the pool's bytes per
    element.  The pool holds int8 or float8 in its own type, else the
    engine's cache dtype."""
    q = str(resolve_dtype(plan.dtype)).replace("torch.", "")
    kv = str(resolve_dtype(pool_dtype)).replace("torch.", "")
    return {"q_dtype": q, "kv_dtype": kv, "kv_itemsize": dtype_bytes(kv)}


def _check_kernel_tuning(plan: PlanSpec, findings, breakdown, bb) -> None:
    """K1 on the card, host-side, before any weight loads: the tuning entry
    the engine would resolve for this geometry on the plan's card
    (`ops/tuning.resolve_kernel_params`, checked by
    `validate_kernel_params`), the head sizes and pool dtypes the kernel
    is built for, and its dynamic shared memory per block against the
    card's opt-in limit.  Findings fire only where K1 is on the route:
    `use_kernel=True`, or auto (None) on a card; a plan for the CPU (or
    `use_kernel=False`) takes the plain route.  The kv_pool breakdown
    always gains the route and the resolved entry."""
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa
    from mdi_llm_tpu_torch.ops.tuning import resolve_kernel_params, validate_kernel_params

    sv, cfg = plan.serving, plan.cfg
    variant = "k1" if sv.use_kernel else ("plain" if sv.use_kernel is False else "auto")
    on_card = plan.device_kind != "cpu"
    on_route = bool(sv.use_kernel) or (sv.use_kernel is None and on_card)
    pool = breakdown["kv_pool"]
    pool.update({"kernel_variant": variant, "device_kind": plan.device_kind})
    try:
        geo = k1_geometry(plan, bb["kv_dtype"])
        params, meta = resolve_kernel_params(
            cfg.n_head, cfg.n_query_groups, cfg.head_size, sv.block_size,
            geo["q_dtype"], geo["kv_dtype"], device_kind=plan.device_kind,
        )
    except (ValueError, OSError) as e:  # a malformed or unreadable MDI_TUNE_TABLE
        findings.append(_finding(
            plan, "bad-kernel-tuning",
            f"K1's tuning table cannot be used: {e} — fix or unset MDI_TUNE_TABLE",
        ))
        pool.update({"tuned": False, "kernel_table_source": None,
                     "kernel_params": None, "k1_smem_bytes": None})
        return
    smem = rpa.smem_bytes(cfg.head_size, geo["kv_itemsize"])
    limit = SMEM_OPTIN_BYTES.get(plan.device_kind)
    pool.update({
        "tuned": meta["tuned"],
        "kernel_table_source": meta["table_source"],
        "kernel_key": meta["key"],
        "kernel_params": params.to_dict(),
        "k1_smem_bytes": smem,
        "k1_smem_limit": limit,
    })
    if not on_route:
        return
    src = meta["table_source"]
    for problem in validate_kernel_params(params, cfg.n_head, cfg.head_size):
        findings.append(_finding(
            plan, "bad-kernel-tuning", f"{src} ({meta['key']}): {problem}",
        ))
    if cfg.head_size not in rpa.KERNEL_HEAD_SIZES:
        findings.append(_finding(
            plan, "bad-kernel-tuning",
            f"head size {cfg.head_size} of {cfg.name}: K1 is built for head "
            f"sizes {rpa.KERNEL_HEAD_SIZES} — serve it on the plain route "
            "(use_kernel=False) or on the CPU",
        ))
    narrow = geo["kv_dtype"] in ("int8", "float8_e4m3fn", "float8_e5m2")
    if geo["q_dtype"] not in ("float32", "bfloat16") or (
            geo["kv_dtype"] != geo["q_dtype"] and not narrow):
        findings.append(_finding(
            plan, "bad-kernel-tuning",
            f"q {geo['q_dtype']} over a {geo['kv_dtype']} pool: K1 takes q in "
            "float32 or bfloat16 over a pool of q's dtype, int8 or float8",
        ))
    if limit is not None and smem > limit:
        findings.append(_finding(
            plan, "bad-kernel-tuning",
            f"K1's dynamic shared memory {smem} B per block (head size "
            f"{cfg.head_size}, {geo['kv_dtype']} pool) exceeds the "
            f"{limit} B opt-in limit of {plan.device_kind}",
        ))


def _check_host_tier(
    plan: PlanSpec, sv: ServingConfig, findings: List[Finding], breakdown
) -> None:
    """The HBM->host block tier's static preconditions
    (serving/host_tier.py): a spill keyed on nothing, a cost model that
    can never choose to swap, or a slab allocation the host budget
    cannot hold are all launch-time mistakes, not runtime surprises."""
    if sv.host_pool_mib <= 0:
        return
    host_bytes = breakdown["kv_pool"]["host_pool_bytes"]
    if plan.host_gb is not None:
        budget = int(float(plan.host_gb) * GiB)
        if host_bytes > budget:
            findings.append(_finding(
                plan, "bad-host-tier",
                f"host_pool_mib={sv.host_pool_mib} allocates "
                f"{host_bytes / GiB:.2f} GiB of pinned block slabs, over "
                f"the {float(plan.host_gb):g} GiB --host-gb budget — "
                "shrink the tier or raise the budget",
            ))
    if sv.host_prefix_spill and not sv.prefix_caching:
        findings.append(_finding(
            plan, "bad-host-tier",
            "host_prefix_spill=True with prefix_caching=False: spilled "
            "blocks are keyed by the prefix hash chain, which only exists "
            "under prefix caching — enable prefix_caching or set "
            "host_prefix_spill=False (swap-only tier)",
        ))
    if sv.resolved_host_link_gbps() <= 0:
        findings.append(_finding(
            plan, "bad-host-tier",
            f"host_link_gbps={sv.host_link_gbps:g}: the swap cost model "
            "prices every transfer at infinite seconds, so preemption "
            "always recomputes and the tier never swaps — set a real "
            "bandwidth (or leave it None for the device-table default)",
        ))


def _check_serving(plan: PlanSpec, findings: List[Finding], breakdown) -> None:
    sv = plan.serving
    if sv is None:
        return
    _check_serving_mesh(plan, findings)
    problems = []
    if sv.block_size < 1:
        problems.append(f"block_size={sv.block_size} must be positive")
    if sv.max_batch < 1:
        problems.append(f"max_batch={sv.max_batch} must be positive")
    if sv.decode_chunk < 1:
        problems.append(f"decode_chunk={sv.decode_chunk} must be >= 1")
    if sv.spec_k < 0:
        problems.append(f"spec_k={sv.spec_k} must be >= 0")
    if sv.spec_k and sv.temperature != 0.0 and not sv.spec_verify_sampled():
        # temperature>0 + spec_k is legal since the rejection-sampled
        # verify; the wall now guards only the PINNED exact-match path
        problems.append(
            f"spec_k={sv.spec_k} with temperature={sv.temperature:g} and "
            "spec_sampled=False: the pinned exact-match verify emits "
            "greedy successors and is only exact at temperature=0 — drop "
            "spec_sampled=False (auto selects the rejection-sampled "
            "verify at temperature>0) or set temperature=0 "
            "(ServingEngine refuses this config)"
        )
    if sv.draft_model and not sv.spec_k:
        problems.append(
            f"draft_model={sv.draft_model!r} with spec_k=0: the draft "
            "model has nothing to draft for — set spec_k > 0 "
            "(ServingEngine refuses this config)"
        )
    n_blocks = sv.num_pool_blocks(plan.seq_len) if sv.block_size >= 1 else 0
    if sv.block_size >= 1 and n_blocks < 2:
        problems.append(
            f"pool of {n_blocks} block(s) cannot serve anything (block 0 is "
            "the reserved trash block; KVPool needs >= 2)"
        )
    headroom = sv.reserve_headroom_blocks() if (
        sv.block_size >= 1 and sv.decode_chunk >= 1 and sv.spec_k >= 0
    ) else 0
    if (
        sv.max_blocks is not None and sv.block_size >= 1 and n_blocks >= 2
        and n_blocks - 1 < headroom + 1
    ):
        # full-coverage pools (max_blocks=None) bound every slot at the
        # window, so only hand-sized pools can under-provision the K-step
        # reservation the chunked/speculative decode path holds per slot
        if sv.draft_model:
            # n_blocks is already draft-aware (num_pool_blocks subtracts
            # the carve-out), so name the knob that actually shrank it
            n_draft = sv.num_draft_blocks(plan.seq_len)
            problems.append(
                f"draft_share={sv.draft_share:g} carves {n_draft} of "
                f"max_blocks={sv.max_blocks} block(s) for the draft "
                f"pool, leaving the target {n_blocks - 1} usable "
                f"block(s) — below one slot's {headroom}-block "
                f"chunk-reservation headroom (decode_chunk="
                f"{sv.decode_chunk}, spec_k={sv.spec_k}, double_buffer="
                f"{sv.double_buffer}) plus its first write; shrink "
                "draft_share or grow max_blocks"
            )
        else:
            problems.append(
                f"max_blocks={sv.max_blocks}: {n_blocks - 1} usable "
                f"block(s) cannot hold one slot's {headroom}-block chunk "
                f"reservation headroom (decode_chunk={sv.decode_chunk}, "
                f"spec_k={sv.spec_k}, double_buffer={sv.double_buffer}) "
                "plus its first write"
            )
    for p in problems:
        findings.append(_finding(plan, "bad-serving-config", p))
    # open-system server sizing (server/frontend.py): only when the plan
    # declares an admission queue — replay configs (admission_queue=None)
    # never trip these, because without a front door the queue-vs-pool
    # interaction does not exist
    if sv.admission_queue is not None:
        q = sv.admission_queue
        if q < 1:
            findings.append(_finding(
                plan, "bad-server-config",
                f"admission_queue={q} rejects every arrival: the server "
                "would answer nothing but 429s (need >= 1; None defaults "
                f"to {4 * sv.max_batch} = 4 x max_batch)",
            ))
        elif (
            sv.max_blocks is not None and sv.block_size >= 1
            and n_blocks >= 2 and headroom
            and n_blocks - 1 < sv.max_batch * headroom
        ):
            # a bounded-queue front-end keeps every decode slot occupied
            # under sustained load (that is its job), so unlike the
            # one-slot replay bound above, the pool must hold EVERY
            # slot's chunk-reservation headroom at once — below that the
            # saturated steady state is preemption thrash: each chunk
            # reservation evicts a neighbor, recompute work crowds out
            # serving work, and goodput collapses exactly when traffic
            # peaks
            findings.append(_finding(
                plan, "bad-server-config",
                f"admission_queue={q} keeps all {sv.max_batch} slots "
                f"occupied under load, but max_blocks={sv.max_blocks} "
                f"leaves {n_blocks - 1} usable block(s) < max_batch x "
                f"{headroom}-block reservation headroom "
                f"({sv.max_batch * headroom}): the saturated steady state "
                "is preemption thrash — grow the pool or shrink "
                "max_batch/decode_chunk",
            ))
    # unified-step token budget: the mixed batch packs one decode token per
    # live slot FIRST, then prefill chunk tokens — a budget at or below
    # max_batch starves prefill forever (the engine refuses it too).  The
    # budget never changes the pool geometry, so the pool-byte estimates
    # below stay byte-exact vs the live engine whatever it is.
    if sv.max_batch >= 1 and sv.prefill_chunk >= 0:
        budget = sv.resolved_token_budget()
        if budget <= sv.max_batch:
            suggested = sv.max_batch + max(1, sv.prefill_chunk)
            findings.append(_finding(
                plan, "bad-token-budget",
                f"token_budget={budget} <= max_batch={sv.max_batch}: every "
                "unified step packs one decode token per live slot before "
                "any prefill token, so this budget leaves prefill zero "
                f"room; set token_budget >= {suggested} (max_batch + "
                "prefill_chunk) or leave it None for that default",
            ))
    if sv.block_size >= 1:
        tp = _serving_tp(plan)
        # itemized per-block cost (config.ServingConfig.block_bytes): the
        # ONE formula pool construction, this breakdown and the --hbm-gb
        # fit share.  Unknown kv_dtype names refuse here (dtype_bytes) —
        # the same wall the engine raises at construction
        try:
            bb = sv.block_bytes(plan.cfg, plan.kv_dtype)
        except ValueError as e:
            findings.append(_finding(
                plan, "bad-serving-config",
                f"kv_dtype {sv.resolved_kv_dtype(plan.kv_dtype)!r}: {e}",
            ))
            return
        breakdown["kv_pool"] = {
            "num_blocks": n_blocks,
            "block_size": sv.block_size,
            "kv_dtype": bb["kv_dtype"],
            "pool_bytes": sv.pool_bytes(plan.cfg, plan.seq_len, plan.kv_dtype),
            # the int8 side arrays (per-block-per-group f32 scales), 0 at
            # any fp dtype — pool_bytes already includes them
            "scale_bytes": n_blocks * bb["scale_bytes"],
            # per-device slice of the tp-sharded pool (== pool_bytes / tp,
            # exactly: the KV-group axis divides or bad-serving-mesh fires)
            "pool_bytes_per_device": sv.pool_bytes_per_device(
                plan.cfg, tp, plan.seq_len, plan.kv_dtype
            ),
            "tp": tp,
            # blocks the --hbm-gb budget admits after params+activations;
            # filled in by the memory checker when a budget is given
            "blocks_at_budget": None,
            "decode_chunk": sv.decode_chunk,
            "spec_k": sv.spec_k,
            "reserve_headroom_blocks": headroom,
            "token_budget": sv.resolved_token_budget(),
            # open-system bound (None for replay configs): the
            # bad-server-config checker sized it against the headroom
            "admission_queue": sv.admission_queue,
            # host KV tier (serving/host_tier.py): whole-block slab bytes,
            # byte-exact vs the live HostBlockStore (the MiB budget rounds
            # down to full tp=1 blocks); 0/0 when the tier is off
            "host_pool_bytes": sv.host_pool_bytes(plan.cfg, plan.kv_dtype),
            "host_blocks": sv.num_host_blocks(plan.cfg, plan.kv_dtype),
        }
        if sv.draft_model:
            # speculative draft model: its paged-pool carve-out, priced
            # with the DRAFT architecture's block_bytes — byte-exact
            # against the live engine's second KVPool
            # (ServingEngine._init_draft_kv)
            try:
                dcfg = sv.draft_config()
            except ValueError as e:
                findings.append(_finding(
                    plan, "bad-serving-config",
                    f"draft_model={sv.draft_model!r}: {e}",
                ))
                dcfg = None
            if dcfg is not None:
                breakdown["kv_pool"].update({
                    "draft_model": sv.draft_model,
                    "draft_num_blocks": sv.num_draft_blocks(plan.seq_len),
                    "draft_pool_bytes": sv.draft_pool_bytes(
                        dcfg, 1, plan.seq_len, plan.kv_dtype
                    ),
                    "draft_pool_bytes_per_device": sv.draft_pool_bytes(
                        dcfg, tp, plan.seq_len, plan.kv_dtype
                    ),
                })
                if dcfg.padded_vocab_size != plan.cfg.padded_vocab_size:
                    findings.append(_finding(
                        plan, "bad-serving-config",
                        f"draft_model={sv.draft_model!r} padded vocab "
                        f"{dcfg.padded_vocab_size} != target "
                        f"{plan.cfg.padded_vocab_size}: the rejection "
                        "verify compares token ids, so drafter and "
                        "verifier must share a vocabulary "
                        "(ServingEngine refuses this config)",
                    ))
        _check_host_tier(plan, sv, findings, breakdown)
        _check_kernel_tuning(plan, findings, breakdown, bb)
        pp = _serving_pp(plan)
        if pp > 1 and plan.cfg.n_layer >= pp:
            from mdi_llm_tpu_torch.parallel.partition import stage_layers

            # per-stage pool shards (serving/pipeline.py): stage s stores
            # its own stage_layers[s] layers of every block, unpadded (the
            # JAX ring pads every stage to l_max).  block_bytes is
            # layer-proportional and divisible by n_layer, so the integer
            # rescale below is EXACT against the live {stage: pool} tree;
            # the device budget is the largest stage's (l_max)
            counts = stage_layers(plan.cfg.n_layer, pp)
            l_max = max(counts)
            L = plan.cfg.n_layer

            def per_stage(b, layers):
                return n_blocks * (b["kv_bytes"] // L * layers
                                   + b["scale_bytes"] // L * layers)

            bb_tp = sv.block_bytes(plan.cfg, plan.kv_dtype, tp=tp)
            breakdown["kv_pool"].update({
                "pp": pp,
                "stage_layers": counts,
                "l_max": l_max,
                # each stage's shard (tp=1 bytes), and the per-device slice
                # of the largest; the stages total the unstaged pool
                "pool_bytes_per_stage": [per_stage(bb, c) for c in counts],
                "pool_bytes_per_device": per_stage(bb_tp, l_max),
                "pool_bytes": sum(per_stage(bb, c) for c in counts),
            })


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _liveness_act_bytes(plan: PlanSpec) -> Optional[int]:
    """The liveness-derived activation high-water of an engine-enumerable
    serving plan: the worst step's temporaries' peak from the liveness
    pass over its traced graphs (`analysis/liveness.py`), replacing the
    analytic term with a per-step number.  None when the engine cannot be
    built abstractly (no serving config, a dp/ep/pipe mesh, a broken plan):
    the caller keeps the heuristic.  Still no card: the steps are traced
    on the meta device, K1's split planned for the plan's card."""
    if plan.serving is None:
        return None
    if any(n not in ("tp", "pp") for n in plan.mesh.names):
        return None  # dp/ep/pipe plans are not serving-engine-enumerable
    try:
        from mdi_llm_tpu_torch.analysis.ir import trace_engine, trace_serving
        from mdi_llm_tpu_torch.analysis.liveness import analyze_flow

        engine = trace_serving(
            plan.cfg, plan.serving, tp=plan.mesh.size("tp"), pp=plan.mesh.size("pp"),
            dtype=plan.dtype, quantize=plan.quantize, max_seq_length=plan.max_seq_length,
        )
        kind = plan.device_kind if plan.device_kind not in (None, "cpu") else None
        _, profiles = analyze_flow(trace_engine(engine, kind), origin=plan.origin)
    except Exception:
        return None  # a broken plan audits with the heuristic instead
    if not profiles:
        return None
    return max(p.temp_peak_bytes for p in profiles)


def audit_plan(plan: PlanSpec, liveness: bool = False) -> AuditReport:
    """Run every checker family; never touches a card or allocates.
    `liveness=True` swaps the analytic activation high-water for the
    liveness pass's per-step number whenever the plan is
    serving-engine-enumerable (`_liveness_act_bytes`; the heuristic
    otherwise)."""
    findings: List[Finding] = []
    breakdown: Dict[str, Any] = {}
    _check_mesh(plan, findings)
    _check_stages(plan, findings, breakdown)
    _check_sharding(plan, findings)
    _check_serving(plan, findings, breakdown)
    _check_schedule(plan, findings, breakdown)
    _check_memory(plan, findings, breakdown, liveness=liveness)
    order = {code: i for i, code in enumerate(AUDIT_RULES)}
    findings.sort(key=lambda f: (order.get(f.rule, 99), f.message))
    return AuditReport(plan=plan, findings=findings, breakdown=breakdown)


def preflight(
    cfg: Config,
    *,
    n_stages: int = 0,
    pipeline: Optional[bool] = None,
    tp: int = 1,
    pp: int = 1,
    samples_per_slot: int = 1,
    n_samples: Optional[int] = None,
    batch: int = 1,
    seq_len: Optional[int] = None,
    kv_seq_len: Optional[int] = None,
    act_seq_len: int = 1,
    dtype: str = "bfloat16",
    cache_dtype: Optional[str] = None,
    quantize: Optional[str] = None,
    serving: Optional[ServingConfig] = None,
    hbm_gb: Optional[float] = None,
    host_gb: Optional[float] = None,
    origin: str = "<preflight>",
    device_kind: str = H100,
    liveness: bool = False,
) -> AuditReport:
    """Build the PlanSpec an engine launch implies and audit it.  Shared by
    `cli.serve`, `cli.server` and `cli.starter`; pure host analysis — no
    CUDA context, no allocation, no step captured.  `device_kind` names the
    card (its tuning entry and shared-memory limit; "cpu" for the plain
    route)."""
    S = max(1, int(n_stages or 1))
    axes: Dict[str, int] = {}
    if S > 1:
        axes["pipe"] = S
    if tp > 1:
        axes["tp"] = int(tp)
    if pp > 1:
        # serving-side pipeline axis (serving/pipeline.py): the paged pool
        # holds one shard per stage — distinct from the dense pipeline's
        # n_stages/"pipe" plan axis
        axes["pp"] = int(pp)
    plan = PlanSpec(
        cfg=cfg,
        mesh=MeshSpec.from_dict(axes),
        tp_axis="tp" if tp > 1 else None,
        n_stages=S,
        pipeline=pipeline,
        samples_per_slot=max(1, int(samples_per_slot)),
        n_samples=int(n_samples if n_samples is not None else batch),
        batch=int(batch),
        max_seq_length=seq_len,
        kv_seq_len=kv_seq_len,
        act_seq_len=act_seq_len,
        dtype=dtype,
        cache_dtype=None if cache_dtype in (None, "auto") else cache_dtype,
        quantize=None if quantize in (None, "none") else quantize,
        serving=serving,
        hbm_gb=hbm_gb,
        host_gb=host_gb,
        # the pipeline ring replicates embeddings/head on every stage
        shard_head=not (pipeline if pipeline is not None else S > 1),
        device_kind=device_kind,
        origin=origin,
    )
    return audit_plan(plan, liveness=liveness)


def refusal_text(tool: str) -> str:
    return (f"{tool}: mdi-audit preflight refused the plan "
            "(re-run with --no-preflight to launch anyway)")


def enforce_preflight(
    report: AuditReport,
    tool: str,
    allow: bool = False,
    emit=None,
    exit_: bool = True,
) -> bool:
    """The shared launch gate of `cli.serve` / `cli.server` / `cli.starter`:
    emit every finding prefixed with `tool`, then refuse on ERROR findings
    unless `allow` (--no-preflight).  Returns True when the launch may
    proceed; with ``exit_=False`` a refusal returns False instead of
    raising SystemExit (the starter ships an abort sentinel through its
    run-spec broadcast so the secondaries exit instead of waiting)."""
    if emit is None:
        def emit(line):
            print(line, file=sys.stderr)
    for line in report.render_findings():
        emit(f"{tool}: preflight: {line}")
    if not report.errors or allow:
        return True
    if exit_:
        raise SystemExit(refusal_text(tool))
    return False


def audit_detail(report: AuditReport) -> Dict[str, Any]:
    """The compact record of a report (the JAX bench's `detail.audit`)."""
    dev = report.breakdown.get("per_device", {})
    return {
        "findings": len(report.errors),
        "warnings": len(report.warnings),
        "est_hbm_bytes": int(dev.get("params_bytes", 0) + dev.get("kv_bytes", 0)),
        "est_params_bytes": int(dev.get("params_bytes", 0)),
        "est_kv_bytes": int(dev.get("kv_bytes", 0)),
        "est_act_bytes": int(dev.get("act_bytes", 0)),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mdi_llm_tpu_torch.analysis audit",
        description="Static plan auditor of the port: sharding consistency, "
        "per-device memory budgets, K1 on the card, and pipeline schedule "
        "checks — before any weight reaches the card",
    )
    src = ap.add_argument_group("plan source")
    src.add_argument("--model", default=None, help="registry model name")
    src.add_argument("--config", default=None, metavar="FILE",
                     help="model_config.yaml / config.json to audit")
    src.add_argument("--plan", default=None, metavar="FILE",
                     help="mesh/nodes config JSON (examples/mesh_configs, "
                     "examples/node_configs schemas)")
    par = ap.add_argument_group("parallel plan")
    par.add_argument("--mesh", default=None, metavar="AXES",
                     help="explicit mesh, e.g. pipe=4,tp=2")
    par.add_argument("--stages", type=int, default=None,
                     help="pipeline stages (default: plan file or 1)")
    par.add_argument("--tp", type=int, default=None,
                     help="tensor-parallel devices per stage")
    par.add_argument("--samples-per-slot", type=int, default=None)
    par.add_argument("--n-samples", type=int, default=None,
                     help="concurrent samples (ring bubble check)")
    run = ap.add_argument_group("run shape")
    run.add_argument("--batch", type=int, default=1)
    run.add_argument("--seq-len", type=int, default=None)
    run.add_argument("--prompt-len", type=int, default=1,
                     help="widest live token axis for the activation term")
    run.add_argument("--dtype", default="bfloat16",
                     choices=("bfloat16", "float16", "float32"))
    run.add_argument("--quantize", default="none",
                     choices=("none", "int8", "w8a8", "int4"))
    run.add_argument("--kv-dtype", default="auto",
                     help="KV-cache / paged-pool storage dtype; with "
                     "--serve, 'int8' audits the quantized pool (int8 "
                     "payload + per-block-per-group f32 scales, "
                     "~2x blocks per --hbm-gb); unknown names are refused "
                     "(bad-serving-config)")
    srv = ap.add_argument_group("serving (paged KV pool)")
    srv.add_argument("--serve", action="store_true",
                     help="audit a ServingConfig pool instead of a dense cache")
    srv.add_argument("--block-size", type=int, default=16)
    srv.add_argument("--max-blocks", type=int, default=None)
    srv.add_argument("--max-batch", type=int, default=8)
    srv.add_argument("--prefill-chunk", type=int, default=128)
    srv.add_argument("--token-budget", type=int, default=None,
                     help="unified-step token budget (default: max_batch + "
                     "prefill_chunk)")
    srv.add_argument("--decode-chunk", type=int, default=8)
    srv.add_argument("--spec-k", type=int, default=0,
                     help="speculative draft length (exact-match verify at "
                     "temperature 0, rejection-sampled verify above)")
    srv.add_argument("--temperature", type=float, default=0.0)
    srv.add_argument("--draft-model", default=None, metavar="NAME",
                     help="registry name of a small draft model; audits "
                     "the draft kv-pool carve-out (draft_* breakdown "
                     "fields) and the target-pool headroom left after it")
    srv.add_argument("--draft-share", type=float, default=0.25,
                     help="fraction of a bounded --max-blocks budget "
                     "carved out for the draft pool (default 0.25)")
    srv.add_argument("--host-pool-mib", type=int, default=0,
                     help="host-RAM KV block tier size in MiB (0 = off): "
                     "preempted sequences swap their blocks to pinned host "
                     "slabs instead of recomputing, and cold prefix chains "
                     "spill there (bad-host-tier audits the config)")
    srv.add_argument("--host-link-gbps", type=float, default=None,
                     help="host<->device link bandwidth in GB/s for the "
                     "swap cost model (default: per-device-kind table)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device memory budget in GiB (e.g. 80 for an H100)")
    ap.add_argument("--host-gb", type=float, default=None,
                    help="host-RAM budget for the KV block tier "
                    "(bad-host-tier when --host-pool-mib exceeds it)")
    ap.add_argument("--device-kind", default=H100,
                    help="the card the plan runs on (its K1 tuning entry and "
                    f"shared-memory limit; default {H100!r}); 'cpu' audits "
                    "the plain route")
    ap.add_argument("--liveness", action="store_true",
                    help="activation term from the liveness pass over the "
                    "serving steps traced on the meta device (tp/pp serving "
                    "plans; the heuristic otherwise)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="grandfather findings via an mdi-lint-style baseline")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the audit rule registry and exit")
    return ap


def _plan_from_args(args) -> PlanSpec:
    stages, tp, spslot, n_samples, seq_len = args.stages, args.tp, None, None, args.seq_len
    plan_file: Dict[str, Any] = {}
    origin = "<cli>"
    if args.plan:
        plan_file = json.loads(Path(args.plan).read_text())
        origin = str(args.plan)
        if "nodes" in plan_file:  # reference settings_distr schema
            n_nodes = 1 + len(plan_file["nodes"].get("secondary") or [])
            stages = stages if stages is not None else plan_file.get(
                "pipeline_stages", n_nodes
            )
        else:
            stages = stages if stages is not None else plan_file.get("pipeline_stages")
        tp = tp if tp is not None else plan_file.get("tp_devices")
        spslot = plan_file.get("samples_per_slot")
        n_samples = plan_file.get("n_samples")
        seq_len = seq_len if seq_len is not None else plan_file.get("sequence_length")

    if args.config:
        cfg = Config.from_file(args.config)
    elif args.model:
        cfg = Config.from_name(args.model)
    elif plan_file.get("model"):
        cfg = Config.from_name(plan_file["model"])
    else:
        raise ValueError("need --model, --config, or a plan file with a "
                         "'model' key")

    stages = int(stages or 1)
    tp = int(tp or 1)
    spslot = int(args.samples_per_slot if args.samples_per_slot is not None
                 else (spslot or 1))
    n_samples = int(args.n_samples if args.n_samples is not None
                    else (n_samples or args.batch))

    if args.mesh is not None:
        mesh = MeshSpec.parse(args.mesh)
    else:
        axes: Dict[str, int] = {}
        if stages > 1:
            axes["pipe"] = stages
        if tp > 1:
            axes["tp"] = tp
        if "mesh" in plan_file:  # training mesh schema (train_dp4_tp2.json)
            axes = dict(plan_file["mesh"])
            tp = int(axes.get("tp", tp))
        mesh = MeshSpec.from_dict(axes)

    serving = None
    if args.serve:
        serving = ServingConfig(
            block_size=args.block_size,
            max_blocks=args.max_blocks,
            max_batch=args.max_batch,
            prefill_chunk=args.prefill_chunk,
            token_budget=args.token_budget,
            decode_chunk=args.decode_chunk,
            spec_k=args.spec_k,
            temperature=args.temperature,
            draft_model=args.draft_model,
            draft_share=args.draft_share,
            # the pool dtype rides --kv-dtype (e.g. int8 for the quantized
            # pool: payload + scale bytes both audited); unknown names
            # surface as bad-serving-config, exactly like the engine
            kv_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
            host_pool_mib=args.host_pool_mib,
            host_link_gbps=args.host_link_gbps,
        )
    return PlanSpec(
        cfg=cfg,
        mesh=mesh,
        tp_axis="tp" if ("tp" in mesh.names or tp > 1) else None,
        n_stages=stages,
        samples_per_slot=spslot,
        n_samples=n_samples,
        batch=args.batch,
        max_seq_length=seq_len,
        act_seq_len=args.prompt_len,
        dtype=args.dtype,
        cache_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
        quantize=None if args.quantize == "none" else args.quantize,
        serving=serving,
        hbm_gb=args.hbm_gb,
        host_gb=args.host_gb,
        shard_head=stages <= 1,
        device_kind=args.device_kind,
        origin=origin,
    )


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checks:
        width = max(len(c) for c in AUDIT_RULES)
        for code, (sev, summary) in AUDIT_RULES.items():
            print(f"{code:<{width}}  [{sev}] {summary}")
        return 0
    try:
        plan = _plan_from_args(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"mdi-audit: {e}", file=sys.stderr)
        return 2
    report = audit_plan(plan, liveness=args.liveness)

    errors = report.errors
    if args.baseline:
        new, _old = Baseline.load(Path(args.baseline)).split(errors)
        errors = new

    if args.format == "json":
        out = report.as_json()
        out["new_errors"] = len(errors)
        print(json.dumps(out, indent=2))
    else:
        print(report.render_text())
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
