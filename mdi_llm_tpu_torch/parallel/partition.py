"""Layer -> stage partition policy.

Port of `mdi_llm_tpu/parallel/partition.py`: the reference's hand-tuned
`N_LAYERS_NODES` table kept verbatim as overrides, a balanced split that
discounts stage 0 (it also runs the embedding, the final norm, the head
and sampling) everywhere else.  Stage parameters are leading-axis slices
of the layer-stacked block tree (`models.transformer.slice_blocks`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.models.transformer import Params, slice_blocks, tree_map

# Reference-parity overrides: {n_stages: {n_layer: [stage0, stage1, ...]}}
_REFERENCE_TABLE: Dict[int, Dict[int, List[int]]] = {
    1: {n: [n] for n in (5, 7, 9, 12, 22, 24, 32, 36, 48)},
    2: {
        5: [2, 3],
        7: [3, 4],
        9: [4, 5],
        12: [5, 7],
        22: [10, 12],
        24: [10, 14],
        32: [14, 18],
        36: [16, 20],
        48: [22, 26],
    },
    3: {
        5: [1, 2, 2],
        7: [1, 3, 3],
        9: [1, 4, 4],
        12: [2, 5, 5],
        22: [6, 8, 8],
        24: [4, 10, 10],
        32: [8, 12, 12],
        36: [10, 13, 13],
        48: [14, 17, 17],
    },
    4: {22: [4, 6, 6, 6], 32: [5, 9, 9, 9]},
    5: {22: [2, 5, 5, 5, 5], 32: [4, 7, 7, 7, 7]},
}


def stage_layers(
    n_layer: int, n_stages: int, starter_fraction: float = 0.8
) -> List[int]:
    """Transformer blocks per pipeline stage: the reference table's entry
    where it has one, else a balanced split with stage 0 weighted by
    `starter_fraction`.  Sums to `n_layer`; every stage gets >= 1 layer."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layer < n_stages:
        raise ValueError(
            f"cannot split {n_layer} layers over {n_stages} stages: every "
            f"stage needs >= 1 transformer block — use n_stages <= {n_layer} "
            "(--pipeline-stages) or a deeper model"
        )
    ref = _REFERENCE_TABLE.get(n_stages, {}).get(n_layer)
    if ref is not None:
        counts = list(ref)
    elif n_stages == 1:
        counts = [n_layer]
    else:
        weights = [starter_fraction] + [1.0] * (n_stages - 1)
        total_w = sum(weights)
        counts = [max(1, int(n_layer * w / total_w)) for w in weights]
        # the remainder goes to the non-starter stages, last first
        i = n_stages - 1
        while sum(counts) < n_layer:
            counts[i] += 1
            i = n_stages - 1 if i <= 1 else i - 1
        while sum(counts) > n_layer:
            j = max(range(n_stages), key=lambda s: (counts[s], s))
            counts[j] -= 1
    if len(counts) != n_stages or sum(counts) != n_layer or min(counts) < 1:
        raise ValueError(
            f"stage split {counts} is invalid for n_layer={n_layer}, "
            f"n_stages={n_stages}: every stage must own >= 1 layer and the "
            f"counts must sum to n_layer"
        )
    return counts


def stage_bounds(n_layer: int, n_stages: int, **kw) -> List[tuple]:
    """[(start, stop) layer index per stage]."""
    bounds, acc = [], 0
    for c in stage_layers(n_layer, n_stages, **kw):
        bounds.append((acc, acc + c))
        acc += c
    return bounds


def split_params(cfg: Config, params: Params, n_stages: int, **kw) -> List[Params]:
    """Per-stage trees: stage 0 holds the embeddings, its block slice, the
    final norm and the head; every other stage its block slice only.  The
    slices are views of the full tree's leaves."""
    stages: List[Params] = []
    for s, (lo, hi) in enumerate(stage_bounds(cfg.n_layer, n_stages, **kw)):
        stage: Params = {"blocks": slice_blocks(params["blocks"], lo, hi)}
        if s == 0:
            for k in ("wte", "wpe", "ln_f", "lm_head"):
                if k in params:
                    stage[k] = params[k]
        stages.append(stage)
    return stages


def _zip_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def pad_stage_blocks(stages: List[Params], l_max: int) -> Params:
    """Every stage's block stack zero-padded to `l_max` layers and stacked
    under a leading stage axis (S, l_max, ...).  A zero-weight block is an
    exact identity (the residual adds zero)."""

    def pad(leaf):
        out = leaf.new_zeros((l_max,) + tuple(leaf.shape[1:]))
        out[: leaf.shape[0]] = leaf
        return out

    padded = [tree_map(pad, s["blocks"]) for s in stages]
    return _zip_map(lambda *xs: torch.stack(xs, dim=0), *padded)


def unpad_stage_blocks(stage_blocks: Params, counts: Sequence[int]) -> Params:
    """Inverse of `split_params` + `pad_stage_blocks`: each stage's padding
    dropped, the stages concatenated back into the (L, ...) stack."""
    return tree_map(
        lambda leaf: torch.cat([leaf[s, : counts[s]] for s in range(len(counts))], dim=0),
        stage_blocks,
    )


def save_stage_manifest(
    out_dir, cfg: Config, n_stages: int, quantize: str = "none", **kw
) -> Path:
    """Write `stage_map.json` describing the partition; `quantize` records
    the chunks' storage mode."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest = {
        "n_stages": n_stages,
        "n_layer": cfg.n_layer,
        "stage_layers": stage_layers(cfg.n_layer, n_stages, **kw),
        "model": cfg.name,
        "quantize": quantize,
    }
    p = out_dir / "stage_map.json"
    p.write_text(json.dumps(manifest, indent=2) + "\n")
    return p
