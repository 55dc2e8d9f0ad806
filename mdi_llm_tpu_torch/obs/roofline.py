"""Serving roofline accounting: analytic FLOPs/bytes per token, device
peaks, and achieved MFU/MBU.

Port of `mdi_llm_tpu/obs/roofline.py` over the port's `config.py`:

- analytic per-token decode/prefill FLOPs from `Config` (forward-only:
  the 2·params matmul term minus the gather-only embedding, plus the
  4·L·H·hs·S attention term);
- analytic HBM bytes per decode token, `kv_dtype`/`block_bytes`-aware:
  the int8 paged pool gets credit for its smaller blocks (scale arrays
  included) because the byte model routes through
  `ServingConfig.block_bytes`, the per-block formula the engine allocates
  by;
- a device-peak table keyed on `torch.cuda.get_device_name()`: one row,
  the SXM H100 ("NVIDIA H100 80GB HBM3"), at NVIDIA's published dense
  bf16 rate and HBM bandwidth (989 TFLOP/s, 3350 GB/s at the 700 W
  limit).  Every other kind (the CPU, other GPUs, the PCIe and NVL H100
  parts with their other peaks) maps to None, and every derived
  utilization reports null rather than a guess;
- achieved MFU/MBU from measured tokens/s.

The analytic FLOPs model is cross-checked against the operations a step
actually runs (`obs/device.py`: `FlopCounterMode` over the step's eager
run, the kernels' static-shape counts added) within
`FLOP_AGREEMENT_RTOL`, pinned by tests/test_torch_obs_device.py.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from mdi_llm_tpu_torch.config import Config, ServingConfig, dtype_bytes

__all__ = [
    "DEVICE_PEAKS",
    "FLOP_AGREEMENT_RTOL",
    "normalize_device_kind",
    "device_peaks",
    "decode_flops_per_token",
    "prefill_flops_per_token",
    "decode_hbm_bytes_per_token",
    "param_bytes",
    "serving_roofline",
    "crosscheck_flops",
]

# Dense bf16 peak compute and HBM bandwidth per card (NVIDIA's data sheet
# for the H100 SXM part, no sparsity); chip_smoke.py's bounds use the same.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}

# Analytic-vs-counted agreement bound for the FLOPs model
# (crosscheck_flops): the analytic model counts matmul + attention terms
# only; a step also samples, and its plain route attends over the whole
# table window.  The JAX package's tolerance for the same check
# (`XLA_AGREEMENT_RTOL`), so a real model drift (a forgotten projection, a
# doubled attention term) fails loudly.
FLOP_AGREEMENT_RTOL = 0.25


def normalize_device_kind(device_kind: Optional[str]) -> Optional[str]:
    """Map a `torch.cuda.get_device_name()` string to its DEVICE_PEAKS key,
    or None for kinds the table does not know.  Only the SXM H100 ("NVIDIA
    H100 80GB HBM3") maps: the PCIe ("NVIDIA H100 PCIe") and NVL parts
    have other peaks."""
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    if "h100" in kind and "hbm3" in kind:
        return "h100"
    return None


def device_peaks(device_kind: Optional[str]) -> Optional[Dict[str, float]]:
    """Map a device name to its peak row, or None for kinds the table does
    not know — callers must treat None as "report null utilization",
    never assume a card."""
    norm = normalize_device_kind(device_kind)
    return DEVICE_PEAKS[norm] if norm else None


def _linear_flops_per_token(cfg: Config) -> float:
    """Matmul FLOPs per token through the weights: 2 MACs per weight for
    every LINEAR parameter.  The token embedding is a gather (no FLOPs),
    so one V·D is subtracted from `estimate_params`; the lm_head matmul
    always runs — for tied embeddings it reuses the subtracted wte, so
    the V·D goes back in.  A mixture-of-experts config counts all E
    experts (`estimate_params`): the dense formulation the port runs
    (`transformer.moe_forward`) does E / top-k times a routed model's
    expert work, and its MFU is that of the work done."""
    N = cfg.estimate_params()
    emb = cfg.padded_vocab_size * cfg.n_embd
    lin = N - emb
    if cfg.tie_embeddings:
        lin += emb
    return 2.0 * lin


def decode_flops_per_token(cfg: Config, context: int) -> float:
    """Forward FLOPs to generate ONE token with `context` KV positions
    resident: 2·params(linear) + 4·L·H·hs·context (QKᵀ and A·V, 2 FLOPs
    per MAC each)."""
    attn = 4.0 * cfg.n_layer * cfg.n_head * cfg.head_size * int(context)
    return _linear_flops_per_token(cfg) + attn


def prefill_flops_per_token(cfg: Config, prompt_len: int) -> float:
    """Mean forward FLOPs per PROMPT token: position p attends p+1
    positions, so the causal average over a T-token prompt is (T+1)/2."""
    return decode_flops_per_token(cfg, (int(prompt_len) + 1) // 2)


def param_bytes(params: Any) -> int:
    """Exact device bytes of a live parameter tree (the port's nested
    dicts of tensors).  Shapes and dtypes only — no sync, no transfer."""
    from mdi_llm_tpu_torch.models import transformer

    total = 0
    for leaf in transformer.tree_leaves(params):
        n = int(math.prod(getattr(leaf, "shape", ()) or (1,)))
        total += n * dtype_bytes(leaf.dtype)
    return total


def decode_hbm_bytes_per_token(
    cfg: Config,
    serving: Optional[ServingConfig],
    batch: int,
    context: int,
    weight_bytes: int,
    dtype: str = "bfloat16",
) -> Dict[str, float]:
    """Analytic HBM traffic to decode ONE token at batch `batch` with
    `context` resident KV positions.

    Decode is bandwidth-bound: every step streams all weights once
    (shared by the whole batch → weight_bytes / batch per token) and
    reads the sequence's live KV.  With a paged pool the read granularity
    is whole blocks — ceil(context / block_size) × `ServingConfig.
    block_bytes` (payload at the POOL dtype plus the int8 scale arrays);
    pass `serving=None` for a dense contiguous cache (2·L·G·hs·context at
    `dtype`).  The per-token KV write (one position's k+v) rides along;
    activations are ignored.
    """
    batch = max(1, int(batch))
    context = int(context)
    if serving is not None:
        bb = serving.block_bytes(cfg, dtype)
        n_blocks = -(-context // serving.block_size) if context else 0
        kv_read = float(n_blocks * bb["total_bytes"])
        kv_write = bb["kv_bytes"] / serving.block_size
        kv_dtype = bb["kv_dtype"]
    else:
        item = dtype_bytes(dtype)
        kv_read = float(
            2 * cfg.n_layer * cfg.n_query_groups * cfg.head_size * context * item
        )
        kv_write = float(2 * cfg.n_layer * cfg.n_query_groups * cfg.head_size * item)
        kv_dtype = dtype
    weights = weight_bytes / batch
    return {
        "weight_bytes": weights,
        "kv_read_bytes": kv_read,
        "kv_write_bytes": kv_write,
        "kv_dtype": kv_dtype,
        "total_bytes": weights + kv_read + kv_write,
    }


def serving_roofline(
    cfg: Config,
    serving: Optional[ServingConfig],
    tokens_per_s: float,
    context: int,
    batch: int,
    weight_bytes: int,
    device_kind: Optional[str],
    n_chips: int = 1,
    dtype: str = "bfloat16",
) -> Dict[str, Any]:
    """Achieved MFU/MBU of a serving run: measured `tokens_per_s` times the
    analytic per-token FLOPs/bytes at the run's mean `context` and
    effective `batch`, over `n_chips` × the device peak.  Unknown
    `device_kind` → `mfu`/`mbu` are None, but the achieved absolute rates
    still report.  Embedded in the serve CLI's stats line (`device`)."""
    peaks = device_peaks(device_kind)
    flops_tok = decode_flops_per_token(cfg, context)
    bytes_tok = decode_hbm_bytes_per_token(
        cfg, serving, batch, context, weight_bytes, dtype=dtype
    )
    achieved_flops = tokens_per_s * flops_tok
    achieved_bytes = tokens_per_s * bytes_tok["total_bytes"]
    n_chips = max(1, int(n_chips))
    out: Dict[str, Any] = {
        "device_kind": device_kind,
        "peaks": peaks,
        "n_chips": n_chips,
        "context_mean": int(context),
        "batch": int(batch),
        "flops_per_token": flops_tok,
        "hbm_bytes_per_token": bytes_tok,
        "achieved_tflops_per_s": achieved_flops / 1e12,
        "achieved_hbm_gbps": achieved_bytes / 1e9,
        "mfu": None,
        "mbu": None,
    }
    if peaks is not None:
        out["mfu"] = achieved_flops / (n_chips * peaks["bf16_tflops"] * 1e12)
        out["mbu"] = achieved_bytes / (n_chips * peaks["hbm_gbps"] * 1e9)
    return out


def crosscheck_flops(report, analytic_flops: float,
                     rtol: float = FLOP_AGREEMENT_RTOL) -> Dict[str, Any]:
    """Compare an `ExecutableReport`'s counted FLOPs against the analytic
    model's number for the same step.  `agrees` is None when the report
    has no FLOPs (nothing to judge), else whether the relative error is
    within `rtol`."""
    counted = getattr(report, "flops", None)
    out: Dict[str, Any] = {
        "executable": getattr(report, "name", str(report)),
        "counted_flops": counted,
        "analytic_flops": float(analytic_flops),
        "rtol": rtol,
        "rel_err": None,
        "agrees": None,
    }
    if counted is not None and analytic_flops > 0:
        rel = abs(counted - analytic_flops) / analytic_flops
        out["rel_err"] = rel
        out["agrees"] = rel <= rtol
    return out
