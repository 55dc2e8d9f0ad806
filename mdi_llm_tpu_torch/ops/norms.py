"""Normalization layers as plain functions on tensors.

Port of `mdi_llm_tpu/ops/norms.py`: RMSNorm (with the Gemma unit-offset
variant) and LayerNorm with an optional bias.  Accumulation is float32,
cast back to the input dtype at the end, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    add_unit_offset: bool = False,
) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if add_unit_offset:
        w = 1.0 + w
    return (norm * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
