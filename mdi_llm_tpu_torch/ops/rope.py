"""Rotary position embeddings (litGPT convention).

Port of `mdi_llm_tpu/ops/rope.py`.  The cos/sin tables are built in NumPy
on the host, exactly as the JAX package builds them, and moved to the
caller's device once.  `gather_rope` clamps positions into the table:
padding tokens of the mixed serving step carry a position past the table
on purpose (their K/V lands in the trash block), and unclamped indexing
would raise on the CPU and trip a device-side assert on CUDA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_rope_cache(
    seq_len: int,
    n_elem: int,
    base: int = 10000,
    condense_ratio: int = 1,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin) as NumPy arrays of shape (seq_len, n_elem):
    theta_i = 1 / base^(2i/n_elem), the half table repeated twice."""
    if n_elem <= 0:
        z = np.zeros((seq_len, 0), dtype=dtype)
        return z, z
    theta = 1.0 / (base ** (np.arange(0, n_elem, 2, dtype=np.float32) / n_elem))
    pos = np.arange(seq_len, dtype=np.float32) / condense_ratio
    idx_theta = np.outer(pos, theta)
    idx_theta = np.concatenate([idx_theta, idx_theta], axis=-1)
    return np.cos(idx_theta).astype(dtype), np.sin(idx_theta).astype(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the leading `n_elem` channels of each head: x is
    (..., T, n_elem), cos/sin broadcast to it; rotated = cat(-x2, x1)."""
    n = x.shape[-1]
    x1 = x[..., : n // 2]
    x2 = x[..., n // 2 :]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


def gather_rope(
    cos: torch.Tensor, sin: torch.Tensor, input_pos: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index the rope tables at `input_pos` (any shape), clamped into the
    table; returns input_pos.shape + (n_elem,)."""
    idx = input_pos.long().clamp(0, cos.shape[0] - 1)
    return cos[idx], sin[idx]
