"""K2: flash self-attention over one fresh chunk — the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel `_flash_kernel` (mdi_llm_tpu/ops/flash.py:40),
the forward of `flash_attention` and `flash_attention_lse`.  Queries and
keys are the same chunk (q_pos == k_pos == arange(T)): q is
`(B, n_head, T, hs)`, k/v are `(B, n_query_groups, T, hs)`, and head h reads
group `h // (n_head // G)`.  Key j is valid for query i iff j <= i
(causal) — every key when `causal=False`.  The logits and the softmax
are float32, q is scaled before the QK product and P stays float32
through the PV product (the TPU kernel's order); the output is in q's
dtype, the LSE `(B, n_head, T)` float32, `NEG_INF` on a row that saw no key.

- `flash_attention` (causal) and `flash_attention_lse` are the wrappers.
  A CPU tensor goes to the plain version; a CUDA tensor launches the
  hand-written kernel (`csrc/flash_attention.cu`, built on first use by
  `mdi_llm_tpu_torch.kernels`) or raises.  There is no fallback from the
  kernel to the plain version; `use_kernel=False` asks for the plain
  version on any device (the on-card parity check uses it).
  `flash_attention.launches` counts kernel launches of both wrappers and
  nothing else; `flash_attention_plain.calls` counts the plain version.
- The TPU tile arguments (`block_q`, `block_k`, `interpret`) do not carry
  over: the kernel has its own tile constants.
- No backward: the FlashAttention-2 backward kernels (K3, K4) are not
  ported, and an input that requires grad under grad mode is refused.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mdi_llm_tpu_torch import kernels
from mdi_llm_tpu_torch.ops.attention import NEG_INF

__all__ = [
    "flash_attention",
    "flash_attention_lse",
    "flash_attention_plain",
    "masked_attention",
    "KERNEL_HEAD_SIZES",
]

KERNEL_HEAD_SIZES = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def masked_attention(q, k, v, mask, scale):
    """Dense softmax attention under a boolean `mask` (Tq, Tk), GQA by
    head grouping, in the TPU kernel's arithmetic: f32 logits of the
    pre-scaled q, f32 P through PV.  Returns (out in q's dtype, f32 lse),
    with out 0 and lse `NEG_INF` on rows that see no key."""
    B, H, T, hs = q.shape
    G = k.shape[1]
    qg = q.reshape(B, G, H // G, T, hs).float() * scale
    s = torch.einsum("bgqth,bgsh->bgqts", qg, k.float())
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)  # -inf where the row sees no key
    live = torch.isfinite(lse)
    p = torch.exp(s - torch.where(live, lse, torch.zeros_like(lse))[..., None])
    out = torch.einsum("bgqts,bgsh->bgqth", p, v.float())
    lse = torch.where(live, lse, torch.full_like(lse, NEG_INF))
    return out.reshape(B, H, T, hs).to(q.dtype), lse.reshape(B, H, T)


def flash_attention_plain(q, k, v, scale=None, causal=True):
    """The plain PyTorch version of K2: (out, lse)."""
    flash_attention_plain.calls += 1
    T = q.shape[2]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    idx = torch.arange(T, device=q.device)
    if causal:
        mask = idx[None, :] <= idx[:, None]
    else:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device)
    return masked_attention(q, k, v, mask, scale)


flash_attention_plain.calls = 0


def _check_args(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be (B, n_head, T, hs) and k, v (B, G, T, hs); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, T, hs = q.shape
    if k.shape[0] != B or k.shape[2] != T or k.shape[3] != hs:
        raise ValueError("flash path is self-attention over one chunk")
    if H % k.shape[1]:
        raise ValueError(f"n_head={H} must be a multiple of G={k.shape[1]}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward in mdi_llm_tpu_torch yet: the "
            "FlashAttention-2 backward kernels K3/K4 are not ported "
            "(ROADMAP Queue 2); run it under torch.no_grad()"
        )


def _lib():
    lib = kernels.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * 5 + [i] * 4 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, scale, causal, with_lse):
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    B, H, T, hs = q.shape
    G = k.shape[1]
    if hs not in KERNEL_HEAD_SIZES:
        raise ValueError(f"head size {hs}: the kernel is built for {KERNEL_HEAD_SIZES}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: the kernel takes "
            "float32 or bfloat16, the same for all three"
        )
    for x in (k, v):
        if x.device != q.device:
            raise ValueError(f"every argument must be on {q.device}, got {x.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        _KERNEL_DTYPES[q.dtype], hs, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None, B, H, G, T,
        float(scale), int(bool(causal)), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}"
        )
    flash_attention.launches += 1
    return out, lse


def flash_attention_lse(
    q: torch.Tensor,  # (B, n_head, T, hs)
    k: torch.Tensor,  # (B, n_groups, T, hs)
    v: torch.Tensor,  # (B, n_groups, T, hs)
    scale: Optional[float] = None,
    causal: bool = True,
    *,
    use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 with its per-query logsumexp: (out (B, n_head, T, hs), lse
    (B, n_head, T) float32).  `causal=False` attends the whole chunk."""
    _check_args(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if use_kernel is None:
        use_kernel = q.device.type != "cpu"
    if not use_kernel:
        return flash_attention_plain(q, k, v, scale, causal)
    return _launch(q, k, v, scale, causal, with_lse=True)


def flash_attention(
    q: torch.Tensor,  # (B, n_head, T, hs)
    k: torch.Tensor,  # (B, n_groups, T, hs)
    v: torch.Tensor,  # (B, n_groups, T, hs)
    scale: Optional[float] = None,
    *,
    use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> torch.Tensor:
    """K2, causal: (B, n_head, T, hs) in q's dtype."""
    _check_args(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if use_kernel is None:
        use_kernel = q.device.type != "cpu"
    if not use_kernel:
        return flash_attention_plain(q, k, v, scale, True)[0]
    return _launch(q, k, v, scale, True, with_lse=False)[0]


flash_attention.launches = 0
