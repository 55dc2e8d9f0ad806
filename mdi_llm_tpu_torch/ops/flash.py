"""K2, K3, K4: flash self-attention over one fresh chunk and its
FlashAttention-2 backward — the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd Functions that join them.

Replaces the Pallas kernels of mdi_llm_tpu/ops/flash.py: `_flash_kernel`
(K2, the forward of `flash_attention` and `flash_attention_lse`),
`_flash_dq_kernel` (K3) and `_flash_dkv_kernel` (K4), and the
`custom_vjp`s `_flash_core` / `_flash_lse_core` around them.  Queries and
keys are the same chunk (q_pos == k_pos == arange(T)): q is
`(B, n_head, T, hs)`, k/v are `(B, n_query_groups, T, hs)`, and head h reads
group `h // (n_head // G)`.  Key j is valid for query i iff j <= i
(causal) — every key when `causal=False`.  The logits and the softmax
are float32; the output is in q's dtype, the LSE `(B, n_head, T)`
float32, `NEG_INF` on a row that saw no key.  The plain versions and the
float32 kernels scale q before the QK product and keep P float32 through
the PV product (the TPU kernel's order); K2 over bfloat16 inputs runs on
tensor cores, scales the float32 scores and rounds P to bfloat16 for the
PV product (chosen by dtype alone, `csrc/flash_attention.cu`).  K3 and K4
over bfloat16 inputs run on tensor cores too and round P and dS to
bfloat16 as operands of their last products (`csrc/flash_attention_bwd.cu`).

- `flash_attention` (causal) and `flash_attention_lse` are the entry
  points.  When an input requires grad under grad mode they run as one
  `torch.autograd.Function` (`_FlashCore`): the forward
  runs K2 with the LSE and saves (q, k, v, out, lse); the backward forms
  D = rowsum(dO * O) in float32 (minus the LSE's cotangent for
  `flash_attention_lse`), runs K3 for dQ and K4 for dK/dV, which K4
  returns in float32 already summed over each GQA group, and casts those
  to k's dtype.  Otherwise K2 runs alone, without the LSE for
  `flash_attention`.
- Routing, forward and backward alike: a CPU tensor goes to the plain
  versions (`flash_attention_plain`, `flash_dq_plain`, `flash_dkv_plain`),
  a CUDA tensor launches the hand-written kernels (`csrc/flash_attention.cu`
  and `csrc/flash_attention_bwd.cu`, built on first use by
  `mdi_llm_tpu_torch.kernels`) or raises.  There is no fallback from a
  kernel to its plain version; `use_kernel=False` asks for the plain
  versions on any device (the on-card parity checks use it).
- Counters, plain ints: `flash_attention.launches` (K2, both entry
  points), `flash_dq.launches` (K3), `flash_dkv.launches` (K4) count
  kernel launches and nothing else; each plain version counts its
  `.calls`.
- The TPU tile arguments (`block_q`, `block_k`, `interpret`) do not carry
  over: the kernels have their own tile constants.  Nothing is padded, so
  the Pallas kernels' `k < seq_len` and `q < seq_len` masks are all true
  here and only the causal mask remains.
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
    "flash_dq",
    "flash_dkv",
    "flash_dq_plain",
    "flash_dkv_plain",
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


def _chunk_mask(T: int, causal: bool, device) -> torch.Tensor:
    """(T, T) bool: key j valid for query i."""
    if not causal:
        return torch.ones(T, T, dtype=torch.bool, device=device)
    idx = torch.arange(T, device=device)
    return idx[None, :] <= idx[:, None]


def flash_attention_plain(q, k, v, scale=None, causal=True):
    """The plain PyTorch version of K2: (out, lse)."""
    flash_attention_plain.calls += 1
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return masked_attention(q, k, v, _chunk_mask(q.shape[2], causal, q.device), scale)


def _bwd_terms(q, k, v, do, lse, dsum, scale, causal):
    """The FA-2 backward's per-pair terms in float32, grouped
    (B, G, H // G, T, ...): (q, dO, P, dS) with P recomputed from the saved
    LSE as exp(min(s - lse, 80)) and dS = P * (dO V^T - D)."""
    B, H, T, hs = q.shape
    G = k.shape[1]
    qg = q.reshape(B, G, H // G, T, hs).float()
    dog = do.reshape(B, G, H // G, T, hs).float()
    s = scale * torch.einsum("bgrth,bgsh->bgrts", qg, k.float())
    p = torch.exp(torch.clamp(s - lse.reshape(B, G, H // G, T, 1), max=80.0))
    p = torch.where(_chunk_mask(T, causal, q.device), p, torch.zeros_like(p))
    dp = torch.einsum("bgrth,bgsh->bgrts", dog, v.float())
    ds = p * (dp - dsum.reshape(B, G, H // G, T, 1))
    return qg, dog, p, ds


def flash_dq_plain(q, k, v, do, lse, dsum, scale, causal=True):
    """The plain PyTorch version of K3: dQ = scale * dS K, in q's dtype."""
    flash_dq_plain.calls += 1
    _, _, _, ds = _bwd_terms(q, k, v, do, lse, dsum, scale, causal)
    dq = scale * torch.einsum("bgrts,bgsh->bgrth", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, dsum, scale, causal=True):
    """The plain PyTorch version of K4: float32 (dK = scale * dS^T Q,
    dV = P^T dO), each (B, G, T, hs), summed over each group's heads."""
    flash_dkv_plain.calls += 1
    qg, dog, p, ds = _bwd_terms(q, k, v, do, lse, dsum, scale, causal)
    dk = scale * torch.einsum("bgrts,bgrth->bgsh", ds, qg)
    dv = torch.einsum("bgrts,bgrth->bgsh", p, dog)
    return dk, dv


flash_attention_plain.calls = 0
flash_dq_plain.calls = 0
flash_dkv_plain.calls = 0


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


def _check_kernel_args(q, k, v, extra=()) -> None:
    """What every kernel of this module takes: CUDA tensors on q's device,
    q/k/v (and `extra`, e.g. dO) in one float32 or bfloat16 dtype, a head
    size the kernels are built for."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    hs = q.shape[-1]
    if hs not in KERNEL_HEAD_SIZES:
        raise ValueError(f"head size {hs}: the kernel is built for {KERNEL_HEAD_SIZES}")
    same = (k, v, *extra)
    if q.dtype not in _KERNEL_DTYPES or any(x.dtype != q.dtype for x in same):
        raise ValueError(
            f"dtypes q={q.dtype} {[str(x.dtype) for x in same]}: the kernels "
            "take float32 or bfloat16, the same for q, k, v and dO"
        )
    for x in same:
        if x.device != q.device:
            raise ValueError(f"every argument must be on {q.device}, got {x.device}")


def _aligned(**tensors):
    """The tensors made contiguous, each checked for 16-byte alignment."""
    out = []
    for name, x in tensors.items():
        x = x.contiguous()
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        out.append(x)
    return out


def _call(lib_name, fn_name, q, k, ptrs, scale, causal) -> None:
    """Launch `fn_name` of `csrc/<lib_name>.cu`: (dtype, hs, *ptrs, B, H, G,
    T, scale, causal, stream) -> cudaError_t, raised when not 0."""
    B, H, T, hs = q.shape
    fn = getattr(kernels.library(lib_name), fn_name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * len(ptrs) + [i] * 4 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(_KERNEL_DTYPES[q.dtype], hs, *ptrs, B, H, k.shape[1], T, float(scale),
            int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name} failed (code {rc}) for q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)}"
        )


def _launch(q, k, v, scale, causal, with_lse):
    _check_kernel_args(q, k, v)
    q, k, v = _aligned(q=q, k=k, v=v)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    _call("flash_attention", "flash_attention_launch", q, k,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr() if with_lse else None), scale, causal)
    flash_attention.launches += 1
    return out, lse


def _check_stats(q, lse, dsum) -> None:
    B, H, T, _ = q.shape
    for name, x in (("lse", lse), ("dsum", dsum)):
        if x.shape != (B, H, T) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(
                f"{name} must be float32 (B, n_head, T) = {(B, H, T)} on "
                f"{q.device}; got {x.dtype} {tuple(x.shape)} on {x.device}"
            )


def flash_dq(
    q, k, v, do, lse, dsum, scale: float, causal: bool = True,
    *, use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> torch.Tensor:
    """K3: dQ (B, n_head, T, hs) in q's dtype, from dO (q's dtype), the
    forward's LSE and D = rowsum(dO * O) - dlse (both (B, n_head, T) f32)."""
    if use_kernel is None:
        use_kernel = q.device.type != "cpu"
    if not use_kernel:
        return flash_dq_plain(q, k, v, do, lse, dsum, scale, causal)
    _check_kernel_args(q, k, v, (do,))
    _check_stats(q, lse, dsum)
    q, k, v, do, lse, dsum = _aligned(q=q, k=k, v=v, do=do, lse=lse, dsum=dsum)
    dq = torch.empty_like(q)
    _call("flash_attention_bwd", "flash_attention_dq_launch", q, k,
          [x.data_ptr() for x in (q, k, v, do, lse, dsum, dq)], scale, causal)
    flash_dq.launches += 1
    return dq


def flash_dkv(
    q, k, v, do, lse, dsum, scale: float, causal: bool = True,
    *, use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: float32 (dK, dV), each (B, G, T, hs), summed over each GQA
    group's query heads inside the kernel (one launch)."""
    if use_kernel is None:
        use_kernel = q.device.type != "cpu"
    if not use_kernel:
        return flash_dkv_plain(q, k, v, do, lse, dsum, scale, causal)
    _check_kernel_args(q, k, v, (do,))
    _check_stats(q, lse, dsum)
    q, k, v, do, lse, dsum = _aligned(q=q, k=k, v=v, do=do, lse=lse, dsum=dsum)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _call("flash_attention_bwd", "flash_attention_dkv_launch", q, k,
          [x.data_ptr() for x in (q, k, v, do, lse, dsum, dk, dv)], scale, causal)
    flash_dkv.launches += 1
    return dk, dv


flash_dq.launches = 0
flash_dkv.launches = 0


def _forward(q, k, v, scale, causal, use_kernel, with_lse):
    if not use_kernel:
        out, lse = flash_attention_plain(q, k, v, scale, causal)
        return out, (lse if with_lse else None)
    return _launch(q, k, v, scale, causal, with_lse)


class _FlashCore(torch.autograd.Function):
    """K2 with its LSE under autograd, differentiable in both outputs (the
    JAX `_flash_core` and `_flash_lse_core`; `flash_attention` keeps the
    output alone, and the LSE's unused cotangent then arrives as None)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, use_kernel):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, scale, causal, use_kernel, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.use_kernel = scale, causal, use_kernel
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        """(dq, dk, dv): the FA-2 backward of `_flash_bwd_impl`
        (mdi_llm_tpu/ops/flash.py), on K3 and K4 or their plain versions."""
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:  # only the LSE was used
            do = torch.zeros_like(out)
        # D_i = dO_i . O_i in float32; the LSE's cotangent folds in as a
        # shift (d lse_i / d s_ij = P_ij, so dS = P * (dP - (D - dlse)))
        dsum = (do.float() * out.float()).sum(-1)
        if dlse is not None:
            dsum = dsum - dlse.float()
        do = do.to(q.dtype)
        args = (q, k, v, do, lse, dsum, ctx.scale, ctx.causal)
        dq = flash_dq(*args, use_kernel=ctx.use_kernel)
        dk, dv = flash_dkv(*args, use_kernel=ctx.use_kernel)  # group-summed
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _route(q, k, v, scale, use_kernel):
    _check_args(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if use_kernel is None:
        use_kernel = q.device.type != "cpu"
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return float(scale), bool(use_kernel), grad


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
    (B, n_head, T) float32).  `causal=False` attends the whole chunk.
    Differentiable in both outputs (K3, K4)."""
    scale, use_kernel, grad = _route(q, k, v, scale, use_kernel)
    if grad:
        return _FlashCore.apply(q, k, v, scale, bool(causal), use_kernel)
    return _forward(q, k, v, scale, causal, use_kernel, with_lse=True)


def flash_attention(
    q: torch.Tensor,  # (B, n_head, T, hs)
    k: torch.Tensor,  # (B, n_groups, T, hs)
    v: torch.Tensor,  # (B, n_groups, T, hs)
    scale: Optional[float] = None,
    *,
    use_kernel: Optional[bool] = None,  # None → the tensor's device decides
) -> torch.Tensor:
    """K2, causal: (B, n_head, T, hs) in q's dtype.  Differentiable: the
    backward runs K3 and K4 from the saved LSE, so training never
    materializes the (T, T) scores either."""
    scale, use_kernel, grad = _route(q, k, v, scale, use_kernel)
    if grad:
        return _FlashCore.apply(q, k, v, scale, True, use_kernel)[0]
    return _forward(q, k, v, scale, True, use_kernel, with_lse=False)[0]


flash_attention.launches = 0
