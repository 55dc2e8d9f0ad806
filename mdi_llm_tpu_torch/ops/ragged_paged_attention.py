"""K1: ragged paged attention — the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas kernel `_unified_kernel`
(mdi_llm_tpu/ops/ragged_paged_attention.py:123).  One packed, slot-major
ragged query batch `(1, n_head, T, hs)` attends through per-slot block
tables into a pool `(NB, BS, G, hs)`: token t of slot s (inside the span
`[q_start[s], q_start[s] + q_len[s])`) sees key j of its slot iff
`j <= q_pos[t]`.  Decode (spans of width 1), verify-width spans and
prefill chunks are all the same call.

- `ragged_paged_attention` is the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the hand-written kernel
  (`csrc/ragged_paged_attention.cu`, built on first use by
  `mdi_llm_tpu_torch.kernels`) or raises.  There is no fallback from the
  kernel to the plain version.  `ragged_paged_attention.launches` counts
  kernel launches and nothing else.
- `ragged_paged_attention_plain` is the gather-then-dense math of the JAX
  package's lax route (`_paged_prefill_lax`): each token reads its own
  slot's contiguous KV view through `multihead_attention`.  The CPU tests
  hold it against the JAX kernel in interpret mode; on the card the kernel
  is held against it.

Rows that no slot owns come out as zeros from both.  `lens` (the deepest
visible position + 1 of each slot) only bounds the kernel's walk over the
table; validity is decided by `q_pos` alone, so the plain version does not
need it.  fp pools only: int8 pools are refused (not ported yet).
"""

from __future__ import annotations

import ctypes

import torch

from mdi_llm_tpu_torch import kernels
from mdi_llm_tpu_torch.ops.attention import multihead_attention

__all__ = [
    "ragged_paged_attention",
    "ragged_paged_attention_plain",
    "gather_paged_kv",
    "token_attention",
]

# packed tokens per chunk in the plain route: bounds the (chunk, G, window,
# hs) per-token KV view it gathers
PLAIN_CHUNK = 64
KERNEL_HEAD_SIZES = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_paged_kv(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each table row's contiguous (B, G, MB * BS, hs) view of the pool;
    flattened slot j holds absolute position j."""
    g = pool[block_tables.long()]  # (B, MB, BS, G, hs)
    B, MB, BS, G, hs = g.shape
    return g.reshape(B, MB * BS, G, hs).permute(0, 2, 1, 3)


def token_attention(q, k_pool, v_pool, block_tables, q_slot, q_pos, scale):
    """Every packed token is one lane of dense attention over its own
    slot's contiguous view: q (1, n_head, T, hs), q_slot/q_pos (T,).
    Returns (1, n_head, T, hs) in q's dtype."""
    k = gather_paged_kv(k_pool, block_tables)  # (S, G, W, hs)
    v = gather_paged_kv(v_pool, block_tables)
    qt = q[0].transpose(0, 1)[:, :, None, :]  # (T, n_head, 1, hs)
    sl, ps = q_slot.long(), q_pos.long()
    parts = []
    for c in range(0, qt.shape[0], PLAIN_CHUNK):
        sc = sl[c : c + PLAIN_CHUNK]
        parts.append(multihead_attention(
            qt[c : c + PLAIN_CHUNK], k[sc], v[sc],
            ps[c : c + PLAIN_CHUNK, None], scale=scale,
        ))
    out = torch.cat(parts)  # (T, n_head, 1, hs)
    return out[:, :, 0, :].transpose(0, 1)[None]


def _span_owner(q_start, q_len, T):
    """(owner slot per packed token, owned mask); unowned rows get slot 0."""
    t = torch.arange(T, device=q_start.device)
    qs, ql = q_start.long(), q_len.long()
    in_span = (t[None, :] >= qs[:, None]) & (t[None, :] < (qs + ql)[:, None])
    return in_span.int().argmax(dim=0), in_span.any(dim=0)


def ragged_paged_attention_plain(
    q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos, *, scale
) -> torch.Tensor:
    """The plain PyTorch version of K1 (same arguments as the wrapper)."""
    del lens  # bounds the kernel's walk only; q_pos decides validity
    _check_fp_pool(k_pool)
    q_slot, owned = _span_owner(q_start, q_len, q.shape[2])
    out = token_attention(q, k_pool, v_pool, block_tables, q_slot, q_pos, scale)
    return torch.where(owned[None, None, :, None], out, torch.zeros_like(out))


def _check_fp_pool(pool) -> None:
    if isinstance(pool, dict):
        raise ValueError(
            "ragged_paged_attention: int8 pools ({'q', 'scale'}) are not "
            "ported yet (ROADMAP Queue 2, K1-int8); serve with an fp pool"
        )


def _lib():
    lib = kernels.library("ragged_paged_attention")
    fn = lib.ragged_paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * 9 + [i] * 6 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos):
    if q.dim() != 4 or q.shape[0] != 1:
        raise ValueError(f"q must be (1, n_head, T, hs), got {tuple(q.shape)}")
    _, n_head, T, hs = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool and v_pool must both be (NB, BS, G, hs)")
    G = k_pool.shape[2]
    if n_head % G:
        raise ValueError(f"n_head={n_head} must be a multiple of G={G}")
    if hs not in KERNEL_HEAD_SIZES or k_pool.shape[3] != hs:
        raise ValueError(
            f"head size {hs} (pool {k_pool.shape[3]}): the kernel is built "
            f"for {KERNEL_HEAD_SIZES}"
        )
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"dtypes q={q.dtype} k={k_pool.dtype} v={v_pool.dtype}: the "
            "kernel takes float32 or bfloat16, the same for all three"
        )
    S = block_tables.shape[0]
    meta = {"block_tables": (block_tables, 2), "q_start": (q_start, 1),
            "q_len": (q_len, 1), "lens": (lens, 1), "q_pos": (q_pos, 1)}
    for name, (x, nd) in meta.items():
        if x.dtype != torch.int32 or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-D int32 tensor")
        if x.shape[0] != (T if name == "q_pos" else S):
            raise ValueError(f"{name} has leading size {x.shape[0]}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for x in (k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos):
        if x.device != q.device:
            raise ValueError(f"every argument must be on {q.device}, got {x.device}")


def ragged_paged_attention(
    q: torch.Tensor,  # (1, n_head, T, hs) packed slot-major ragged queries
    k_pool: torch.Tensor,  # (NB, BS, G, hs)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (S, MB) int32
    q_start: torch.Tensor,  # (S,) int32 span offset per slot
    q_len: torch.Tensor,  # (S,) int32 span length (0 = slot absent)
    lens: torch.Tensor,  # (S,) int32 valid KV length (deepest pos + 1)
    q_pos: torch.Tensor,  # (T,) int32 absolute position per packed token
    *,
    scale: float,
) -> torch.Tensor:
    """K1.  Returns (1, n_head, T, hs) in q's dtype, zeros where no slot
    owns the row.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream, or raise."""
    _check_fp_pool(k_pool)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos,
            scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for {q.device}")
    _check_kernel_args(q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos)
    _, n_head, T, hs = q.shape
    NB, BS, G, _ = k_pool.shape
    S, MB = block_tables.shape
    out = torch.zeros_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        _KERNEL_DTYPES[q.dtype], hs, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), q_start.data_ptr(),
        q_len.data_ptr(), lens.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        T, n_head, G, BS, S, MB, float(scale), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed (code {rc}) for "
            f"q {tuple(q.shape)} {q.dtype}, pool {tuple(k_pool.shape)}"
        )
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
