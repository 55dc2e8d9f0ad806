"""K1: ragged paged attention — the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas kernel `_unified_kernel`
(mdi_llm_tpu/ops/ragged_paged_attention.py:123).  One packed, slot-major
ragged query batch `(1, n_head, T, hs)` attends through per-slot block
tables into a pool `(NB, BS, G, hs)`, stored as q's dtype, as float8
(e4m3 or e5m2), or as the JAX package's int8 pool `{"q": int8 (NB, BS,
G, hs), "scale": float32 (NB, G)}`.  Token t of slot s (inside the span
`[q_start[s], q_start[s] + q_len[s])`) sees key j of its slot iff
`j <= q_pos[t]`.  Decode (spans of width 1), verify-width spans and
prefill chunks are all the same call.

- `ragged_paged_attention` is the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the hand-written kernel
  (`csrc/ragged_paged_attention.cu`, built on first use by
  `mdi_llm_tpu_torch.kernels`) or raises.  There is no fallback from the
  kernel to the plain version.  `ragged_paged_attention.launches` counts
  kernel launches and nothing else, one per call.  The launch is the
  operator `torch.ops.mdi_torch.ragged_paged_attention` (`OP`): its CUDA
  implementation is the launch, its meta implementation gives the output
  and the split workspace, so a step traced on meta tensors
  (`analysis/ir.py`, `analysis/liveness.py`) holds one node per launch.
- Split-KV: the kernel splits each slot's walk over chunks of keys; the
  plan (`split_plan`: the chunk, the number of chunks, the grid) comes
  from static shapes alone, never from `lens` or `q_pos`, so the wrapper
  reads no device value. Its knobs are resolved per card and geometry
  from the tuning tables of `ops/tuning.py` (explicit `params=`, the
  `MDI_TUNE_TABLE` table, the committed defaults, the constants below).
  With more than one chunk the kernel writes per-chunk partials into a
  float32 workspace (`torch.empty`, here) and a second kernel merges
  them; `ragged_paged_attention.merge_launches` counts that one.
  `split_attention_plain` is the same arithmetic (partials per chunk,
  merged by log-sum-exp in chunk order) in plain PyTorch, which the CPU
  tests hold against the unsplit plain version.
- `ragged_paged_attention_plain` is the gather-then-dense math of the JAX
  package's lax route (`_paged_prefill_lax`): each token reads its own
  slot's contiguous KV view through `multihead_attention`.  An int8 pool
  is dequantized in that gather (`int8 * scale` in float32) and the
  attention runs with q in float32, cast back at the end; a float8 pool is
  upcast to q's dtype at the read.  The CPU tests hold it against the JAX
  kernel in interpret mode; on the card the kernel is held against it.

Rows that no slot owns come out as zeros from both.  `lens` (the deepest
visible position + 1 of each slot) only bounds the kernel's walk over the
table; validity is decided by `q_pos` alone, so the plain version does not
need it.  The kernel dequantizes a narrow pool inside its block loop and
never builds a dequantized copy of the pool or of the gathered view.
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
    "split_plan",
    "split_attention_plain",
    "smem_bytes",
    "launch_smem_bytes",
]

# packed tokens per chunk in the plain route: bounds the (chunk, G, window,
# hs) per-token KV view it gathers
PLAIN_CHUNK = 64
KERNEL_HEAD_SIZES = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# pool storage codes of the kernel: 0 is "the same dtype as q"
_NARROW_KV = {torch.int8: 2, torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
# the kernel's tiles (csrc/ragged_paged_attention.cu: kRows, kKeys) and the
# split's conservative limits (ops/tuning.DEFAULT_PARAMS; a tuning table may
# set others): chunks of at least MIN_CHUNK keys, at most MAX_CHUNKS of
# them (a 2048-key table: 16 chunks of 128).  A pure decode step (T <= S,
# one row per head of each lane) has only its key walk to spread over the
# card, so it takes chunks of DECODE_CHUNK, up to the merge's 32 chunks:
# 8 slots x 4 groups at depths up to 2000 then put ~4 live blocks per SM
# in flight.
ROW_TILE, KEY_TILE = 16, 32
K1_STAGES = 4  # KV tiles in the kernel's shared-memory ring (kStages)
MIN_CHUNK, MAX_CHUNKS = 128, 16
DECODE_CHUNK, DECODE_MAX_CHUNKS = 64, 32


def _pool_parts(pool):
    """(payload, scale or None): fp and float8 pools are bare tensors, int8
    pools are {"q": int8 blocks, "scale": float32 (NB, G)}."""
    if isinstance(pool, dict):
        return pool["q"], pool["scale"]
    return pool, None


def gather_paged_kv(pool, block_tables: torch.Tensor) -> torch.Tensor:
    """Each table row's contiguous (B, G, MB * BS, hs) view of the pool;
    flattened slot j holds absolute position j.  An int8 pool comes out
    dequantized in float32 (`int8 * scale`, the kernel's in-loop math)."""
    payload, scale = _pool_parts(pool)
    tables = block_tables.long()
    g = payload[tables]  # (B, MB, BS, G, hs)
    if scale is not None:
        g = g.float() * scale[tables][:, :, None, :, None]
    B, MB, BS, G, hs = g.shape
    return g.reshape(B, MB * BS, G, hs).permute(0, 2, 1, 3)


def token_attention(q, k_pool, v_pool, block_tables, q_slot, q_pos, scale):
    """Every packed token is one lane of dense attention over its own
    slot's contiguous view: q (1, n_head, T, hs), q_slot/q_pos (T,).
    Returns (1, n_head, T, hs) in q's dtype; over an int8 pool q runs in
    float32, as the dequantized K/V do."""
    k = gather_paged_kv(k_pool, block_tables)  # (S, G, W, hs)
    v = gather_paged_kv(v_pool, block_tables)
    qt = q[0].transpose(0, 1)[:, :, None, :]  # (T, n_head, 1, hs)
    if isinstance(k_pool, dict):
        qt = qt.float()
    sl, ps = q_slot.long(), q_pos.long()
    parts = []
    for c in range(0, qt.shape[0], PLAIN_CHUNK):
        sc = sl[c : c + PLAIN_CHUNK]
        parts.append(multihead_attention(
            qt[c : c + PLAIN_CHUNK], k[sc], v[sc],
            ps[c : c + PLAIN_CHUNK, None], scale=scale,
        ))
    out = torch.cat(parts)  # (T, n_head, 1, hs)
    return out[:, :, 0, :].transpose(0, 1)[None].to(q.dtype)


def _span_owner(q_start, q_len, T):
    """(owner slot per packed token, owned mask); unowned rows get slot 0."""
    t = torch.arange(T, device=q_start.device)
    qs, ql = q_start.long(), q_len.long()
    in_span = (t[None, :] >= qs[:, None]) & (t[None, :] < (qs + ql)[:, None])
    return in_span.int().argmax(dim=0), in_span.any(dim=0)


def split_plan(n_head: int, G: int, T: int, S: int, BS: int, MB: int, hs: int,
               params) -> dict:
    """K1's split of the key walk, from static shapes alone: `chunk` keys
    per block (a multiple of KEY_TILE; smaller for a pure decode step,
    T <= S), `n_chunks` chunks over a table of
    MB * BS keys, the kernel's `grid` (row tiles x chunks, G, S) and the
    float32 `workspace` values the partials need (0 with one chunk).
    `params` (an `ops.tuning.KernelParams`; `tuning.DEFAULT_PARAMS` holds
    the constants above) gives the least chunk and the most chunks of each
    kind of step."""
    width = MB * BS
    if T <= S:
        chunk, most = params.decode_chunk, params.decode_max_chunks
    else:
        chunk, most = params.min_chunk, params.max_chunks
    while -(-width // chunk) > most:
        chunk *= 2
    n_chunks = -(-width // chunk)
    row_tiles = -(-(n_head // G) * T // ROW_TILE)
    return {"chunk": chunk, "n_chunks": n_chunks, "grid": (row_tiles * n_chunks, G, S),
            "workspace": n_chunks * n_head * T * (hs + 2) if n_chunks > 1 else 0}


def plan_for(q, k_payload, block_tables, params) -> dict:
    """`split_plan` for one call, read off the tensors' shapes alone."""
    _, n_head, T, hs = q.shape
    _, BS, G, _ = k_payload.shape
    S, MB = block_tables.shape
    return split_plan(n_head, G, T, S, BS, MB, hs, params)


def split_attention_plain(
    q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos, *, scale, chunk
) -> torch.Tensor:
    """The kernel's split arithmetic in plain PyTorch, float32: token t of
    slot s sees keys [0, min(lens[s], MB * BS, q_pos[t] + 1)); each chunk
    of `chunk` keys gives (m, l, acc) per row (m = -inf, l = 0 where the
    chunk holds no valid key), and the chunks merge in order by
    log-sum-exp.  Rows no slot owns, and rows that see no key, are 0."""
    T = q.shape[2]
    q_slot, owned = _span_owner(q_start, q_len, T)
    sl = q_slot.long()
    k = gather_paged_kv(k_pool, block_tables).float()[sl]  # (T, G, W, hs)
    v = gather_paged_kv(v_pool, block_tables).float()[sl]
    H, W = q.shape[1], k.shape[2]
    heads = torch.arange(H) // (H // k.shape[1])
    k, v = k[:, heads], v[:, heads]  # (T, H, W, hs)
    s = torch.einsum("htd,thwd->htw", q[0].float(), k) * scale
    end = torch.minimum(lens.long()[sl].clamp(max=W), q_pos.long() + 1).clamp(min=0)
    valid = (torch.arange(W)[None, :] < (end * owned)[:, None])[None]  # (1, T, W)
    ms, ls, accs = [], [], []
    for c0 in range(0, W, chunk):
        sc = s[..., c0:c0 + chunk].masked_fill(~valid[..., c0:c0 + chunk], float("-inf"))
        m = sc.amax(-1)  # (H, T)
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("htw,thwd->htd", p, v[:, :, c0:c0 + chunk]))
    mx = torch.stack(ms).amax(0)
    num, den = torch.zeros_like(accs[0]), torch.zeros_like(ls[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(torch.isfinite(m), torch.exp(m - mx), 0.0)
        num, den = num + w[..., None] * acc, den + w * l
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None], 0.0)
    return out[None].to(q.dtype)


def ragged_paged_attention_plain(
    q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos, *, scale
) -> torch.Tensor:
    """The plain PyTorch version of K1 (same arguments as the wrapper)."""
    del lens  # bounds the kernel's walk only; q_pos decides validity
    q_slot, owned = _span_owner(q_start, q_len, q.shape[2])
    out = token_attention(q, k_pool, v_pool, block_tables, q_slot, q_pos, scale)
    return torch.where(owned[None, None, :, None], out, torch.zeros_like(out))


def smem_bytes(head_size: int, kv_itemsize: int) -> int:
    """K1's dynamic shared memory per block, from shapes alone (no card):
    the row tile's queries in float32, a ring of K1_STAGES K + V key tiles
    of the pool's element size (each K row padded by 16 bytes) and the
    int8 scales of each tile — `smem_bytes<KV, HS>()` of the source, which
    `launch_smem_bytes` reads back from the built library."""
    return (ROW_TILE * head_size * 4
            + K1_STAGES * KEY_TILE * (2 * head_size * kv_itemsize + 16)
            + K1_STAGES * 2 * KEY_TILE * 4)


def launch_smem_bytes(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_size: int) -> int:
    """The dynamic shared memory the kernel's launch requests per block for
    q of `q_dtype` over a pool of `kv_dtype` (built library; card machine
    only)."""
    fn = kernels.library("ragged_paged_attention").ragged_paged_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    kv = 0 if kv_dtype == q_dtype else _NARROW_KV[kv_dtype]
    n = fn(_KERNEL_DTYPES[q_dtype], kv, head_size)
    if n < 0:
        raise ValueError(f"K1 has no launch for q {q_dtype}, pool {kv_dtype}, "
                         f"head size {head_size}")
    return int(n)


def _lib():
    lib = kernels.library("ragged_paged_attention")
    fn, merge = lib.ragged_paged_attention_launch, lib.ragged_paged_attention_merge_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i] + [p] * 11 + [i] * 6 + [ctypes.c_float, p, i, i, p]
        fn.restype = ctypes.c_int
        merge.argtypes = [i, i] + [p] * 6 + [i] * 6 + [p]
        merge.restype = ctypes.c_int
    return fn, merge


def _check_pools(k_pool, v_pool):
    """The pools' (payload, payload, scale, scale, storage code): both
    bare tensors, or both int8 dicts with contiguous float32 (NB, G)
    scales."""
    if isinstance(k_pool, dict) != isinstance(v_pool, dict):
        raise ValueError("k_pool and v_pool must both be int8 pools or neither")
    k, ks = _pool_parts(k_pool)
    v, vs = _pool_parts(v_pool)
    if k.dim() != 4 or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("k_pool and v_pool must both be (NB, BS, G, hs) of one dtype")
    if ks is not None:
        if k.dtype != torch.int8:
            raise ValueError(f"an int8 pool's payload must be int8, got {k.dtype}")
        for s in (ks, vs):
            if s.dtype != torch.float32 or tuple(s.shape) != (k.shape[0], k.shape[2]):
                raise ValueError(
                    f"an int8 pool's scale must be float32 (NB, G) = "
                    f"{(k.shape[0], k.shape[2])}, got {s.dtype} {tuple(s.shape)}"
                )
            if not s.is_contiguous():
                raise ValueError("an int8 pool's scale must be contiguous")
    elif k.dtype == torch.int8:
        raise ValueError("an int8 payload needs its scales: pass {'q', 'scale'}")
    return k, v, ks, vs


def _check_kernel_args(q, k, v, scales, block_tables, q_start, q_len, lens, q_pos):
    if q.dim() != 4 or q.shape[0] != 1:
        raise ValueError(f"q must be (1, n_head, T, hs), got {tuple(q.shape)}")
    _, n_head, T, hs = q.shape
    G = k.shape[2]
    if n_head % G:
        raise ValueError(f"n_head={n_head} must be a multiple of G={G}")
    if hs not in KERNEL_HEAD_SIZES or k.shape[3] != hs:
        raise ValueError(
            f"head size {hs} (pool {k.shape[3]}): the kernel is built "
            f"for {KERNEL_HEAD_SIZES}"
        )
    if q.dtype not in _KERNEL_DTYPES or (k.dtype != q.dtype and k.dtype not in _NARROW_KV):
        raise ValueError(
            f"dtypes q={q.dtype} pool={k.dtype}: the kernel takes q in float32 "
            "or bfloat16 over a pool of q's dtype, int8 or float8"
        )
    S = block_tables.shape[0]
    meta = {"block_tables": (block_tables, 2), "q_start": (q_start, 1),
            "q_len": (q_len, 1), "lens": (lens, 1), "q_pos": (q_pos, 1)}
    for name, (x, nd) in meta.items():
        if x.dtype != torch.int32 or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-D int32 tensor")
        if x.shape[0] != (T if name == "q_pos" else S):
            raise ValueError(f"{name} has leading size {x.shape[0]}")
    for name, x in (("q", q), ("k_pool", k), ("v_pool", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for x in (k, v, *scales, block_tables, q_start, q_len, lens, q_pos):
        if x.device != q.device:
            raise ValueError(f"every argument must be on {q.device}, got {x.device}")


def _launch(q, k, v, k_scale, v_scale, block_tables, q_start, q_len, lens, q_pos,
            scale: float, chunk: int, n_chunks: int):
    """The op's CUDA implementation: K1 (and its merge, when the walk is
    split) on the current stream; returns (out, the float32 split
    workspace, empty without a split)."""
    for name, x in (("q", q), ("k_pool", k), ("v_pool", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _, n_head, T, hs = q.shape
    BS, G = k.shape[1], k.shape[2]
    S, MB = block_tables.shape
    n_ws = n_chunks * n_head * T * (hs + 2) if n_chunks > 1 else 0
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    # with a merge, the two kernels write every row (zeros where no slot
    # owns it); without one the kernel leaves such rows as they are
    out = torch.empty_like(q) if n_ws else torch.zeros_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn, merge = _lib()
    dtype = _KERNEL_DTYPES[q.dtype]
    spans = (q_start.data_ptr(), q_len.data_ptr(), lens.data_ptr(), q_pos.data_ptr())
    rc = fn(
        dtype, 0 if k.dtype == q.dtype else _NARROW_KV[k.dtype],
        hs, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        block_tables.data_ptr(), *spans, out.data_ptr(),
        T, n_head, G, BS, S, MB, float(scale),
        ws.data_ptr() if n_ws else None, chunk, n_chunks, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed (code {rc}) for "
            f"q {tuple(q.shape)} {q.dtype}, pool {tuple(k.shape)} {k.dtype}"
        )
    ragged_paged_attention.launches += 1
    # every packed row against the whole table window (the count of the
    # plain route's dense math, which the CPU's FlopCounterMode sees)
    kernels.add_flops(4.0 * T * n_head * hs * MB * BS)
    if n_ws:
        rc = merge(dtype, hs, ws.data_ptr(), *spans, out.data_ptr(), T, n_head, S,
                   MB * BS, chunk, n_chunks, stream)
        if rc != 0:
            raise RuntimeError(f"ragged_paged_attention merge launch failed (code {rc})")
        ragged_paged_attention.merge_launches += 1
    return out, ws


def _fake(q, k, v, k_scale, v_scale, block_tables, q_start, q_len, lens, q_pos,
          scale: float, chunk: int, n_chunks: int):
    """The op's meta implementation: the shapes the launch gives and what
    it allocates (the output, and the split's float32 workspace)."""
    _, n_head, T, hs = q.shape
    n_ws = n_chunks * n_head * T * (hs + 2) if n_chunks > 1 else 0
    return torch.empty_like(q), q.new_empty(n_ws, dtype=torch.float32)


# K1 as one operator of the port's namespace: the card launches the kernel,
# meta tensors (the compiled-program analysis, `analysis/ir.py`) trace one
# node per launch with its output and workspace; no other device has an
# implementation
OP = kernels.define_op(
    "ragged_paged_attention(Tensor q, Tensor k, Tensor v, Tensor? k_scale, "
    "Tensor? v_scale, Tensor block_tables, Tensor q_start, Tensor q_len, "
    "Tensor lens, Tensor q_pos, float scale, int chunk, int n_chunks) -> (Tensor, Tensor)",
    cuda=_launch, meta=_fake,
)


def ragged_paged_attention(
    q: torch.Tensor,  # (1, n_head, T, hs) packed slot-major ragged queries
    k_pool,  # (NB, BS, G, hs), or an int8 pool {"q", "scale"}
    v_pool,
    block_tables: torch.Tensor,  # (S, MB) int32
    q_start: torch.Tensor,  # (S,) int32 span offset per slot
    q_len: torch.Tensor,  # (S,) int32 span length (0 = slot absent)
    lens: torch.Tensor,  # (S,) int32 valid KV length (deepest pos + 1)
    q_pos: torch.Tensor,  # (T,) int32 absolute position per packed token
    *,
    scale: float,
    params=None,  # ops.tuning.KernelParams; None: resolved for the card
) -> torch.Tensor:
    """K1.  Returns (1, n_head, T, hs) in q's dtype, zeros where no slot
    owns the row.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream, or raise; meta tensors trace
    the op the card launches.  The split's knobs are `params`, else
    `ops.tuning.kernel_params_for` the card and geometry (resolved once,
    on the host; on meta, for the card `ops.tuning.planned_device`
    names)."""
    k, v, ks, vs = _check_pools(k_pool, v_pool)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos,
            scale=scale,
        )
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"ragged_paged_attention: no kernel for {q.device}")
    scales = () if ks is None else (ks, vs)
    _check_kernel_args(q, k, v, scales, block_tables, q_start, q_len, lens, q_pos)
    n_head, hs = q.shape[1], q.shape[3]
    from mdi_llm_tpu_torch.ops import tuning

    params = (tuning.kernel_params_for(q, k) if params is None
              else tuning.checked_params(params, n_head, hs))
    plan = plan_for(q, k, block_tables, params)
    out, _ = OP(q, k, v, ks, vs, block_tables, q_start, q_len, lens, q_pos,
                float(scale), plan["chunk"], plan["n_chunks"])
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.merge_launches = 0
