"""Weight quantization: int8 (weight-only or W8A8) and group-wise int4.

Port of `mdi_llm_tpu/ops/quant.py`.  Batched decode reads every weight once
per step, so storing the linear weights narrower cuts the bytes a step
moves.  The layouts are the JAX package's, so a quantized tree means the
same thing in both packages:

- a linear's ``{"weight": (..., out, in)}`` becomes ``{"weight_q": int8
  (..., out, in), "scale": f32 (..., out)}`` (mode "w8"), the same under
  key "weight_q8" (mode "w8a8": activations are quantized per token too,
  and the contraction runs int8 x int8 -> int32), or ``{"weight_q4": int8
  (..., out, in/2), "scale": f32 (..., out, in/group)}`` (mode "w4": two
  signed nibbles per byte, one scale per group of the input axis);
- 1-D weights (norms), biases and the embedding table (a gather, and the
  tied head) keep their dtype; an untied `lm_head` is quantized.

The quantizer runs in torch on the tensor's own device, in float32 with
the JAX quantizer's arithmetic (f32 division, round half to even,
symmetric clip), so its bytes and scales equal the JAX package's for the
same float32 input (tests/test_torch_quant.py).

Tensor-parallel ranks (`models/transformer.sharded_forward`) run their
slices through `quantized_einsum` unchanged, with two fits for a
row-parallel weight, whose contracted axis is split: w8a8 quantizes a
rank's activation slice on the whole row's max |x| (`amax`), as XLA's
reduction over the split axis does, and int4 group scales the tp size
does not divide are refitted to each rank's slice
(`parallel.sharding.regroup_w4_row_scales`).

The contractions are left to torch ops, as the JAX package leaves them to
XLA; no hand-written kernel is involved.  Where XLA fuses the int8 ->
bf16 conversion into the dot's operand read, the "w8" and "w4" routes
here build a converted copy of each weight per call (ROADMAP, open speed
work); "w8a8" runs `torch._int_mm`, whose CUDA form needs more than 16
rows, so short inputs (a decode step) are padded with zero rows.
`FlopCounterMode` does not count `torch._int_mm`: the contraction adds
its 2·M·N·K to the kernels' tally (`kernels.add_flops`).

The mixture-of-experts contractions (`EXPERT_UP` "...d,eid->...ei" over
`fc_1`/`fc_2` (E, I, D), `EXPERT_DOWN` "...ei,edi->...ed" over `proj`
(E, D, I)) take the einsum branch (torch's einsum reads the stacks in
place, as batched products); w8a8 folds E * I into `_int_mm`'s N for the
up stacks and runs one `_int_mm` per expert for the down stack.  The
expert-parallel dispatch (`parallel/expert.py`) contracts each expert's
own slots (`EP_UP` "emd,eid->emi", `EP_DOWN` "emi,edi->emd"): w8a8 runs
one `_int_mm` per expert there too.  int4's
intermediate holds one value per (row, output, scale group): its rows
are split so that it stays under `W4_Z_BYTES`.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from mdi_llm_tpu_torch import kernels

Params = Any

# CLI/engine flag -> storage mode, shared by every quantizing entry point
FLAG_TO_MODE = {"int8": "w8", "w8a8": "w8a8", "int4": "w4"}
_WKEY = {"w8": "weight_q", "w8a8": "weight_q8", "w4": "weight_q4"}

# param-tree keys never quantized: embeddings feed gathers and tied heads;
# norm weights are vectors (per-layer-stacked they look 2-D, hence by name)
SKIP_KEYS = ("wte", "wpe", "norm_1", "norm_2", "ln_f")

W4_GROUP = 128  # input-axis group size for int4 scales

# torch._int_mm on CUDA takes more than 16 rows
_INT_MM_MIN_ROWS = 17

# the mixture-of-experts contractions (models/transformer.moe_forward)
EXPERT_UP, EXPERT_DOWN = "...d,eid->...ei", "...ei,edi->...ed"
# the same over each expert's own dispatched slots (parallel/expert.py)
EP_UP, EP_DOWN = "emd,eid->emi", "emi,edi->emd"

# int4's per-group partial products of one contraction are built a block
# of rows at a time, each block's under this many bytes (Mixtral's expert
# stacks: 7.3 MB a row in bfloat16, so 146 rows a block)
W4_Z_BYTES = 1 << 30


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """`a / d` rounded as one float32 division, as numpy and XLA divide: a
    CUDA division by a Python scalar multiplies by its reciprocal, which
    can differ in the last bit."""
    return a / torch.full_like(a, d)


def _check_mode(mode: str) -> None:
    if mode not in _WKEY:
        raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_tensor(w: torch.Tensor):
    """Per-output-channel symmetric int8: scale over the last (input) axis.
    Works for stacked layouts too ((L, out, in) -> scale (L, out))."""
    w = w.float()
    scale = _div(w.abs().amax(dim=-1), 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale.float()[..., None]).to(dtype)


def w4_group_size(in_d: int, group: int = W4_GROUP) -> int:
    """Largest power-of-two divisor of `in_d` that is <= `group`: the int4
    scale-group width for an input dim."""
    g = min(group, in_d)
    while in_d % g:
        g //= 2
    return g


def quantize_tensor4(w: torch.Tensor, group: int = W4_GROUP):
    """Group-wise symmetric int4, packed two nibbles per int8 byte (even
    input positions in the low nibble).  Returns (packed int8 (..., out,
    in/2), scale f32 (..., out, in/group)).  The group scales sit along the
    contracted axis, so they cannot factor out of one product (`_w4_einsum`
    applies them per group)."""
    w = w.float()
    in_d = w.shape[-1]
    if in_d % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {in_d}")
    g = w4_group_size(in_d, group)
    wg = w.reshape(*w.shape[:-1], in_d // g, g)
    scale = _div(wg.abs().amax(dim=-1), 7.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(wg / safe[..., None]), -7, 7).to(torch.int8)
    q = q.reshape(*w.shape[:-1], in_d)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = ((lo & 0x0F) | (hi << 4)).to(torch.int8)
    return packed, scale


def _nibbles(packed: torch.Tensor):
    """The low and high nibble planes, sign-extended: (p << 4) >> 4 and
    p >> 4 (arithmetic shifts on int8)."""
    return (packed << 4) >> 4, packed >> 4


def unpack_w4(packed: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Nibble unpack + group dequant -> (..., out, in) in `dtype`."""
    lo, hi = _nibbles(packed)
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    in_d = q.shape[-1]
    n_g = scale.shape[-1]
    qg = q.reshape(*q.shape[:-1], n_g, in_d // n_g).to(scale.dtype)
    w = qg * scale[..., None]
    return w.reshape(*q.shape[:-1], in_d).to(dtype)


def is_quantized(p: Params) -> bool:
    return isinstance(p, dict) and (
        "weight_q" in p or "weight_q8" in p or "weight_q4" in p
    )


def tree_has_quantized(params: Params) -> bool:
    """True if any subtree is a quantized linear: detects pre-quantized
    checkpoints structurally, whatever the --quantize flag (a
    `prepare_model --quantize` sibling loads with quantize='none')."""
    if isinstance(params, dict):
        return is_quantized(params) or any(
            tree_has_quantized(v) for v in params.values()
        )
    return False


def quantize_params(params: Params, skip: Sequence[str] = SKIP_KEYS,
                    mode: str = "w8") -> Params:
    """Walk a param tree, replacing every >=2-D "weight" (outside `skip`
    subtrees) with its quantized leaf and f32 "scale".  Biases and norm
    weights pass through unchanged; `mode` selects the storage key and so
    the execution path.  Each leaf is quantized on its own device."""
    _check_mode(mode)
    wkey = _WKEY[mode]

    def walk(node, name):
        if not isinstance(node, dict) or name in skip:
            return node
        out = {}
        for k, v in node.items():
            if k == "weight" and v.dim() >= 2:
                q, s = quantize_tensor4(v) if mode == "w4" else quantize_tensor(v)
                out[wkey], out["scale"] = q, s
            else:
                out[k] = walk(v, k)
        return out

    return walk(params, "")


def init_quantized_params(cfg, seed: int = 0, mode: str = "w8",
                          dtype=torch.bfloat16, device="cpu"):
    """Random already-quantized parameters for benchmarking large models:
    the int8 (or packed int4) linears are drawn directly, uniform, with
    scales chosen so the dequantized std matches `init_params` (incl. the
    1/sqrt(2L) output-projection scaling), so the model never exists in
    float.  Norms, embeddings and the head are `dtype`.  For throughput
    work, not accuracy (the values are uniform, not rounded gaussians; the
    draws differ from the JAX package's)."""
    _check_mode(mode)
    wkey = _WKEY[mode]
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, V, I = cfg.n_layer, cfg.n_embd, cfg.padded_vocab_size, cfg.intermediate_size
    std = 0.02
    proj_std = std / (2 * L) ** 0.5

    def ints(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def qlin(out_d, in_d, s=std, lead=(L,)):
        # `lead`: the stack dims, (L, E) for the MoE expert stacks
        if mode == "w4":
            # random packed nibbles in [-8, 7]; rms 4.61 -> matching scale
            g = w4_group_size(in_d)
            return {wkey: ints(-128, 128, (*lead, out_d, in_d // 2)),
                    "scale": torch.full((*lead, out_d, in_d // g), s / 4.61, device=device)}
        # 73.3 = rms of uniform int8 in [-127, 127]
        return {wkey: ints(-127, 128, (*lead, out_d, in_d)),
                "scale": torch.full((*lead, out_d), s / 73.3, device=device)}

    def norm(lead=(L,)):
        p = {"weight": torch.ones(lead + (D,), dtype=dtype, device=device)}
        if cfg.norm_class_name == "LayerNorm" and cfg.bias:
            p["bias"] = torch.zeros(lead + (D,), dtype=dtype, device=device)
        return p

    def emb(rows):
        return (torch.randn((rows, D), generator=gen, device=device) * 0.02).to(dtype)

    attn = {"qkv": qlin(cfg.qkv_size, D), "proj": qlin(D, cfg.attn_out_size, proj_std)}
    if cfg.mlp_class_name == "GptNeoxMLP":
        mlp = {"fc": qlin(I, D), "proj": qlin(D, I, proj_std)}
    elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
        mlp = {"fc_1": qlin(I, D), "fc_2": qlin(I, D), "proj": qlin(D, I, proj_std)}
    elif cfg.mlp_class_name == "LLaMAMoE":
        E = cfg.n_expert
        mlp = {
            "gate": qlin(E, D),  # (L, E, D): the router's logits
            "experts": {
                "fc_1": qlin(I, D, lead=(L, E)),
                "fc_2": qlin(I, D, lead=(L, E)),
                "proj": qlin(D, I, proj_std, lead=(L, E)),
            },
        }
    else:
        raise NotImplementedError(
            f"init_quantized_params: unknown mlp_class_name {cfg.mlp_class_name!r}"
        )
    blocks = {"norm_1": norm(), "attn": attn, "mlp": mlp}
    if not cfg.shared_attention_norm:
        blocks["norm_2"] = norm()
    params = {"wte": {"weight": emb(V)}, "blocks": blocks, "ln_f": norm(())}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": emb(V)}
    return params


def _subscripts(spec: str):
    xin, out = spec.split("->")
    x_sub, w_sub = xin.split(",")
    return x_sub, w_sub, out


def _is_linear(spec: str, w: torch.Tensor) -> bool:
    """`spec` contracts x's last axis with a 2-D (out, in) weight's last
    axis and appends `out`: the shape `F.linear` computes."""
    x_sub, w_sub, out = _subscripts(spec)
    return (w.dim() == 2 and len(w_sub) == 2 and x_sub[-1] == w_sub[1]
            and out == x_sub[:-1] + w_sub[0])


def _apply_scale(spec: str, y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Multiply `y` (the quantized contraction's result) by the per-channel
    scale, aligned by einsum label rather than trailing-axis broadcasting:
    the scale's dims are the weight subscripts minus the contracted last
    one, which need not be trailing in the output."""
    x_sub, w_sub, out = _subscripts(spec)
    if out == x_sub[:-1] + w_sub[:-1]:  # the scale's axes trail: broadcast
        return y * scale
    return torch.einsum(f"{out},{w_sub[:-1]}->{out}", y, scale)


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact; M padded with zero
    rows to what `torch._int_mm` takes on CUDA, the padding sliced off."""
    M = xq.shape[0]
    rows = max(_INT_MM_MIN_ROWS, M)
    rows = -(-rows // 8) * 8
    if rows != M:
        xq = torch.cat([xq, xq.new_zeros((rows - M, xq.shape[1]))])
    kernels.add_flops(2.0 * M * wq.shape[0] * wq.shape[1])
    return torch._int_mm(xq, wq.t())[:M]


def w8a8_int(spec: str, xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int8 x int8 -> int32 contraction of `spec` through
    `torch._int_mm`: a linear-shaped spec as one product; EXPERT_UP with
    the E * I rows of the (E, I, D) stack as the product's N; EXPERT_DOWN
    as one product per expert of the (E, D, I) stack; `EP_UP`/`EP_DOWN`
    as one product per expert of its (E, M, ·) slots."""
    if _is_linear(spec, wq):
        return _int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*xq.shape[:-1], wq.shape[0])
    if spec == EXPERT_UP and wq.dim() == 3:
        E, I, D = wq.shape
        y = _int_mm(xq.reshape(-1, D), wq.reshape(E * I, D))
        return y.reshape(*xq.shape[:-1], E, I)
    if spec == EXPERT_DOWN and wq.dim() == 3:
        E, D, I = wq.shape
        xe = xq.reshape(-1, E, I)
        y = torch.stack([_int_mm(xe[:, e].contiguous(), wq[e]) for e in range(E)], dim=1)
        return y.reshape(*xq.shape[:-2], E, D)
    if spec in (EP_UP, EP_DOWN) and wq.dim() == 3:
        return torch.stack([_int_mm(xq[e].contiguous(), wq[e]) for e in range(wq.shape[0])])
    raise NotImplementedError(
        f"w8a8 contracts through torch._int_mm: a linear-shaped spec (x's last "
        f"axis against a 2-D weight's) or an expert spec ({EXPERT_UP!r}, "
        f"{EXPERT_DOWN!r}, {EP_UP!r}, {EP_DOWN!r} over a 3-D stack) is needed, got {spec!r}"
    )


def _w8a8(spec: str, x: torch.Tensor, p: Params, amax=None) -> torch.Tensor:
    """Dynamic per-token symmetric int8 activations and an exact int8 x
    int8 -> int32 contraction, then the activation and weight scales.
    `amax` (..., 1), when given, is each token's max |x| over the whole
    contracted axis: a tensor-parallel rank holding a slice of that axis
    quantizes its slice on the whole row's scale, as one device does."""
    wq = p["weight_q8"]
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp(_div(amax, 127.0), min=1e-10)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    y = w8a8_int(spec, xq, wq)
    # xs covers x's leading dims; trailing singleton axes make it broadcast
    # over whatever output dims the spec appends (1 for a linear, 2 for
    # EXPERT_UP: (..., 1, 1); EXPERT_DOWN keeps its expert axis: (..., E, 1))
    extra = y.dim() - (x.dim() - 1)
    xs = xs.reshape(xs.shape[:-1] + (1,) * max(extra, 1))
    return _apply_scale(spec, y.float() * xs, p["scale"]).to(x.dtype)


def quantized_einsum(spec: str, x: torch.Tensor, p: Params, amax=None) -> torch.Tensor:
    """einsum against a (possibly) quantized weight dict.  `spec` contracts
    x with the stored (out, in)-layout weight; the per-out-channel scale is
    applied to the result (exact: it factors out of the contraction).
    `amax`: w8a8's per-token activation max over the whole contracted axis
    (`_w8a8`), for a rank that holds a slice of it; other modes ignore it."""
    if "weight_q8" in p:
        return _w8a8(spec, x, p, amax)
    if "weight_q" in p:
        w = p["weight_q"].to(x.dtype)
        y = F.linear(x, w) if _is_linear(spec, w) else torch.einsum(spec, x, w)
        return _apply_scale(spec, y, p["scale"].to(x.dtype))
    if "weight_q4" in p:
        return _w4_einsum(spec, x, p)
    w = p["weight"]
    return F.linear(x, w) if _is_linear(spec, w) else torch.einsum(spec, x, w)


def _w4_einsum(spec: str, x: torch.Tensor, p: Params) -> torch.Tensor:
    """int4 contraction over the two nibble planes, as the JAX package
    computes it: the low and high planes contract the even and odd input
    positions separately, and the group scales, which lie along the
    contracted axis, apply in a second small einsum over the group axis:

        z[.., out, g] = xe_g . lo_g[out] + xo_g . hi_g[out]
        y[.., out]    = sum_g z[.., out, g] * scale[out, g]

    Where x's leading dims are the spec's "...", z is built for a block of
    those rows at a time, under `W4_Z_BYTES` a block; rows are independent,
    so the values are the same.
    """
    x_sub, w_sub, out = _subscripts(spec)
    if x_sub[-1] != w_sub[-1] or "g" in spec or "k" in spec:
        raise NotImplementedError(
            f"_w4_einsum requires a last-subscript contraction and reserves "
            f"letters 'g'/'k' for the group axes; got {spec!r}"
        )
    packed, scale = p["weight_q4"], p["scale"]
    nG = scale.shape[-1]
    Gh = packed.shape[-1] // nG  # per-plane group width
    lo, hi = _nibbles(packed)
    xe = x[..., 0::2].reshape(*x.shape[:-1], nG, Gh)
    xo = x[..., 1::2].reshape(*x.shape[:-1], nG, Gh)
    wl = lo.reshape(*packed.shape[:-1], nG, Gh).to(x.dtype)
    wh = hi.reshape(*packed.shape[:-1], nG, Gh).to(x.dtype)
    zspec = f"{x_sub[:-1]}gk,{w_sub[:-1]}gk->{out}g"
    sspec = f"{out}g,{w_sub[:-1]}g->{out}"
    sc = scale.to(x.dtype)

    def rows(a, b):
        z = torch.einsum(zspec, xe[a:b], wl) + torch.einsum(zspec, xo[a:b], wh)
        return torch.einsum(sspec, z, sc)

    lead = x.dim() - (len(x_sub) - 3)  # the dims "..." covers
    if not (x_sub.startswith("...") and out.startswith("...")) or lead == 0:
        return rows(None, None)
    sizes = dict(zip(w_sub, packed.shape))
    sizes.update(zip(x_sub[3:], x.shape[lead:]))
    per_row = nG * math.prod(sizes[c] for c in out[3:]) * x.element_size()
    block = max(1, W4_Z_BYTES // per_row)
    n = math.prod(x.shape[:lead])
    if n <= block:
        return rows(None, None)
    shape = x.shape
    xe = xe.reshape(n, *xe.shape[lead:])
    xo = xo.reshape(n, *xo.shape[lead:])
    y = torch.cat([rows(a, a + block) for a in range(0, n, block)])
    return y.reshape(*shape[:lead], *y.shape[1:])
