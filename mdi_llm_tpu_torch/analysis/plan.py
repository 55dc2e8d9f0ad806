"""Abstract plan IR for the port's plan audit (`audit.py`).

Port of `mdi_llm_tpu/analysis/plan.py`.  A *plan* is everything that
decides where bytes live and how the rings send before the first weight
reaches the card: the model `Config`, a mesh declaration (axis name ->
size), the parallel strategy (tp/ep axes, pipeline stages, samples per
ring slot) and optionally a `ServingConfig` for the paged pool.  This
module models it symbolically: abstract parameters are `device="meta"`
tensors (the right shape, dtype and `.nbytes`, no storage), permutations
are plain `(src, dst)` tuples.  So the audit evaluates a plan without
touching a card, creating a CUDA context or allocating a byte; the tests
hold it to that with `torch.cuda` entry points patched to raise.

The card the port targets is named here with the limits the audit prices
against (its opt-in shared memory per block, for K1's launch); a plan
names its card by `device_kind`, which the audit never asks the driver
for.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from mdi_llm_tpu_torch.config import Config, ServingConfig

__all__ = [
    "MeshSpec",
    "PlanSpec",
    "H100",
    "SMEM_OPTIN_BYTES",
    "abstract_params",
    "iter_leaves",
    "tree_bytes",
    "ring_permutation",
    "resolve_dtype",
]

H100 = "NVIDIA H100 80GB HBM3"
# opt-in dynamic shared memory per block (cudaDeviceProp::
# sharedMemPerBlockOptin) of the cards the audit knows: 227 KiB on Hopper
SMEM_OPTIN_BYTES: Dict[str, int] = {H100: 227 * 1024}

_DTYPE_ALIASES = {
    "auto": "bfloat16",  # the engine's default when cache_dtype is unset
    "float8": "float8_e4m3fn",
    "bf16": "bfloat16",
    "f16": "float16",
    "f32": "float32",
}


def resolve_dtype(dtype) -> torch.dtype:
    """A dtype name (or torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = _DTYPE_ALIASES.get(str(dtype), str(dtype))
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def _stub(shape: Sequence[int], dtype) -> torch.Tensor:
    """Abstract tensor: right shape/dtype/nbytes, no storage."""
    return torch.empty(tuple(shape), dtype=resolve_dtype(dtype), device="meta")


# ---------------------------------------------------------------------------
# mesh + plan declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declared device mesh: ordered {axis name: size}.  Purely symbolic —
    no devices are enumerated; `n_devices` is what the plan CLAIMS."""

    axes: Tuple[Tuple[str, int], ...] = ()

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshSpec":
        return cls(tuple((str(k), int(v)) for k, v in d.items()))

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """'pipe=4,tp=2' -> MeshSpec.  Empty string -> single device."""
        axes = []
        for part in filter(None, (p.strip() for p in text.split(","))):
            m = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(-?\d+)", part)
            if not m:
                raise ValueError(f"bad mesh axis {part!r} (want name=size)")
            axes.append((m.group(1), int(m.group(2))))
        return cls(tuple(axes))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.axes)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    def size(self, name: str, default: int = 1) -> int:
        return self.sizes.get(name, default)

    @property
    def n_devices(self) -> int:
        return int(math.prod(v for _, v in self.axes)) if self.axes else 1

    def describe(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.axes) or "single-device"


@dataclasses.dataclass
class PlanSpec:
    """One auditable (Config, mesh, parallel plan, ServingConfig) tuple.

    The JAX `PlanSpec`'s fields, less `donate_kv` (the port donates no
    buffer: its steps write the cache in place), plus `device_kind`, the
    card whose tuning-table entry and shared-memory limit K1 is priced
    against.  `kv_seq_len` is the cache length a run allocates (None: the
    window, the conservative ceiling); `ring_perm` overrides the derived
    stage-ring permutation (None -> `ring_permutation(n_stages)`);
    `shard_head` says whether the embedding and head split on tp (the
    Generator's mesh path) or replicate per stage (the pipeline ring).
    """

    cfg: Config
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    tp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    dp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    n_stages: int = 1
    pipeline: Optional[bool] = None  # None -> inferred from n_stages > 1
    samples_per_slot: int = 1
    n_samples: int = 1
    batch: int = 1
    max_seq_length: Optional[int] = None
    kv_seq_len: Optional[int] = None
    act_seq_len: int = 1  # widest live token axis (decode=1, prefill=bucket)
    dtype: str = "bfloat16"
    cache_dtype: Optional[str] = None
    quantize: Optional[str] = None
    serving: Optional[ServingConfig] = None
    ring_perm: Optional[Tuple[Tuple[int, int], ...]] = None
    rank_programs: Optional[List[List[Tuple]]] = None  # per-rank op traces
    hbm_gb: Optional[float] = None
    host_gb: Optional[float] = None  # host-RAM budget for the KV block tier
    shard_head: bool = True
    device_kind: str = H100
    origin: str = "<plan>"

    @property
    def is_pipeline(self) -> bool:
        """True when the plan runs the recurrent ring engine (a 1-stage
        ring still uses slot-based KV, not the dense Generator cache)."""
        return self.n_stages > 1 if self.pipeline is None else bool(self.pipeline)

    @property
    def seq_len(self) -> int:
        s = self.max_seq_length or self.cfg.block_size
        return int(min(s, self.cfg.block_size))

    @property
    def cache_len(self) -> int:
        return int(min(self.kv_seq_len or self.seq_len, self.seq_len))

    @property
    def kv_dtype(self) -> str:
        return self.cache_dtype or self.dtype

    def describe(self) -> str:
        bits = [self.cfg.name or "<config>", f"mesh {self.mesh.describe()}"]
        if self.n_stages > 1:
            bits.append(f"stages={self.n_stages} M={self.samples_per_slot}")
        bits.append(f"dtype={self.dtype}")
        if self.quantize and self.quantize != "none":
            bits.append(f"quant={self.quantize}")
        if self.serving is not None:
            bits.append(f"serve(bs={self.serving.block_size})")
        return " | ".join(bits)


# ---------------------------------------------------------------------------
# abstract parameter shapes
# ---------------------------------------------------------------------------


def abstract_params(cfg: Config, dtype="bfloat16", quantize: Optional[str] = None):
    """Tree of meta tensors mirroring `models.transformer.init_params`
    exactly (shapes, dtypes and key layout), optionally in the quantized
    storage layout of `ops.quant.quantize_params`, so per-leaf `.nbytes`
    is the true device cost."""
    L, D, V = cfg.n_layer, cfg.n_embd, cfg.padded_vocab_size
    I = cfg.intermediate_size

    def lin(out_d, in_d, bias=cfg.bias):
        p = {"weight": _stub((L, out_d, in_d), dtype)}
        if bias:
            p["bias"] = _stub((L, out_d), dtype)
        return p

    def norm_p(lead=(L,)):
        p = {"weight": _stub(lead + (D,), dtype)}
        if cfg.norm_class_name == "LayerNorm" and cfg.bias:
            p["bias"] = _stub(lead + (D,), dtype)
        return p

    attn = {"qkv": lin(cfg.qkv_size, D), "proj": lin(D, cfg.attn_out_size)}
    if cfg.mlp_class_name == "GptNeoxMLP":
        mlp = {"fc": lin(I, D), "proj": lin(D, I)}
    elif cfg.mlp_class_name == "LLaMAMoE":
        E = cfg.n_expert
        mlp = {
            "gate": {"weight": _stub((L, E, D), dtype)},
            "experts": {
                "fc_1": {"weight": _stub((L, E, I, D), dtype)},
                "fc_2": {"weight": _stub((L, E, I, D), dtype)},
                "proj": {"weight": _stub((L, E, D, I), dtype)},
            },
        }
    else:  # LLaMAMLP, GemmaMLP
        mlp = {
            "fc_1": lin(I, D, bias=False),
            "fc_2": lin(I, D, bias=False),
            "proj": lin(D, I, bias=False),
        }
    blocks = {"norm_1": norm_p(), "attn": attn, "mlp": mlp}
    if not cfg.shared_attention_norm:
        blocks["norm_2"] = norm_p()

    params: Dict[str, Any] = {
        "wte": {"weight": _stub((V, D), dtype)},
        "blocks": blocks,
        "ln_f": norm_p(()),
    }
    if cfg.pos_embedding == "learned":
        params["wpe"] = {"weight": _stub((cfg.block_size, D), dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": _stub((V, D), dtype)}
        if cfg.lm_head_bias:
            params["lm_head"]["bias"] = _stub((V,), dtype)
    elif cfg.lm_head_bias:
        params["lm_head"] = {"bias": _stub((V,), dtype)}

    if quantize and quantize != "none":
        params = _quantize_stubs(params, quantize)
    return params


def _quantize_stubs(params, flag: str):
    """`ops.quant.quantize_params`' storage transform on a stub tree: every
    >=2-D "weight" outside SKIP_KEYS becomes int8 storage with f32 scales
    per output channel; int4 packs two nibbles per byte with one scale per
    input group of `w4_group_size`."""
    from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, SKIP_KEYS, w4_group_size

    mode = FLAG_TO_MODE.get(flag, flag)
    if mode not in ("w8", "w8a8", "w4"):
        raise ValueError(f"unknown quantize mode {flag!r}")
    wkey = {"w8": "weight_q", "w8a8": "weight_q8", "w4": "weight_q4"}[mode]

    def walk(node, name):
        if not isinstance(node, dict) or name in SKIP_KEYS:
            return node
        out = {}
        for k, v in node.items():
            if k == "weight" and v.dim() >= 2:
                shape = tuple(v.shape)
                if mode == "w4":
                    in_d = shape[-1]
                    g = w4_group_size(in_d)
                    out[wkey] = _stub(shape[:-1] + (in_d // 2,), torch.int8)
                    out["scale"] = _stub(shape[:-1] + (in_d // g,), torch.float32)
                else:
                    out[wkey] = _stub(shape, torch.int8)
                    out["scale"] = _stub(shape[:-1], torch.float32)
            else:
                out[k] = walk(v, k)
        return out

    return walk(params, "")


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ('blocks.attn.qkv.weight', leaf) pairs in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_bytes(tree) -> int:
    """Bytes of a stub (or real) tree: `.nbytes` is shape-based, so meta
    tensors report the true allocation cost."""
    return sum(int(leaf.nbytes) for _, leaf in iter_leaves(tree))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def ring_permutation(n: int) -> Tuple[Tuple[int, int], ...]:
    """The stage/sp ring every engine builds: i -> (i+1) mod n (the port's
    `parallel/pipeline.py` hop and `ops/ring_attention.py` rotation)."""
    return tuple((i, (i + 1) % n) for i in range(n))
