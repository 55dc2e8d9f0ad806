"""Checkpoints of the port: HF snapshots to the layer-stacked parameter
tree and back, and the port's own checkpoint files.

Port of `mdi_llm_tpu/utils/checkpoint.py` on torch CPU tensors:

- HF shards (`*.safetensors` or `*.bin`, optionally index-sharded) are read
  one file at a time (`iter_hf_tensors`).  Safetensors files go through
  the port's own reader (`read_safetensors`), which maps the file and
  makes each tensor with `torch.frombuffer`, so bfloat16 never passes
  through NumPy (which has no bfloat16 of its own); `write_safetensors`
  writes the same format.  `*.bin` shards go through
  `torch.load(weights_only=True)`.
- The family maps (`_map_llama` for llama/mistral/mixtral/gemma,
  `_map_gpt2`, `_map_neox`, `_map_falcon`, `_map_phi`) build the tree of
  `transformer.init_params`: per-layer leaves stacked on a leading axis,
  the attention projection fused in litGPT's per-group `[q..., k, v]`
  interleave (`fuse_qkv`), the vocabulary padded to `padded_vocab_size`.
  `convert_to_hf_state_dict` is the exact inverse (the `_rev_*` maps):
  only permutations, slices and transposes, so a round trip is
  bit-identical in any dtype.
- A checkpoint of the port is `params.pt` (`torch.save` of the tree) and
  `model_config.yaml` (`Config.save`), the files the Trainer writes.
"""

from __future__ import annotations

import gc
import json
import mmap
import os
import shutil
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.models.transformer import tree_map

PathLike = Union[str, Path]
Tree = Dict[str, Any]

TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer.model",
    "tokenizer_config.json",
    "generation_config.json",
    "prompt_style.yaml",
)
PARAMS_FILE = "params.pt"


# ---------------------------------------------------------------------------
# The safetensors format: an 8-byte little-endian header length, a JSON
# header {name: {dtype, shape, data_offsets}} (plus an optional
# "__metadata__" of strings), then the raw little-endian buffer
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_SAFETENSORS_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def read_safetensors(path: PathLike) -> Dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, as CPU tensors over a
    private (copy-on-write) map of the file: pages are read as the
    tensors are touched, and writing to a tensor never reaches the file."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = path.stat().st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header.pop("__metadata__", None)
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != numel * itemsize or base + end > size:
            raise ValueError(
                f"{path}: tensor {name!r} ({info['dtype']} {shape}) does not "
                f"fit its data_offsets {info['data_offsets']}"
            )
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=torch.uint8, count=end - start, offset=base + start)
        out[name] = t.view(dtype).reshape(shape)
    return out


def write_safetensors(
    tensors: Dict[str, torch.Tensor], path: PathLike,
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write `tensors` as one `.safetensors` file.  Tensors are laid out
    widest element first, so every payload is aligned to its element
    size; the header is padded with spaces to a multiple of 8 bytes."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    # a new file renamed over the old: maps of the old one stay valid
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, t in items:
            if t.numel():
                # mdi-lint: disable-next-line=host-sync -- writing the checkpoint to disk: the copy to the host is the point
                f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


def write_hf_shards(
    state_dict: Dict[str, torch.Tensor], out_dir: PathLike, shard_bytes: int = 5 << 30,
) -> List[Path]:
    """Write a HF state dict as safetensors shards of at most `shard_bytes`
    each (a tensor larger than that gets a shard of its own), with the
    `model.safetensors.index.json` weight map when there is more than one
    shard.  Returns the shard paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shards: List[Dict[str, torch.Tensor]] = [{}]
    used = 0
    for name, t in state_dict.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and used + nbytes > shard_bytes:
            shards.append({})
            used = 0
        shards[-1][name] = t
        used += nbytes
    if len(shards) == 1:
        names = ["model.safetensors"]
    else:
        names = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
                 for i in range(len(shards))]
        total = sum(t.numel() * t.element_size() for t in state_dict.values())
        index = {"metadata": {"total_size": total},
                 "weight_map": {k: n for n, s in zip(names, shards) for k in s}}
        (out_dir / "model.safetensors.index.json").write_text(json.dumps(index, indent=1))
    paths = []
    for name, shard in zip(names, shards):
        write_safetensors(shard, out_dir / name, metadata={"format": "pt"})
        paths.append(out_dir / name)
    return paths


def hf_weight_files(ckpt_dir: Path) -> Tuple[List[Path], List[Path]]:
    """(safetensors shards, `*.bin` shards) of a HF snapshot; raises
    FileNotFoundError when it holds neither."""
    safes = sorted(ckpt_dir.glob("*.safetensors"))
    bins = sorted(
        p
        for p in ckpt_dir.glob("*.bin")
        if "training_args" not in p.name and "optimizer" not in p.name
    )
    if not safes and not bins:
        raise FileNotFoundError(f"no *.safetensors or *.bin weights in {ckpt_dir}")
    return safes, bins


def iter_hf_tensors(ckpt_dir: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) across all weight shards of a HF snapshot
    (the safetensors shards where there are any, else the `*.bin` ones)."""
    safes, bins = hf_weight_files(ckpt_dir)
    for f in safes:
        yield from read_safetensors(f).items()
    if safes:
        return
    for f in bins:
        sd = torch.load(str(f), map_location="cpu", weights_only=True)
        yield from sd.items()
        del sd
        gc.collect()


# ---------------------------------------------------------------------------
# QKV interleave (litGPT layout)
# ---------------------------------------------------------------------------


def fuse_qkv(cfg: Config, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fuse separate q/k/v projection matrices into the interleaved litGPT
    layout: per KV group g, rows [q_g (q_per_kv*hs), k_g (hs), v_g (hs)]."""
    G, hs = cfg.n_query_groups, cfg.head_size
    q_per_kv = cfg.n_head // G
    qs = q.reshape(G, q_per_kv * hs, -1)
    ks = k.reshape(G, hs, -1)
    vs = v.reshape(G, hs, -1)
    return torch.cat([qs, ks, vs], dim=1).reshape(cfg.qkv_size, -1)


def split_qkv(cfg: Config, qkv: torch.Tensor):
    """Inverse of `fuse_qkv`."""
    G, hs = cfg.n_query_groups, cfg.head_size
    q_per_kv = cfg.n_head // G
    fused = qkv.reshape(G, (q_per_kv + 2) * hs, -1)
    q = fused[:, : q_per_kv * hs, :].reshape(G * q_per_kv * hs, -1)
    k = fused[:, q_per_kv * hs : q_per_kv * hs + hs, :].reshape(G * hs, -1)
    v = fused[:, q_per_kv * hs + hs :, :].reshape(G * hs, -1)
    return q, k, v


def _fuse_qkv_bias(cfg: Config, q, k, v) -> torch.Tensor:
    return fuse_qkv(cfg, q[:, None], k[:, None], v[:, None])[:, 0]


def _split_qkv_bias(cfg: Config, qkv_b: torch.Tensor):
    q, k, v = split_qkv(cfg, qkv_b[:, None])
    return q[:, 0], k[:, 0], v[:, 0]


def _pad_vocab(arr: torch.Tensor, padded: int) -> torch.Tensor:
    if arr.shape[0] == padded:
        return arr
    out = torch.zeros((padded,) + tuple(arr.shape[1:]), dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


# ---------------------------------------------------------------------------
# HF -> tree conversion
# ---------------------------------------------------------------------------


def convert_hf_checkpoint(
    ckpt_dir: PathLike,
    model_name: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    out_dir: Optional[PathLike] = None,
) -> Path:
    """Convert a HF snapshot directory into a checkpoint of the port
    (`params.pt` + `model_config.yaml`, and the tokenizer files copied
    beside them).  Returns the output dir."""
    ckpt_dir = Path(ckpt_dir)
    hf_weight_files(ckpt_dir)  # no weights: fail before resolving a config
    out_dir = Path(out_dir) if out_dir else ckpt_dir
    cfg_json = ckpt_dir / "config.json"
    if model_name:
        cfg = Config.from_name(model_name)
        mt = _model_type_for(cfg)
    elif cfg_json.exists():
        hf_cfg = json.loads(cfg_json.read_text())
        cfg = Config.from_hf_config(hf_cfg)
        mt = hf_cfg.get("model_type", "llama")
    else:
        cfg = Config.from_name(ckpt_dir.name)
        mt = _model_type_for(cfg)

    raw: Dict[str, torch.Tensor] = dict(iter_hf_tensors(ckpt_dir))
    if mt in ("llama", "mistral", "mixtral", "gemma"):
        params = _map_llama(cfg, raw)
    elif mt == "gpt2":
        params = _map_gpt2(cfg, raw)
    elif mt == "gpt_neox":
        params = _map_neox(cfg, raw)
    elif mt == "falcon":
        params = _map_falcon(cfg, raw)
    elif mt == "phi":
        params = _map_phi(cfg, raw)
    else:
        raise ValueError(f"unsupported model_type {mt!r} for conversion")
    del raw
    gc.collect()

    params = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, params)
    save_checkpoint(params, cfg, out_dir)
    for f in TOKENIZER_FILES:
        src = ckpt_dir / f
        if src.exists() and not (out_dir / f).exists():
            shutil.copy(src, out_dir / f)
    return out_dir


def _model_type_for(cfg: Config) -> str:
    """Classify a config into its HF naming family structurally (name
    sniffing misroutes e.g. llama finetunes with "phi" in the name).  Among
    the parallel-residual GptNeoxMLP families: phi has a biased LM head,
    falcon has bias-free linears, neox has biased linears."""
    if cfg.pos_embedding == "learned":
        return "gpt2"
    if cfg.mlp_class_name == "GptNeoxMLP" and cfg.parallel_residual:
        if cfg.lm_head_bias:
            return "phi"
        if not cfg.bias:
            return "falcon"
        return "gpt_neox"
    return "llama"


def _stack(layers: List[Tree]) -> Tree:
    """List of per-layer nested dicts -> one nested dict of stacked leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers, dim=0)


def _map_llama(cfg: Config, raw: Dict[str, torch.Tensor]) -> Tree:
    """HF llama/mistral/mixtral/gemma naming -> stacked tree."""
    layers = []
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        lp: Tree = {
            "norm_1": {"weight": raw[pre + "input_layernorm.weight"]},
            "norm_2": {"weight": raw[pre + "post_attention_layernorm.weight"]},
            "attn": {
                "qkv": {
                    "weight": fuse_qkv(
                        cfg,
                        raw[pre + "self_attn.q_proj.weight"],
                        raw[pre + "self_attn.k_proj.weight"],
                        raw[pre + "self_attn.v_proj.weight"],
                    )
                },
                "proj": {"weight": raw[pre + "self_attn.o_proj.weight"]},
            },
        }
        if cfg.mlp_class_name == "LLaMAMoE":
            E = cfg.n_expert
            moe = pre + "block_sparse_moe."
            lp["mlp"] = {
                "gate": {"weight": raw[moe + "gate.weight"]},
                "experts": {
                    "fc_1": {"weight": torch.stack([raw[f"{moe}experts.{e}.w1.weight"] for e in range(E)])},
                    "fc_2": {"weight": torch.stack([raw[f"{moe}experts.{e}.w3.weight"] for e in range(E)])},
                    "proj": {"weight": torch.stack([raw[f"{moe}experts.{e}.w2.weight"] for e in range(E)])},
                },
            }
        else:
            lp["mlp"] = {
                "fc_1": {"weight": raw[pre + "mlp.gate_proj.weight"]},
                "fc_2": {"weight": raw[pre + "mlp.up_proj.weight"]},
                "proj": {"weight": raw[pre + "mlp.down_proj.weight"]},
            }
        layers.append(lp)

    params: Tree = {
        "wte": {"weight": _pad_vocab(raw["model.embed_tokens.weight"], cfg.padded_vocab_size)},
        "blocks": _stack(layers),
        "ln_f": {"weight": raw["model.norm.weight"]},
    }
    if not cfg.tie_embeddings:
        head = raw.get("lm_head.weight", raw["model.embed_tokens.weight"])
        params["lm_head"] = {"weight": _pad_vocab(head, cfg.padded_vocab_size)}
    return params


def _map_gpt2(cfg: Config, raw: Dict[str, torch.Tensor]) -> Tree:
    """HF gpt2 naming -> tree.  HF stores Conv1D weights transposed
    (in, out); the tree stores (out, in).  c_attn's fused [q;k;v] blocks
    are re-interleaved per head to the litGPT group layout."""

    def g(name):
        return raw[name] if name in raw else raw["transformer." + name]

    D = cfg.n_embd
    layers = []
    for i in range(cfg.n_layer):
        pre = f"h.{i}."
        c_attn_w = g(pre + "attn.c_attn.weight").T  # (3D, D)
        c_attn_b = g(pre + "attn.c_attn.bias")
        layers.append(
            {
                "norm_1": {"weight": g(pre + "ln_1.weight"), "bias": g(pre + "ln_1.bias")},
                "norm_2": {"weight": g(pre + "ln_2.weight"), "bias": g(pre + "ln_2.bias")},
                "attn": {
                    "qkv": {
                        "weight": fuse_qkv(cfg, c_attn_w[:D], c_attn_w[D : 2 * D], c_attn_w[2 * D :]),
                        "bias": _fuse_qkv_bias(cfg, c_attn_b[:D], c_attn_b[D : 2 * D], c_attn_b[2 * D :]),
                    },
                    "proj": {"weight": g(pre + "attn.c_proj.weight").T,
                             "bias": g(pre + "attn.c_proj.bias")},
                },
                "mlp": {
                    "fc": {"weight": g(pre + "mlp.c_fc.weight").T, "bias": g(pre + "mlp.c_fc.bias")},
                    "proj": {"weight": g(pre + "mlp.c_proj.weight").T,
                             "bias": g(pre + "mlp.c_proj.bias")},
                },
            }
        )
    return {
        "wte": {"weight": _pad_vocab(g("wte.weight"), cfg.padded_vocab_size)},
        "wpe": {"weight": g("wpe.weight")},
        "blocks": _stack(layers),
        "ln_f": {"weight": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }


def _map_neox(cfg: Config, raw: Dict[str, torch.Tensor]) -> Tree:
    """HF gpt_neox naming -> tree.  NeoX's query_key_value is already the
    per-head [q, k, v] interleave, the litGPT layout for MHA."""
    layers = []
    for i in range(cfg.n_layer):
        pre = f"gpt_neox.layers.{i}."
        layers.append(
            {
                "norm_1": {"weight": raw[pre + "input_layernorm.weight"],
                           "bias": raw[pre + "input_layernorm.bias"]},
                "norm_2": {"weight": raw[pre + "post_attention_layernorm.weight"],
                           "bias": raw[pre + "post_attention_layernorm.bias"]},
                "attn": {
                    "qkv": {"weight": raw[pre + "attention.query_key_value.weight"],
                            "bias": raw[pre + "attention.query_key_value.bias"]},
                    "proj": {"weight": raw[pre + "attention.dense.weight"],
                             "bias": raw[pre + "attention.dense.bias"]},
                },
                "mlp": {
                    "fc": {"weight": raw[pre + "mlp.dense_h_to_4h.weight"],
                           "bias": raw[pre + "mlp.dense_h_to_4h.bias"]},
                    "proj": {"weight": raw[pre + "mlp.dense_4h_to_h.weight"],
                             "bias": raw[pre + "mlp.dense_4h_to_h.bias"]},
                },
            }
        )
    return {
        "wte": {"weight": _pad_vocab(raw["gpt_neox.embed_in.weight"], cfg.padded_vocab_size)},
        "blocks": _stack(layers),
        "ln_f": {"weight": raw["gpt_neox.final_layer_norm.weight"],
                 "bias": raw["gpt_neox.final_layer_norm.bias"]},
        "lm_head": {"weight": _pad_vocab(raw["embed_out.weight"], cfg.padded_vocab_size)},
    }


def _map_falcon(cfg: Config, raw: Dict[str, torch.Tensor]) -> Tree:
    """HF falcon naming -> tree.  Falcon's fused query_key_value is already
    the per-group [q..., k, v] interleave.  Covers both layouts: the 7b one
    (parallel attention, shared input_layernorm) and the 40b/180B
    `new_decoder_architecture` (two norms: ln_attn + ln_mlp)."""
    layers = []
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        if cfg.shared_attention_norm:  # 7b layout
            norms = {"norm_1": {"weight": raw[pre + "input_layernorm.weight"],
                                "bias": raw[pre + "input_layernorm.bias"]}}
        else:  # 40b/180B new_decoder_architecture
            norms = {"norm_1": {"weight": raw[pre + "ln_attn.weight"],
                                "bias": raw[pre + "ln_attn.bias"]},
                     "norm_2": {"weight": raw[pre + "ln_mlp.weight"],
                                "bias": raw[pre + "ln_mlp.bias"]}}
        layers.append(
            {
                **norms,
                "attn": {
                    "qkv": {"weight": raw[pre + "self_attention.query_key_value.weight"]},
                    "proj": {"weight": raw[pre + "self_attention.dense.weight"]},
                },
                "mlp": {
                    "fc": {"weight": raw[pre + "mlp.dense_h_to_4h.weight"]},
                    "proj": {"weight": raw[pre + "mlp.dense_4h_to_h.weight"]},
                },
            }
        )
    return {
        "wte": {"weight": _pad_vocab(raw["transformer.word_embeddings.weight"],
                                     cfg.padded_vocab_size)},
        "blocks": _stack(layers),
        "ln_f": {"weight": raw["transformer.ln_f.weight"], "bias": raw["transformer.ln_f.bias"]},
        "lm_head": {"weight": _pad_vocab(raw["lm_head.weight"], cfg.padded_vocab_size)},
    }


def _map_phi(cfg: Config, raw: Dict[str, torch.Tensor]) -> Tree:
    """HF phi naming -> tree: separate q/k/v with biases fused into the
    interleaved layout, shared input_layernorm, biased LM head."""
    layers = []
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        att = pre + "self_attn."
        layers.append(
            {
                "norm_1": {"weight": raw[pre + "input_layernorm.weight"],
                           "bias": raw[pre + "input_layernorm.bias"]},
                "attn": {
                    "qkv": {
                        "weight": fuse_qkv(cfg, raw[att + "q_proj.weight"],
                                           raw[att + "k_proj.weight"], raw[att + "v_proj.weight"]),
                        "bias": _fuse_qkv_bias(cfg, raw[att + "q_proj.bias"],
                                               raw[att + "k_proj.bias"], raw[att + "v_proj.bias"]),
                    },
                    "proj": {"weight": raw[att + "dense.weight"], "bias": raw[att + "dense.bias"]},
                },
                "mlp": {
                    "fc": {"weight": raw[pre + "mlp.fc1.weight"], "bias": raw[pre + "mlp.fc1.bias"]},
                    "proj": {"weight": raw[pre + "mlp.fc2.weight"], "bias": raw[pre + "mlp.fc2.bias"]},
                },
            }
        )
    return {
        "wte": {"weight": _pad_vocab(raw["model.embed_tokens.weight"], cfg.padded_vocab_size)},
        "blocks": _stack(layers),
        "ln_f": {"weight": raw["model.final_layernorm.weight"],
                 "bias": raw["model.final_layernorm.bias"]},
        "lm_head": {
            "weight": _pad_vocab(raw["lm_head.weight"], cfg.padded_vocab_size),
            "bias": _pad_vocab(raw["lm_head.bias"], cfg.padded_vocab_size),
        },
    }


# ---------------------------------------------------------------------------
# Reverse conversion: tree -> HF state dict
# ---------------------------------------------------------------------------


def convert_to_hf_state_dict(cfg: Config, params: Tree) -> Dict[str, torch.Tensor]:
    """The tree in HF state-dict naming, dispatched by model family.  The
    tensors are CPU views and copies of the tree's leaves."""
    params = tree_map(lambda x: x.detach().cpu(), params)
    mt = _model_type_for(cfg)
    if mt == "falcon":
        return _rev_falcon(cfg, params)
    if mt == "phi":
        return _rev_phi(cfg, params)
    if mt == "gpt_neox":
        return _rev_neox(cfg, params)
    if mt == "gpt2":
        return _rev_gpt2(cfg, params)
    return _rev_llama(cfg, params)


def _rev_llama(cfg: Config, params: Tree) -> Dict[str, torch.Tensor]:
    if cfg.mlp_class_name not in ("LLaMAMLP", "GemmaMLP", "LLaMAMoE"):
        # e.g. RedPajama/StableLM: GptNeoxMLP without parallel residual has
        # no HF llama naming to map onto
        raise NotImplementedError(
            f"reverse conversion not implemented for mlp_class_name="
            f"{cfg.mlp_class_name!r} with parallel_residual={cfg.parallel_residual}"
        )
    out: Dict[str, torch.Tensor] = {}
    out["model.embed_tokens.weight"] = params["wte"]["weight"][: cfg.vocab_size]
    out["model.norm.weight"] = params["ln_f"]["weight"]
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"]["weight"][: cfg.vocab_size]
    b = params["blocks"]
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        q, k, v = split_qkv(cfg, b["attn"]["qkv"]["weight"][i])
        out[pre + "self_attn.q_proj.weight"] = q
        out[pre + "self_attn.k_proj.weight"] = k
        out[pre + "self_attn.v_proj.weight"] = v
        out[pre + "self_attn.o_proj.weight"] = b["attn"]["proj"]["weight"][i]
        out[pre + "input_layernorm.weight"] = b["norm_1"]["weight"][i]
        out[pre + "post_attention_layernorm.weight"] = b["norm_2"]["weight"][i]
        if cfg.mlp_class_name == "LLaMAMoE":
            moe = pre + "block_sparse_moe."
            out[moe + "gate.weight"] = b["mlp"]["gate"]["weight"][i]
            ex = b["mlp"]["experts"]
            for e in range(cfg.n_expert):
                out[f"{moe}experts.{e}.w1.weight"] = ex["fc_1"]["weight"][i, e]
                out[f"{moe}experts.{e}.w3.weight"] = ex["fc_2"]["weight"][i, e]
                out[f"{moe}experts.{e}.w2.weight"] = ex["proj"]["weight"][i, e]
        else:  # LLaMAMLP / GemmaMLP
            out[pre + "mlp.gate_proj.weight"] = b["mlp"]["fc_1"]["weight"][i]
            out[pre + "mlp.up_proj.weight"] = b["mlp"]["fc_2"]["weight"][i]
            out[pre + "mlp.down_proj.weight"] = b["mlp"]["proj"]["weight"][i]
    return out


def _rev_neox(cfg: Config, params: Tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    # pythia-family HF checkpoints size their embeddings at the PADDED vocab
    # (GPTNeoXConfig.vocab_size == 50304): emit all rows, no truncation
    out["gpt_neox.embed_in.weight"] = params["wte"]["weight"]
    out["gpt_neox.final_layer_norm.weight"] = params["ln_f"]["weight"]
    out["gpt_neox.final_layer_norm.bias"] = params["ln_f"]["bias"]
    out["embed_out.weight"] = params["lm_head"]["weight"]
    b = params["blocks"]
    for i in range(cfg.n_layer):
        pre = f"gpt_neox.layers.{i}."
        out[pre + "input_layernorm.weight"] = b["norm_1"]["weight"][i]
        out[pre + "input_layernorm.bias"] = b["norm_1"]["bias"][i]
        out[pre + "post_attention_layernorm.weight"] = b["norm_2"]["weight"][i]
        out[pre + "post_attention_layernorm.bias"] = b["norm_2"]["bias"][i]
        out[pre + "attention.query_key_value.weight"] = b["attn"]["qkv"]["weight"][i]
        out[pre + "attention.query_key_value.bias"] = b["attn"]["qkv"]["bias"][i]
        out[pre + "attention.dense.weight"] = b["attn"]["proj"]["weight"][i]
        out[pre + "attention.dense.bias"] = b["attn"]["proj"]["bias"][i]
        out[pre + "mlp.dense_h_to_4h.weight"] = b["mlp"]["fc"]["weight"][i]
        out[pre + "mlp.dense_h_to_4h.bias"] = b["mlp"]["fc"]["bias"][i]
        out[pre + "mlp.dense_4h_to_h.weight"] = b["mlp"]["proj"]["weight"][i]
        out[pre + "mlp.dense_4h_to_h.bias"] = b["mlp"]["proj"]["bias"][i]
    return out


def _rev_falcon(cfg: Config, params: Tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    out["transformer.word_embeddings.weight"] = params["wte"]["weight"][: cfg.vocab_size]
    out["transformer.ln_f.weight"] = params["ln_f"]["weight"]
    out["transformer.ln_f.bias"] = params["ln_f"]["bias"]
    out["lm_head.weight"] = params["lm_head"]["weight"][: cfg.vocab_size]
    b = params["blocks"]
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        if cfg.shared_attention_norm:  # 7b layout
            out[pre + "input_layernorm.weight"] = b["norm_1"]["weight"][i]
            out[pre + "input_layernorm.bias"] = b["norm_1"]["bias"][i]
        else:  # 40b/180B new_decoder_architecture
            out[pre + "ln_attn.weight"] = b["norm_1"]["weight"][i]
            out[pre + "ln_attn.bias"] = b["norm_1"]["bias"][i]
            out[pre + "ln_mlp.weight"] = b["norm_2"]["weight"][i]
            out[pre + "ln_mlp.bias"] = b["norm_2"]["bias"][i]
        out[pre + "self_attention.query_key_value.weight"] = b["attn"]["qkv"]["weight"][i]
        out[pre + "self_attention.dense.weight"] = b["attn"]["proj"]["weight"][i]
        out[pre + "mlp.dense_h_to_4h.weight"] = b["mlp"]["fc"]["weight"][i]
        out[pre + "mlp.dense_4h_to_h.weight"] = b["mlp"]["proj"]["weight"][i]
    return out


def _rev_phi(cfg: Config, params: Tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    out["model.embed_tokens.weight"] = params["wte"]["weight"][: cfg.vocab_size]
    out["model.final_layernorm.weight"] = params["ln_f"]["weight"]
    out["model.final_layernorm.bias"] = params["ln_f"]["bias"]
    out["lm_head.weight"] = params["lm_head"]["weight"][: cfg.vocab_size]
    out["lm_head.bias"] = params["lm_head"]["bias"][: cfg.vocab_size]
    b = params["blocks"]
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        att = pre + "self_attn."
        out[pre + "input_layernorm.weight"] = b["norm_1"]["weight"][i]
        out[pre + "input_layernorm.bias"] = b["norm_1"]["bias"][i]
        q, k, v = split_qkv(cfg, b["attn"]["qkv"]["weight"][i])
        qb, kb, vb = _split_qkv_bias(cfg, b["attn"]["qkv"]["bias"][i])
        out[att + "q_proj.weight"], out[att + "q_proj.bias"] = q, qb
        out[att + "k_proj.weight"], out[att + "k_proj.bias"] = k, kb
        out[att + "v_proj.weight"], out[att + "v_proj.bias"] = v, vb
        out[att + "dense.weight"] = b["attn"]["proj"]["weight"][i]
        out[att + "dense.bias"] = b["attn"]["proj"]["bias"][i]
        out[pre + "mlp.fc1.weight"] = b["mlp"]["fc"]["weight"][i]
        out[pre + "mlp.fc1.bias"] = b["mlp"]["fc"]["bias"][i]
        out[pre + "mlp.fc2.weight"] = b["mlp"]["proj"]["weight"][i]
        out[pre + "mlp.fc2.bias"] = b["mlp"]["proj"]["bias"][i]
    return out


def _rev_gpt2(cfg: Config, params: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of `_map_gpt2`: de-interleave QKV back to HF's fused [q;k;v]
    and restore the Conv1D (in, out) transposition.  lm_head is tied."""
    out: Dict[str, torch.Tensor] = {}
    out["transformer.wte.weight"] = params["wte"]["weight"][: cfg.vocab_size]
    out["transformer.wpe.weight"] = params["wpe"]["weight"]
    out["transformer.ln_f.weight"] = params["ln_f"]["weight"]
    out["transformer.ln_f.bias"] = params["ln_f"]["bias"]
    b = params["blocks"]
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        q, k, v = split_qkv(cfg, b["attn"]["qkv"]["weight"][i])
        qb, kb, vb = _split_qkv_bias(cfg, b["attn"]["qkv"]["bias"][i])
        out[pre + "attn.c_attn.weight"] = torch.cat([q, k, v], dim=0).T
        out[pre + "attn.c_attn.bias"] = torch.cat([qb, kb, vb], dim=0)
        out[pre + "attn.c_proj.weight"] = b["attn"]["proj"]["weight"][i].T
        out[pre + "attn.c_proj.bias"] = b["attn"]["proj"]["bias"][i]
        out[pre + "ln_1.weight"] = b["norm_1"]["weight"][i]
        out[pre + "ln_1.bias"] = b["norm_1"]["bias"][i]
        out[pre + "ln_2.weight"] = b["norm_2"]["weight"][i]
        out[pre + "ln_2.bias"] = b["norm_2"]["bias"][i]
        out[pre + "mlp.c_fc.weight"] = b["mlp"]["fc"]["weight"][i].T
        out[pre + "mlp.c_fc.bias"] = b["mlp"]["fc"]["bias"][i]
        out[pre + "mlp.c_proj.weight"] = b["mlp"]["proj"]["weight"][i].T
        out[pre + "mlp.c_proj.bias"] = b["mlp"]["proj"]["bias"][i]
    return out


# ---------------------------------------------------------------------------
# The port's checkpoint files
# ---------------------------------------------------------------------------


def save_checkpoint(params: Tree, cfg: Config, out_dir: PathLike) -> Path:
    """Write `params.pt` + `model_config.yaml` into `out_dir`."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / (PARAMS_FILE + ".tmp")
    torch.save(tree_map(lambda x: x.detach().cpu().contiguous(), params), tmp)
    os.replace(tmp, out_dir / PARAMS_FILE)
    cfg.save(out_dir)
    return out_dir


def load_checkpoint(
    ckpt_dir: PathLike, dtype: Optional[torch.dtype] = None,
    cfg: Optional[Config] = None, device="cpu",
    experts: Optional[Tuple[int, int]] = None,
) -> Tuple[Config, Tree]:
    """(cfg, params) of a checkpoint dir, params cast to `dtype` (None
    keeps the stored dtypes) on `device`.  The tree is read to the host
    and its leaves move to the device one at a time, each host copy freed
    as its leaf moves.  The cast is quantization-aware: integer leaves and
    "scale" leaves keep their dtype.  `experts` = (first, count) keeps
    only those experts of the MoE stacks (axis 1 of every leaf of two or
    more dims under an "experts" subtree, as `parallel.expert.place_ep`
    splits them): the file is mapped, not read, and only their bytes
    reach the host and the device."""
    ckpt_dir = Path(ckpt_dir).resolve()
    if cfg is None:
        cfg = Config.from_checkpoint(ckpt_dir)
    params = torch.load(ckpt_dir / PARAMS_FILE, map_location="cpu", weights_only=True,
                        mmap=experts is not None)

    def place(tree: Tree, in_experts: bool = False) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                place(v, in_experts or k == "experts")
                continue
            if in_experts and experts is not None and v.dim() >= 2:
                v = v.narrow(1, *experts).clone()
            if dtype is not None and v.is_floating_point() and k != "scale":
                v = v.to(dtype)
            tree[k] = v.to(device)

    place(params)
    return cfg, params


def has_checkpoint(ckpt_dir: PathLike) -> bool:
    return (Path(ckpt_dir) / PARAMS_FILE).is_file()
