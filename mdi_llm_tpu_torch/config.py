"""Model configuration and the named-model registry (PyTorch port).

A copy of `mdi_llm_tpu/config.py`: the port keeps its own so that it never
imports the JAX package.  `Config`, the `name_to_config`/`configs`
registry, `ServingConfig` and `dtype_bytes` are unchanged, so a config and
its pool formulas mean the same thing in both packages
(tests/test_torch_config.py holds them equal).
`ServingConfig.resolved_host_link_gbps` reads the port's own link table
(`serving/host_tier.py`, keyed on the CUDA device name).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = [
    "Config",
    "ServingConfig",
    "name_to_config",
    "configs",
    "find_multiple",
    "dtype_bytes",
    # generation defaults (parity with reference src/sub/config.py:47-52)
    "TOP_K",
    "TEMPERATURE",
]

# Generation defaults — parity with reference `src/sub/config.py:47-52`.
TOP_K = 200
TEMPERATURE = 0.8

# Default RNG seed used across all reference entry points
# (`starter.py:195`, `sample.py:354`, `train.py:471`).
DEFAULT_SEED = 10137


def find_multiple(n: int, k: int) -> int:
    """Smallest multiple of `k` that is >= `n`."""
    if n % k == 0:
        return n
    return n + k - (n % k)


# Itemsize table for the dtypes this stack actually stores.  Kept as a plain
# dict (no numpy/jax import) so memory estimation (`estimate_kv_bytes`,
# `ServingConfig.pool_bytes`, analysis/plan.py) stays backend-free.
_DTYPE_BYTES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4, "f32": 4,
    "float16": 2, "bfloat16": 2, "f16": 2, "bf16": 2,
    "float8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1, "int8": 1, "uint8": 1,
}


def dtype_bytes(dtype) -> int:
    """Bytes per element for a dtype given as a string name, a numpy dtype,
    or a jax/numpy scalar type — resolved without importing numpy or jax."""
    if not isinstance(dtype, str):
        itemsize = getattr(dtype, "itemsize", None)
        if isinstance(itemsize, int) and itemsize > 0:
            return itemsize  # np.dtype instances
        dtype = getattr(dtype, "__name__", None) or getattr(
            dtype, "name", str(dtype)
        )  # scalar types (np.float32, jnp.bfloat16=ml_dtypes.bfloat16)
    key = str(dtype).lower()
    if key not in _DTYPE_BYTES:
        raise ValueError(f"unknown dtype {dtype!r} (known: {sorted(_DTYPE_BYTES)})")
    return _DTYPE_BYTES[key]


@dataclass
class Config:
    """Architecture hyper-parameters for one decoder-only transformer.

    Field names intentionally match the public litGPT schema (the reference's
    `Config` at `model.py:93-183` is litGPT-derived) so YAML checkpoints
    interoperate.  Extra TPU-framework fields are listed at the bottom.
    """

    name: str = ""
    hf_config: dict = field(default_factory=dict)
    scale_embeddings: bool = False
    block_size: int = 4096
    vocab_size: int = 50254
    padding_multiple: int = 512
    padded_vocab_size: Optional[int] = None
    n_layer: int = 16
    n_head: int = 32
    head_size: Optional[int] = None
    n_embd: int = 4096
    rotary_percentage: float = 0.25
    parallel_residual: bool = True
    bias: bool = True
    lm_head_bias: bool = False
    # n_query_groups: n_head => MHA, 1 => MQA, in between => GQA
    n_query_groups: Optional[int] = None
    shared_attention_norm: bool = False
    norm_class_name: str = "LayerNorm"  # "LayerNorm" | "RMSNorm"
    norm_eps: float = 1e-5
    mlp_class_name: str = "GptNeoxMLP"  # GptNeoxMLP | LLaMAMLP | GemmaMLP | LLaMAMoE
    gelu_approximate: str = "none"
    intermediate_size: Optional[int] = None
    rope_condense_ratio: int = 1
    rope_base: int = 10000
    n_expert: int = 0
    n_expert_per_token: int = 0

    # ---- TPU-framework extensions (not in litGPT) --------------------------
    # "rope" for all modern families; "learned" resurrects the legacy GPT-2
    # generation (reference `old/GPT2/sub/model.py`) with learned absolute
    # position embeddings.
    pos_embedding: str = "rope"
    # Tie lm_head to wte (Gemma, GPT-2, and scratch-trained models).
    tie_embeddings: bool = False
    # Gemma-style RMSNorm: weight enters as (1 + w) (reference RMSNorm
    # unit-offset variant, model.py:950-981).
    rmsnorm_add_unit_offset: bool = False

    def __post_init__(self):
        if not self.name:
            self.name = self.hf_config.get("name", self.name)

        if self.head_size is None:
            assert self.n_embd % self.n_head == 0, (self.n_embd, self.n_head)
            self.head_size = self.n_embd // self.n_head

        if self.padded_vocab_size is None:
            self.padded_vocab_size = find_multiple(
                self.vocab_size, self.padding_multiple
            )
        else:
            self.vocab_size = min(self.vocab_size, self.padded_vocab_size)

        if self.n_query_groups is not None:
            assert self.n_head % self.n_query_groups == 0
        else:
            self.n_query_groups = self.n_head

        if self.intermediate_size is None:
            if self.mlp_class_name == "LLaMAMLP":
                raise ValueError(
                    f"config {self.name!r} needs `intermediate_size` for LLaMAMLP"
                )
            self.intermediate_size = 4 * self.n_embd

        self.rope_n_elem = int(self.rotary_percentage * self.head_size)

    # ---- derived sizes -----------------------------------------------------

    @property
    def qkv_size(self) -> int:
        """Rows of the fused QKV projection (litGPT layout: interleaved
        per-group [q*q_per_kv, k, v])."""
        q_per_kv = self.n_head // self.n_query_groups
        return (q_per_kv + 2) * self.head_size * self.n_query_groups

    @property
    def attn_out_size(self) -> int:
        return self.head_size * self.n_head

    def estimate_params(self) -> int:
        """Rough parameter count (embeddings counted once if tied)."""
        V, D, L = self.padded_vocab_size, self.n_embd, self.n_layer
        emb = V * D
        head = 0 if self.tie_embeddings else V * D
        attn = D * self.qkv_size + self.attn_out_size * D
        if self.bias:
            attn += self.qkv_size + D
        I = self.intermediate_size
        if self.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
            mlp = 3 * D * I
        elif self.mlp_class_name == "LLaMAMoE":
            mlp = self.n_expert * 3 * D * I + D * self.n_expert
        else:
            mlp = 2 * D * I + (I + D if self.bias else 0)
        norms = 2 * D * (2 if self.bias and self.norm_class_name == "LayerNorm" else 1)
        return emb + head + L * (attn + mlp + norms) + D

    def estimate_param_bytes(self, dtype="bfloat16") -> int:
        """HBM bytes of the parameter tree stored at `dtype` — the
        backend-free analytic twin of `obs.roofline.param_bytes` (which
        measures a LIVE tree, quantized storage included).  Used by the
        roofline/docs tables when no weights exist yet."""
        return self.estimate_params() * dtype_bytes(dtype)

    def estimate_kv_bytes(
        self, batch: int, seq: int, dtype="bfloat16", n_layer: Optional[int] = None
    ) -> int:
        """HBM bytes of a dense KV cache for `batch` sequences of length
        `seq`: k + v, each (L, B, G, S, hs) — `transformer.init_kv_cache`.
        Pass `n_layer` for a pipeline stage's slice."""
        L = self.n_layer if n_layer is None else n_layer
        per = L * batch * self.n_query_groups * seq * self.head_size
        return 2 * per * dtype_bytes(dtype)

    # ---- constructors ------------------------------------------------------

    @classmethod
    def from_name(cls, name: str, **overrides: Any) -> "Config":
        """Look up a named config; accepts exact registry names."""
        if name in name_to_config:
            conf_dict = name_to_config[name]
        else:
            # allow e.g. "Llama-3-8B-Instruct" to match template "Llama-3-8B{}"
            matches = [
                d
                for d in configs
                if "{}" in d["name"]
                and name.startswith(d["name"].split("{}")[0])
                and name.endswith(d["name"].split("{}")[1])
            ]
            if not matches:
                raise ValueError(f"unknown model name {name!r}")
            conf_dict = matches[0]
        conf_dict = dict(conf_dict)
        conf_dict["name"] = name
        conf_dict.update(overrides)
        conf_dict.pop("_template", None)
        return cls(**conf_dict)

    @classmethod
    def from_file(cls, path: "str | Path", **overrides: Any) -> "Config":
        """Load from a `model_config.yaml` (reference `model.py:203-214`) or
        a JSON config file."""
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            data = _parse_simple_yaml(text)
        else:
            data = json.loads(text)
        data.update(overrides)
        known = {f.name for f in dataclasses.fields(cls)}
        data = {k: v for k, v in data.items() if k in known}
        return cls(**data)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: "str | Path", **overrides: Any) -> "Config":
        """Load config given a checkpoint directory: `model_config.yaml` if
        present, else fall back to the registry by directory name
        (reference `model.py:216-236`)."""
        ckpt_dir = Path(ckpt_dir)
        for fname in ("model_config.yaml", "model_config.json", "config.json"):
            p = ckpt_dir / fname
            if p.exists():
                if fname == "config.json":
                    return cls.from_hf_config(json.loads(p.read_text()), **overrides)
                return cls.from_file(p, **overrides)
        return cls.from_name(ckpt_dir.name, **overrides)

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any], **overrides: Any) -> "Config":
        """Ground-truth path: map a HuggingFace `config.json` dict to Config.

        Supports the llama/mistral/mixtral families (the reference's final
        generation targets litGPT Llama, `convert_hf_checkpoint.py:110-198`),
        plus gpt2 and gpt_neox for the legacy generations.
        """
        mt = hf.get("model_type", "llama")
        if mt in ("llama", "mistral", "mixtral"):
            data = dict(
                name=hf.get("_name_or_path", mt),
                block_size=hf.get("max_position_embeddings", 4096),
                vocab_size=hf["vocab_size"],
                padded_vocab_size=hf["vocab_size"],
                n_layer=hf["num_hidden_layers"],
                n_head=hf["num_attention_heads"],
                n_embd=hf["hidden_size"],
                n_query_groups=hf.get(
                    "num_key_value_heads", hf["num_attention_heads"]
                ),
                head_size=hf.get("head_dim"),  # Mistral-Nemo etc.: != D // H
                rotary_percentage=1.0,
                parallel_residual=False,
                bias=False,
                norm_class_name="RMSNorm",
                norm_eps=hf.get("rms_norm_eps", 1e-5),
                mlp_class_name="LLaMAMoE" if mt == "mixtral" else "LLaMAMLP",
                intermediate_size=hf["intermediate_size"],
                rope_base=int(hf.get("rope_theta", 10000)),
                tie_embeddings=hf.get("tie_word_embeddings", False),
            )
            if mt == "mixtral":
                data["n_expert"] = hf.get("num_local_experts", 8)
                data["n_expert_per_token"] = hf.get("num_experts_per_tok", 2)
        elif mt == "gpt2":
            data = dict(
                name=hf.get("_name_or_path", "gpt2"),
                block_size=hf.get("n_positions", 1024),
                vocab_size=hf["vocab_size"],
                padding_multiple=64,
                n_layer=hf["n_layer"],
                n_head=hf["n_head"],
                n_embd=hf["n_embd"],
                rotary_percentage=0.0,
                pos_embedding="learned",
                parallel_residual=False,
                bias=True,
                norm_class_name="LayerNorm",
                norm_eps=hf.get("layer_norm_epsilon", 1e-5),
                mlp_class_name="GptNeoxMLP",
                gelu_approximate=(
                    "tanh"
                    if hf.get("activation_function", "gelu_new") == "gelu_new"
                    else "none"
                ),
                tie_embeddings=True,
            )
        elif mt == "falcon":
            multi_query = hf.get("multi_query", True)
            new_arch = hf.get("new_decoder_architecture", False)
            if new_arch:
                groups = hf.get("num_kv_heads", hf["num_attention_heads"])
            elif multi_query:
                groups = 1
            else:
                groups = hf["num_attention_heads"]
            data = dict(
                name=hf.get("_name_or_path", "falcon"),
                block_size=hf.get("max_position_embeddings", 2048),
                vocab_size=hf["vocab_size"],
                padded_vocab_size=hf["vocab_size"],
                n_layer=hf["num_hidden_layers"],
                n_head=hf["num_attention_heads"],
                n_embd=hf["hidden_size"],
                n_query_groups=groups,
                rotary_percentage=1.0,
                parallel_residual=hf.get("parallel_attn", True),
                bias=hf.get("bias", False),
                shared_attention_norm=not new_arch,
                norm_class_name="LayerNorm",
                norm_eps=hf.get("layer_norm_epsilon", 1e-5),
                mlp_class_name="GptNeoxMLP",
                rope_base=int(hf.get("rope_theta", 10000)),
                tie_embeddings=hf.get("tie_word_embeddings", False),
            )
        elif mt == "phi":
            data = dict(
                name=hf.get("_name_or_path", "phi"),
                block_size=hf.get("max_position_embeddings", 2048),
                vocab_size=hf["vocab_size"],
                padded_vocab_size=hf["vocab_size"],
                n_layer=hf["num_hidden_layers"],
                n_head=hf["num_attention_heads"],
                n_embd=hf["hidden_size"],
                rotary_percentage=hf.get("partial_rotary_factor", 0.5),
                parallel_residual=True,
                shared_attention_norm=True,
                bias=True,
                lm_head_bias=True,
                norm_class_name="LayerNorm",
                norm_eps=hf.get("layer_norm_eps", 1e-5),
                mlp_class_name="GptNeoxMLP",
                gelu_approximate="tanh",
                intermediate_size=hf.get("intermediate_size"),
                rope_base=int(hf.get("rope_theta", 10000)),
            )
        elif mt == "gemma":
            data = dict(
                name=hf.get("_name_or_path", "gemma"),
                block_size=hf.get("max_position_embeddings", 8192),
                vocab_size=hf["vocab_size"],
                padded_vocab_size=hf["vocab_size"],
                n_layer=hf["num_hidden_layers"],
                n_head=hf["num_attention_heads"],
                n_embd=hf["hidden_size"],
                n_query_groups=hf.get("num_key_value_heads", 1),
                head_size=hf.get("head_dim"),
                rotary_percentage=1.0,
                parallel_residual=False,
                bias=False,
                norm_class_name="RMSNorm",
                norm_eps=hf.get("rms_norm_eps", 1e-6),
                mlp_class_name="GemmaMLP",
                gelu_approximate="tanh",
                intermediate_size=hf["intermediate_size"],
                rope_base=int(hf.get("rope_theta", 10000)),
                scale_embeddings=True,
                tie_embeddings=True,
                rmsnorm_add_unit_offset=True,
            )
        elif mt == "gpt_neox":
            data = dict(
                name=hf.get("_name_or_path", "gpt_neox"),
                block_size=hf.get("max_position_embeddings", 2048),
                vocab_size=hf["vocab_size"],
                padded_vocab_size=hf["vocab_size"],
                n_layer=hf["num_hidden_layers"],
                n_head=hf["num_attention_heads"],
                n_embd=hf["hidden_size"],
                rotary_percentage=hf.get("rotary_pct", 0.25),
                parallel_residual=hf.get("use_parallel_residual", True),
                bias=True,
                norm_class_name="LayerNorm",
                norm_eps=hf.get("layer_norm_eps", 1e-5),
                mlp_class_name="GptNeoxMLP",
                intermediate_size=hf.get("intermediate_size"),
                rope_base=int(hf.get("rotary_emb_base", 10000)),
                tie_embeddings=hf.get("tie_word_embeddings", False),
            )
        else:
            raise ValueError(f"unsupported HF model_type {mt!r}")
        data.update(overrides)
        return cls(**data)

    # ---- serialization -----------------------------------------------------

    def asdict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("rope_n_elem", None)
        return d

    def save(self, ckpt_dir: "str | Path") -> None:
        """Write `model_config.yaml` (reference `utils.py:608-611`)."""
        ckpt_dir = Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        lines = []
        for k, v in self.asdict().items():
            if isinstance(v, dict):
                lines.append(f"{k}:")
                for kk, vv in v.items():
                    lines.append(f"  {kk}: {_yaml_scalar(vv)}")
            else:
                lines.append(f"{k}: {_yaml_scalar(v)}")
        (ckpt_dir / "model_config.yaml").write_text("\n".join(lines) + "\n")

    def replace(self, **kw: Any) -> "Config":
        d = self.asdict()
        d.update(kw)
        return Config(**d)


@dataclass
class ServingConfig:
    """Knobs for the paged-KV continuous-batching engine
    (`serving.engine.ServingEngine`, built via `Generator.serve`).

    Not to be confused with `Config.block_size` (the model's context
    window): `block_size` HERE is the width of one KV pool block in tokens.
    """

    # KV pool geometry -------------------------------------------------------
    block_size: int = 16  # tokens per KV block (pool page width)
    max_blocks: Optional[int] = None  # pool size; None → full coverage
    # (1 trash block + max_batch × ceil(max_seq_length / block_size))
    # scheduling --------------------------------------------------------------
    max_batch: int = 8  # concurrent decode slots (jit batch shape)
    prefill_chunk: int = 128  # max prompt tokens one sequence feeds per step
    prefix_caching: bool = True  # hash-chain block reuse for shared prompts
    token_budget: Optional[int] = None  # unified-step token budget: the
    # mixed ragged batch packs every decode lane's pending token FIRST,
    # then prefill chunk tokens into the remainder, all in ONE forward of
    # static width `token_budget` (Sarathi-style composition; prompts
    # longer than the leftover split across steps).  None → max_batch +
    # prefill_chunk (every lane plus one full chunk).  Must exceed
    # max_batch or prefill could never progress (mdi-audit:
    # bad-token-budget)
    # decode dispatch ---------------------------------------------------------
    decode_chunk: int = 8  # device decode steps per host sync (lax.scan):
    # the host reads tokens once per K steps instead of per token, so the
    # dispatch RTT amortizes as RTT/K (docs/perf.md "Serving host-sync").
    # 1 = the per-step engine (one sync per token)
    double_buffer: bool = True  # dispatch chunk N+1 (chained on device
    # arrays) before reading chunk N, so the host read overlaps compute;
    # engaged only while no prefill/admission/preemption work is pending
    spec_k: int = 0  # speculative draft length for serving decode: per-slot
    # drafts (prompt n-gram lookup, or the optional draft model below)
    # verified in ONE ragged forward over the paged cache, emitting up to
    # K+1 tokens per sync.  At temperature 0 the verify is exact-match
    # (token-identical to plain decode); at temperature>0 it is the
    # rejection-sampled verify (accept draft token w.p.
    # min(1, p_verify/p_draft), else resample the residual) — emitted
    # tokens are distributed exactly as the per-step sampler's.
    # `spec_sampled` gates the verify rule.  None → auto: exact-match at
    # temperature 0, rejection-sampled at temperature>0.  False pins the
    # OLD greedy-only exact-match path (temperature>0 with spec_k then
    # refuses, naming this flag); True forces the sampled rule even at
    # temperature 0 (same tokens as exact-match there, by construction).
    spec_sampled: Optional[bool] = None
    # optional small draft model (a `Config.from_name` registry name) that
    # drafts spec_k tokens in one jitted greedy scan for slots where
    # `ngram_draft` misses.  It shares the paged-pool budget: a second
    # KVPool holds its blocks, carved out of `max_blocks` by `draft_share`
    # when the pool is bounded (full coverage when max_blocks is None).
    draft_model: Optional[str] = None
    # fraction of a bounded `max_blocks` budget handed to the draft pool
    # (block-count partition of the shared range; the draft model's
    # smaller per-block bytes make its slice cheap).  mdi-audit refuses a
    # share that leaves the TARGET pool below one slot's
    # chunk-reservation headroom (bad-serving-config).
    draft_share: float = 0.25
    # sampling (engine-wide: the decode step is one jitted batch) ------------
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # attention backend: None → auto (Pallas kernel on TPU decode steps,
    # exact lax gather fallback elsewhere — tier-1 CPU tests use the latter)
    use_kernel: Optional[bool] = None
    # paged-pool storage dtype.  None → follow the engine's cache dtype
    # (the fp path, byte- and bit-identical to before this knob existed).
    # "int8" stores blocks as int8 with per-block-per-KV-group f32 scales
    # (quantize-on-scatter, dequantize inside the kernels' block loop —
    # ops/paged_attention.py), roughly doubling the blocks a fixed HBM
    # budget holds; other float names cast on write like the dense cache's
    # --kv-dtype.  Unknown names are refused via `dtype_bytes`.
    kv_dtype: Optional[str] = None
    # open-system front-end (server/frontend.py): bound on requests the
    # server has ACCEPTED but not yet seated in a decode slot (the
    # submission channel plus the scheduler's waiting queue).  Arrivals
    # past the bound are rejected with backpressure (HTTP 429) instead of
    # growing an unbounded queue whose tail latency no SLO survives.
    # None → the replay engine's behavior (no bound; mdi-serve queues the
    # whole trace) and the server default of 4 × max_batch.
    admission_queue: Optional[int] = None
    # host-RAM KV tier (serving/host_tier.py, docs/perf.md "Tiered KV"):
    # a pinned host-side block store sized in MiB.  0 = no tier — today's
    # recompute-on-preemption behavior, bit-for-bit.  When > 0, preempted
    # victims SWAP their (possibly int8) blocks to host instead of
    # recomputing (cost model permitting) and resume with zero re-prefill,
    # and cold prefix-cache chains spill to host instead of being dropped.
    host_pool_mib: int = 0
    # estimated host↔device link bandwidth in GB/s for the swap-vs-
    # recompute cost model.  None → the per-device-generation table
    # (host_tier.HOST_LINK_GBPS) keyed on device_kind; 0 disables swapping
    # entirely (and mdi-audit flags the dead tier: bad-host-tier).
    host_link_gbps: Optional[float] = None
    # blocks per jitted transfer quantum: swap-out gathers and restore
    # scatters run in fixed-width batches of this many blocks (padded with
    # the trash block), so the tier adds exactly TWO executables per
    # engine regardless of sequence length — zero post-warmup recompiles.
    swap_chunk_blocks: int = 8
    # spill evicted prefix-cache chains to the host tier (needs
    # prefix_caching; hits on spilled chains restore blocks and count as
    # prefix_hits_host).  False = the tier serves preemption swaps only.
    host_prefix_spill: bool = True

    def resolved_admission_queue(self) -> int:
        """The open-system admission-queue bound: `admission_queue` when
        set, else 4 × max_batch — deep enough to keep every slot fed
        through retirement churn, shallow enough that queue-wait cannot
        silently dominate TTFT.  Shared by `server.ServingFrontend` and
        the mdi-audit `bad-server-config` checker."""
        if self.admission_queue is not None:
            return int(self.admission_queue)
        return 4 * self.max_batch

    def resolved_token_budget(self) -> int:
        """The unified serving step's per-dispatch token-axis width: every
        decode lane's pending token plus the prefill tokens that fit.
        `token_budget` when set, else max_batch + prefill_chunk — so the
        default always serves a full decode batch alongside one full
        prefill chunk.  Shared by the engine (the `_mixed_fn` compile
        shape) and the mdi-audit `bad-token-budget` checker."""
        if self.token_budget is not None:
            return int(self.token_budget)
        return self.max_batch + max(1, self.prefill_chunk)

    def reserve_headroom_blocks(self) -> int:
        """Worst-case blocks one live slot holds AHEAD of its written tokens
        under K-step chunk reservation (`decode_chunk`, doubled while a
        speculative second chunk is in flight under `double_buffer`) or
        speculative verify (`spec_k` + 1 writes), plus one block of
        partial-block slack.  The default full-coverage pool already bounds
        every slot at the window, so this only matters for hand-sized
        `max_blocks` pools — the mdi-audit serving checker uses it to refuse
        pools too small to hold even one slot's reservation."""
        ahead = max(1, self.decode_chunk, self.spec_k + 1)
        if self.double_buffer and self.spec_k == 0:
            ahead += max(1, self.decode_chunk)
        return -(-ahead // self.block_size) + 1

    def spec_verify_sampled(self) -> bool:
        """True iff the speculative verify uses the rejection-sampling
        rule (accept w.p. min(1, p_verify/p_draft), else resample the
        residual) instead of exact greedy match.  Auto (`spec_sampled` is
        None): sampled iff temperature > 0 — so greedy serving keeps the
        bit-identical exact-match path and sampling serving preserves the
        per-step distribution.  `spec_sampled=False` pins exact-match
        (the engine refuses temperature>0 with spec_k on that pin);
        `spec_sampled=True` forces the sampled rule everywhere."""
        if self.spec_sampled is not None:
            return bool(self.spec_sampled)
        return self.temperature != 0.0

    def num_draft_blocks(self, max_seq_length: int) -> int:
        """Draft-pool size in blocks (0 when no `draft_model`): the draft
        model's slice of the shared paged-pool budget.  Bounded pools
        (`max_blocks` set) partition the block range — the draft pool
        takes `draft_share` of `max_blocks` (at least 2: trash + one
        usable block) and `num_pool_blocks` hands the target the rest.
        Unbounded pools give the draft full coverage, same formula as the
        target's (the draft model's smaller per-block bytes keep that
        cheap)."""
        if not self.draft_model:
            return 0
        if self.max_blocks is not None:
            return max(2, int(int(self.max_blocks) * self.draft_share))
        per_seq = -(-int(max_seq_length) // self.block_size)
        return 1 + self.max_batch * per_seq

    def num_pool_blocks(self, max_seq_length: int) -> int:
        """TARGET pool size in blocks: `max_blocks` when set (minus the
        draft pool's `num_draft_blocks` slice when a draft model shares
        the bounded budget), else full coverage (1 trash block +
        max_batch × ceil(max_seq_length / block_size)) — the same default
        `serving.engine.ServingEngine` computes."""
        if self.max_blocks is not None:
            return int(self.max_blocks) - self.num_draft_blocks(max_seq_length)
        per_seq = -(-int(max_seq_length) // self.block_size)
        return 1 + self.max_batch * per_seq

    def draft_config(self) -> Optional["Config"]:
        """The draft model's `Config` (registry lookup on `draft_model`),
        or None — shared by the engine, mdi-audit's byte accounting and
        `trace_serving`'s abstract construction so all three price the
        same architecture."""
        if not self.draft_model:
            return None
        return Config.from_name(self.draft_model)

    def draft_pool_bytes(
        self,
        cfg: "Config",
        tp: int = 1,
        max_seq_length: Optional[int] = None,
        dtype="bfloat16",
    ) -> int:
        """Per-device HBM bytes of the DRAFT paged pool for draft model
        `cfg` (pass `draft_config()`): `num_draft_blocks` × the draft
        architecture's itemized `block_bytes` — byte-exact against the
        live engine's second pool, the contract `pool_bytes` keeps for
        the target.  0 when no draft model."""
        if not self.draft_model:
            return 0
        max_seq = int(min(max_seq_length or cfg.block_size, cfg.block_size))
        n_blocks = self.num_draft_blocks(max_seq)
        return n_blocks * self.block_bytes(cfg, dtype, tp=tp)["total_bytes"]

    def resolved_kv_dtype(self, default="bfloat16") -> str:
        """The pool's storage dtype NAME: `kv_dtype` when set, else the
        caller's `default` (the engine passes its cache dtype; audit passes
        the plan's).  Normalized to a string so byte accounting and the
        int8 branch key on one spelling."""
        dt = self.kv_dtype if self.kv_dtype is not None else default
        if isinstance(dt, str):
            return dt
        name = getattr(dt, "__name__", None) or getattr(dt, "name", None)
        return name or str(dt)

    def block_bytes(
        self, cfg: "Config", dtype="bfloat16", tp: int = 1
    ) -> Dict[str, Any]:
        """Itemized HBM bytes of ONE pool block, k + v across all layers —
        THE per-block cost model shared by `pool_bytes`, the mdi-audit
        breakdown and the `--hbm-gb` blocks-that-fit computation, so the
        three can never disagree (the pre-refactor `pool_bytes` pushed a
        bare dtype through `estimate_kv_bytes` with no room for the int8
        scale side arrays).

        Returns {"kv_dtype", "kv_bytes", "scale_bytes", "total_bytes"};
        int8 pools add the per-block-per-KV-group f32 scales
        (`ops/paged_attention.py` layout), every other dtype has
        scale_bytes 0.  `tp > 1` gives the PER-DEVICE slice (the KV-group
        axis shards when divisible — `paged_kv_spec` — scales included).
        Unknown dtype names raise via `dtype_bytes` (the refusal contract
        for `kv_dtype` values the byte table doesn't know)."""
        name = self.resolved_kv_dtype(dtype)
        item = dtype_bytes(name)  # raises on unknown names
        G = cfg.n_query_groups
        if tp > 1 and G % tp == 0:
            G //= int(tp)
        kv = 2 * cfg.n_layer * self.block_size * G * cfg.head_size * item
        scale = 2 * cfg.n_layer * G * 4 if name == "int8" else 0
        return {
            "kv_dtype": name,
            "kv_bytes": int(kv),
            "scale_bytes": int(scale),
            "total_bytes": int(kv + scale),
        }

    def pool_bytes(
        self, cfg: "Config", max_seq_length: Optional[int] = None, dtype="bfloat16"
    ) -> int:
        """HBM bytes of the paged KV pool for model `cfg`: num_pool_blocks ×
        the itemized `block_bytes` (k + v payload at the pool dtype, plus
        the int8 scale arrays) — byte-exact against
        `transformer.init_paged_kv_cache`'s live arrays at either dtype.
        `self.kv_dtype` wins over the `dtype` argument when set.
        Used by the mdi-audit memory checker and the bench/serve logs."""
        max_seq = int(min(max_seq_length or cfg.block_size, cfg.block_size))
        n_blocks = self.num_pool_blocks(max_seq)
        return n_blocks * self.block_bytes(cfg, dtype)["total_bytes"]

    def pool_bytes_per_device(
        self,
        cfg: "Config",
        tp: int = 1,
        max_seq_length: Optional[int] = None,
        dtype="bfloat16",
    ) -> int:
        """Per-device HBM bytes of the pool under a tp serving mesh: the
        KV-group axis shards over tp (`parallel.sharding.paged_kv_spec`,
        int8 scale arrays included), so each chip holds exactly 1/tp of
        every block's bytes.  Byte-exact against the live sharded engine
        because G % tp == 0 is a serving precondition
        (`validate_tp_divisibility`; mdi-audit errors with
        `bad-serving-mesh` otherwise and this falls back to the whole pool,
        mirroring the runtime's drop-indivisible-sharding rule)."""
        max_seq = int(min(max_seq_length or cfg.block_size, cfg.block_size))
        n_blocks = self.num_pool_blocks(max_seq)
        return n_blocks * self.block_bytes(cfg, dtype, tp=tp)["total_bytes"]

    def num_host_blocks(self, cfg: "Config", dtype="bfloat16") -> int:
        """Blocks the host tier holds: the `host_pool_mib` budget divided
        by the FULL (unsharded, tp=1) `block_bytes` — the host store keeps
        whole blocks even when the HBM pool shards over tp, so a block
        restored on a differently-sized mesh is still complete.  0 when
        the tier is off."""
        if self.host_pool_mib <= 0:
            return 0
        per_block = self.block_bytes(cfg, dtype, tp=1)["total_bytes"]
        if per_block <= 0:
            return 0
        return int(self.host_pool_mib * 2**20) // per_block

    def host_pool_bytes(self, cfg: "Config", dtype="bfloat16") -> int:
        """Host-RAM bytes the tier's block store actually allocates:
        whole blocks only (the MiB budget rounds DOWN to block granularity)
        — byte-exact against the live `host_tier.HostBlockStore` slabs,
        the same contract `pool_bytes` keeps with the HBM pool.  The
        mdi-audit `kv_pool` breakdown and `--host-gb` check read this."""
        n = self.num_host_blocks(cfg, dtype)
        return n * self.block_bytes(cfg, dtype, tp=1)["total_bytes"]

    def resolved_host_link_gbps(self, device_kind: Optional[str] = None) -> float:
        """Host<->device link bandwidth (GB/s) the swap cost model uses:
        `host_link_gbps` when set, else the table in
        `serving.host_tier.HOST_LINK_GBPS` keyed on `device_kind` (the CUDA
        device name; its conservative default covers the CPU and unknown
        cards).  0 means swapping can never win."""
        if self.host_link_gbps is not None:
            return float(self.host_link_gbps)
        from mdi_llm_tpu_torch.serving.host_tier import lookup_host_link_gbps

        return lookup_host_link_gbps(device_kind)


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, float):
        s = repr(v)
        # YAML 1.1 floats need a dot in the mantissa ("1e-05" parses as str)
        if "e" in s and "." not in s.split("e")[0]:
            s = s.replace("e", ".0e")
        return s
    return str(v)


def _parse_simple_yaml(text: str) -> Dict[str, Any]:
    """Minimal YAML subset parser for flat `model_config.yaml` files (scalars
    plus one level of nested dict, which is all `Config.save` and litGPT
    emit).  The port never needs pyyaml: the GPU machine may not have it."""
    out: Dict[str, Any] = {}
    current: Optional[str] = None
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indented = raw.startswith(("  ", "\t"))
        line = raw.strip()
        if ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip()
        if indented and current is not None:
            out[current][key] = _yaml_value(val)
        elif val == "":
            current = key
            out[key] = {}
        else:
            current = None
            out[key] = _yaml_value(val)
    return out


def _yaml_value(v: str) -> Any:
    if v in ("null", "~", "None"):
        return None
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        return json.loads(v)  # `_yaml_scalar` writes strings as JSON
    if len(v) >= 2 and v[0] == "'" and v[-1] == "'":
        return v[1:-1].replace("''", "'")
    return v


# ===========================================================================
# Named-model registry.
#
# Capability parity with the reference registry (`src/sub/config.py:175-1669`,
# ~85 entries across ~20 families).  Entries are dicts (converted lazily by
# Config.from_name).  Specs come from the public model cards / litGPT.
# ===========================================================================

configs: List[Dict[str, Any]] = []


def _add(entry: Dict[str, Any], variants: Optional[List[str]] = None) -> None:
    if variants is None:
        configs.append(entry)
        return
    for v in variants:
        e = copy.deepcopy(entry)
        e["name"] = entry["name"].format(v)
        if "hf_config" in e:
            e["hf_config"] = dict(
                org=entry["hf_config"]["org"],
                name=entry["hf_config"]["name"].format(v),
            )
        configs.append(e)
    # keep the template too, so from_name can match novel suffixes
    t = copy.deepcopy(entry)
    t["_template"] = True
    configs.append(t)


_llama = dict(
    rotary_percentage=1.0,
    parallel_residual=False,
    bias=False,
    norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP",
)

# ---- custom / scratch-trainable (reference NanoLlama, README.md:325-330) --
_add(
    dict(
        name="NanoLlama",
        hf_config=dict(org="custom", name="NanoLlama"),
        block_size=2048,
        vocab_size=32000,
        padding_multiple=64,
        n_layer=12,
        n_head=16,
        n_embd=1024,
        n_query_groups=16,
        norm_eps=1e-5,
        intermediate_size=5632,
        **_llama,
    )
)

# ---- TinyLlama (reference config.py:1606-1645) ----------------------------
_add(
    dict(
        name="tiny-llama-1.1b{}",
        hf_config=dict(org="TinyLlama", name="TinyLlama-1.1B{}"),
        block_size=2048,
        vocab_size=32000,
        padding_multiple=64,
        n_layer=22,
        n_head=32,
        n_embd=2048,
        n_query_groups=4,
        norm_eps=1e-5,
        intermediate_size=5632,
        **_llama,
    ),
    variants=["", "-intermediate-step-1431k-3T", "-chat", "-Chat-v1.0"],
)

# ---- Llama 2 (reference config.py:820-878) --------------------------------
for size, (L, D, H, G, I) in {
    "7b": (32, 4096, 32, 32, 11008),
    "13b": (40, 5120, 40, 40, 13824),
    "70b": (80, 8192, 64, 8, 28672),
}.items():
    _add(
        dict(
            name=f"Llama-2-{size}{{}}-hf",
            hf_config=dict(org="meta-llama", name=f"Llama-2-{size}{{}}-hf"),
            block_size=4096,
            vocab_size=32000,
            padding_multiple=64,
            n_layer=L,
            n_head=H,
            n_embd=D,
            n_query_groups=G,
            norm_eps=1e-5,
            intermediate_size=I,
            **_llama,
        ),
        variants=["", "-chat"],
    )

# ---- Llama 3 (reference config.py:880-924) --------------------------------
for size, (L, D, H, G, I) in {
    "8B": (32, 4096, 32, 8, 14336),
    "70B": (80, 8192, 64, 8, 28672),
}.items():
    _add(
        dict(
            name=f"Llama-3-{size}{{}}",
            hf_config=dict(org="meta-llama", name=f"Meta-Llama-3-{size}{{}}"),
            block_size=8192,
            vocab_size=128000,
            padded_vocab_size=128256,
            n_layer=L,
            n_head=H,
            n_embd=D,
            n_query_groups=G,
            norm_eps=1e-5,
            intermediate_size=I,
            rope_base=500000,
            **_llama,
        ),
        variants=["", "-Instruct"],
    )

# ---- CodeLlama (reference config.py:1060-1294) ----------------------------
for size, (L, D, H, G, I) in {
    "7b": (32, 4096, 32, 32, 11008),
    "13b": (40, 5120, 40, 40, 13824),
    "34b": (48, 8192, 64, 8, 22016),
    "70b": (80, 8192, 64, 8, 28672),
}.items():
    for flavor in ("", "-Python", "-Instruct"):
        _add(
            dict(
                name=f"CodeLlama-{size}{flavor}-hf",
                hf_config=dict(org="codellama", name=f"CodeLlama-{size}{flavor}-hf"),
                block_size=16384,
                vocab_size=32016,
                padding_multiple=16,
                n_layer=L,
                n_head=H,
                n_embd=D,
                n_query_groups=G,
                norm_eps=1e-5,
                intermediate_size=I,
                rope_base=1000000,
                **_llama,
            )
        )

# ---- Mistral / Mixtral (reference config.py:1487-1604) --------------------
_add(
    dict(
        name="Mistral-7B-{}v0.1",
        hf_config=dict(org="mistralai", name="Mistral-7B-{}v0.1"),
        block_size=4096,  # 32k with sliding window; litGPT caps at 4096
        vocab_size=32000,
        padding_multiple=512,
        n_layer=32,
        n_head=32,
        n_embd=4096,
        n_query_groups=8,
        norm_eps=1e-5,
        intermediate_size=14336,
        **_llama,
    ),
    variants=["", "Instruct-"],
)
_add(
    dict(
        name="Mixtral-8x7B-{}v0.1",
        hf_config=dict(org="mistralai", name="Mixtral-8x7B-{}v0.1"),
        block_size=32768,
        vocab_size=32000,
        padding_multiple=512,
        n_layer=32,
        n_head=32,
        n_embd=4096,
        n_query_groups=8,
        norm_eps=1e-5,
        intermediate_size=14336,
        rope_base=1000000,
        n_expert=8,
        n_expert_per_token=2,
        rotary_percentage=1.0,
        parallel_residual=False,
        bias=False,
        norm_class_name="RMSNorm",
        mlp_class_name="LLaMAMoE",
    ),
    variants=["", "Instruct-"],
)
for ver, vocab in (("v0.2", 32000), ("v0.3", 32768)):
    _add(
        dict(
            name=f"Mistral-7B-{{}}{ver}",
            hf_config=dict(org="mistralai", name=f"Mistral-7B-{{}}{ver}"),
            block_size=32768,
            vocab_size=vocab,
            padding_multiple=512,
            n_layer=32,
            n_head=32,
            n_embd=4096,
            n_query_groups=8,
            norm_eps=1e-5,
            intermediate_size=14336,
            rope_base=1000000,
            **_llama,
        ),
        variants=["", "Instruct-"],
    )

# ---- Pythia (reference config.py:283-397) ---------------------------------
for size, (L, D, H) in {
    "14m": (6, 128, 4),
    "31m": (6, 256, 8),
    "70m": (6, 512, 8),
    "160m": (12, 768, 12),
    "410m": (24, 1024, 16),
    "1b": (16, 2048, 8),
    "1.4b": (24, 2048, 16),
    "2.8b": (32, 2560, 32),
    "6.9b": (32, 4096, 32),
    "12b": (36, 5120, 40),
}.items():
    _add(
        dict(
            name=f"pythia-{size}{{}}",
            hf_config=dict(org="EleutherAI", name=f"pythia-{size}{{}}"),
            # 14m/31m were trained at shorter context (HF config.json)
            block_size={"14m": 512, "31m": 1024}.get(size, 2048),
            vocab_size=50254,
            padding_multiple=128,
            n_layer=L,
            n_head=H,
            n_embd=D,
            rotary_percentage=0.25,
            parallel_residual=True,
            bias=True,
            norm_class_name="LayerNorm",
            mlp_class_name="GptNeoxMLP",
        ),
        variants=["", "-deduped"],
    )

# ---- Dolly v2 (pythia-based, reference config.py:399-428) -----------------
for size, (L, D, H) in {"3b": (32, 2560, 32), "7b": (32, 4096, 32), "12b": (36, 5120, 40)}.items():
    _add(
        dict(
            name=f"dolly-v2-{size}",
            hf_config=dict(org="databricks", name=f"dolly-v2-{size}"),
            block_size=2048,
            vocab_size=50254,
            padded_vocab_size=50280,
            n_layer=L,
            n_head=H,
            n_embd=D,
            rotary_percentage=0.25,
            parallel_residual=True,
            bias=True,
            norm_class_name="LayerNorm",
            mlp_class_name="GptNeoxMLP",
        )
    )

# ---- RedPajama-INCITE (gpt-neox arch, reference config.py:430-470) --------
for nm, (L, D, H) in {
    "RedPajama-INCITE-{}-3B-v1": (32, 2560, 32),
    "RedPajama-INCITE-7B-{}": (32, 4096, 32),
    # early v0.1 naming of the 7B release (reference config.py:454-463)
    "RedPajama-INCITE-{}-7B-v0.1": (32, 4096, 32),
}.items():
    _add(
        dict(
            name=nm,
            hf_config=dict(org="togethercomputer", name=nm),
            block_size=2048,
            vocab_size=50254,
            padding_multiple=256,
            n_layer=L,
            n_head=H,
            n_embd=D,
            rotary_percentage=1.0,
            parallel_residual=False,
            bias=True,
            norm_class_name="LayerNorm",
            mlp_class_name="GptNeoxMLP",
        ),
        variants=["Base", "Chat", "Instruct"],
    )

# ---- Falcon (reference config.py:472-538) ---------------------------------
_add(
    dict(
        name="falcon-7b{}",
        hf_config=dict(org="tiiuae", name="falcon-7b{}"),
        block_size=2048,
        vocab_size=65024,
        padded_vocab_size=65024,
        n_layer=32,
        n_head=71,
        n_embd=4544,
        n_query_groups=1,
        rotary_percentage=1.0,
        parallel_residual=True,
        bias=False,
        shared_attention_norm=True,
        norm_class_name="LayerNorm",
        mlp_class_name="GptNeoxMLP",
    ),
    variants=["", "-instruct"],
)
_add(
    dict(
        name="falcon-40b{}",
        hf_config=dict(org="tiiuae", name="falcon-40b{}"),
        block_size=2048,
        vocab_size=65024,
        padded_vocab_size=65024,
        n_layer=60,
        n_head=128,
        n_embd=8192,
        n_query_groups=8,
        rotary_percentage=1.0,
        parallel_residual=True,
        bias=False,
        norm_class_name="LayerNorm",
        mlp_class_name="GptNeoxMLP",
    ),
    variants=["", "-instruct"],
)
_add(
    dict(
        name="falcon-180B{}",
        hf_config=dict(org="tiiuae", name="falcon-180B{}"),
        block_size=2048,
        vocab_size=65024,
        padded_vocab_size=65024,
        n_layer=80,
        n_head=232,
        n_embd=14848,
        n_query_groups=8,
        rotary_percentage=1.0,
        parallel_residual=True,
        bias=False,
        norm_class_name="LayerNorm",
        mlp_class_name="GptNeoxMLP",
    ),
    variants=["", "-chat"],
)

# ---- StableLM (reference config.py:180-280) -------------------------------
for nm, (L, D, H, bs) in {
    "stablelm-base-alpha-3b": (16, 4096, 32, 4096),
    "stablelm-base-alpha-7b": (16, 6144, 48, 4096),
    "stablelm-tuned-alpha-3b": (16, 4096, 32, 4096),
    "stablelm-tuned-alpha-7b": (16, 6144, 48, 4096),
}.items():
    _add(
        dict(
            name=nm,
            hf_config=dict(org="stabilityai", name=nm),
            block_size=bs,
            vocab_size=50254,
            padded_vocab_size=50432,
            n_layer=L,
            n_head=H,
            n_embd=D,
            rotary_percentage=0.25,
            parallel_residual=True,
            bias=True,
            norm_class_name="LayerNorm",
            mlp_class_name="GptNeoxMLP",
        )
    )
for nm in ("stablelm-3b-4e1t", "stablelm-zephyr-3b"):
    _add(
        dict(
            name=nm,
            hf_config=dict(org="stabilityai", name=nm),
            block_size=4096,
            vocab_size=50254,
            padding_multiple=512,
            n_layer=32,
            n_head=32,
            n_embd=2560,
            parallel_residual=False,
            bias=False,
            rotary_percentage=0.25,
            norm_class_name="LayerNorm",
            mlp_class_name="LLaMAMLP",
            intermediate_size=6912,
        )
    )

# ---- StableCode (gpt-neox arch; reference config.py:240-280) --------------
for nm, bs in {
    "stablecode-completion-alpha-3b": 16384,
    "stablecode-completion-alpha-3b-4k": 4096,
    "stablecode-instruct-alpha-3b": 4096,
}.items():
    _add(
        dict(
            name=nm,
            hf_config=dict(org="stabilityai", name=nm),
            block_size=bs,
            vocab_size=49152,
            n_layer=32,
            n_head=32,
            n_embd=2560,
            rotary_percentage=0.25,
            parallel_residual=True,
            bias=True,
            norm_class_name="LayerNorm",
            mlp_class_name="GptNeoxMLP",
        )
    )
_add(
    dict(
        name="stable-code-3b",
        hf_config=dict(org="stabilityai", name="stable-code-3b"),
        block_size=16384,
        vocab_size=50254,
        padded_vocab_size=50304,
        n_layer=32,
        n_head=32,
        n_embd=2560,
        rotary_percentage=0.25,
        parallel_residual=False,
        bias=False,
        norm_class_name="LayerNorm",
        mlp_class_name="LLaMAMLP",
        intermediate_size=6912,
    )
)

# ---- OpenLLaMA / Vicuna / LongChat / Nous-Hermes / Platypus ---------------
for nm, (org, (L, D, H, I, bs)) in {
    "open_llama_3b": ("openlm-research", (26, 3200, 32, 8640, 2048)),
    "open_llama_7b": ("openlm-research", (32, 4096, 32, 11008, 2048)),
    "open_llama_13b": ("openlm-research", (40, 5120, 40, 13824, 2048)),
    "vicuna-7b-v1.3": ("lmsys", (32, 4096, 32, 11008, 2048)),
    "vicuna-13b-v1.3": ("lmsys", (40, 5120, 40, 13824, 2048)),
    "vicuna-33b-v1.3": ("lmsys", (60, 6656, 52, 17920, 2048)),
    "vicuna-7b-v1.5": ("lmsys", (32, 4096, 32, 11008, 4096)),
    "vicuna-7b-v1.5-16k": ("lmsys", (32, 4096, 32, 11008, 16384)),
    "vicuna-13b-v1.5": ("lmsys", (40, 5120, 40, 13824, 4096)),
    "vicuna-13b-v1.5-16k": ("lmsys", (40, 5120, 40, 13824, 16384)),
    "longchat-7b-16k": ("lmsys", (32, 4096, 32, 11008, 16384)),
    "longchat-13b-16k": ("lmsys", (40, 5120, 40, 13824, 16384)),
    "Nous-Hermes-llama-2-7b": ("NousResearch", (32, 4096, 32, 11008, 4096)),
    "Nous-Hermes-13b": ("NousResearch", (40, 5120, 40, 13824, 2048)),
    "Nous-Hermes-Llama2-13b": ("NousResearch", (40, 5120, 40, 13824, 4096)),
    "Platypus-30B": ("garage-bAInd", (60, 6656, 52, 17920, 2048)),
    "Platypus2-7B": ("garage-bAInd", (32, 4096, 32, 11008, 4096)),
    "Platypus2-13B": ("garage-bAInd", (40, 5120, 40, 13824, 4096)),
    "Platypus2-70B": ("garage-bAInd", (80, 8192, 64, 28672, 4096)),
    "Platypus2-70B-instruct": ("garage-bAInd", (80, 8192, 64, 28672, 4096)),
    "Camel-Platypus2-13B": ("garage-bAInd", (40, 5120, 40, 13824, 4096)),
    "Camel-Platypus2-70B": ("garage-bAInd", (80, 8192, 64, 28672, 4096)),
    "Stable-Platypus2-13B": ("garage-bAInd", (40, 5120, 40, 13824, 4096)),
    "FreeWilly2": ("stabilityai", (80, 8192, 64, 28672, 4096)),
    "LLaMA-2-7B-32K": ("togethercomputer", (32, 4096, 32, 11008, 32768)),
}.items():
    groups = 8 if (L, D) in ((80, 8192),) else H
    _add(
        dict(
            name=nm,
            hf_config=dict(org=org, name=nm),
            block_size=bs,
            vocab_size=32000,
            padding_multiple=64,
            n_layer=L,
            n_head=H,
            n_embd=D,
            n_query_groups=groups,
            # longchat also uses 1e-6 (reference config.py:736,758)
            norm_eps=1e-6 if ("open_llama" in nm or "longchat" in nm) else 1e-5,
            intermediate_size=I,
            # long-context variants extend their base context via positional
            # interpolation: longchat 2k->16k and LLaMA-2-7B-32K 4k->32k
            # condense by 8, vicuna-v1.5-16k 4k->16k by 4 (reference
            # config.py:666,700,735,757,1445)
            **(
                dict(rope_condense_ratio=8)
                if nm == "LLaMA-2-7B-32K" or "longchat" in nm
                else dict(rope_condense_ratio=4)
                if nm.endswith("-16k")
                else {}
            ),
            **_llama,
        )
    )

# ---- Phi (reference config.py:1451-1485) ----------------------------------
_add(
    dict(
        name="phi-1_5",
        hf_config=dict(org="microsoft", name="phi-1_5"),
        block_size=2048,
        vocab_size=50257,
        padded_vocab_size=51200,
        n_layer=24,
        n_head=32,
        n_embd=2048,
        rotary_percentage=0.5,
        shared_attention_norm=True,
        parallel_residual=True,
        bias=True,
        lm_head_bias=True,
        norm_class_name="LayerNorm",
        mlp_class_name="GptNeoxMLP",
        gelu_approximate="tanh",
    )
)
_add(
    dict(
        name="phi-2",
        hf_config=dict(org="microsoft", name="phi-2"),
        block_size=2048,
        vocab_size=50257,
        padded_vocab_size=51200,
        n_layer=32,
        n_head=32,
        n_embd=2560,
        rotary_percentage=0.4,
        shared_attention_norm=True,
        parallel_residual=True,
        bias=True,
        lm_head_bias=True,
        norm_class_name="LayerNorm",
        mlp_class_name="GptNeoxMLP",
        gelu_approximate="tanh",
    )
)

# ---- Gemma / CodeGemma (reference config.py:930-1007) ---------------------
for nm, (L, D, H, G, hs, I) in {
    "Gemma-2b": (18, 2048, 8, 1, 256, 16384),
    "Gemma-2b-it": (18, 2048, 8, 1, 256, 16384),
    "Gemma-7b": (28, 3072, 16, 16, 256, 24576),
    "Gemma-7b-it": (28, 3072, 16, 16, 256, 24576),
    "CodeGemma-7b-it": (28, 3072, 16, 16, 256, 24576),
}.items():
    _add(
        dict(
            name=nm,
            hf_config=dict(org="google", name=nm.lower()),
            block_size=8192,
            vocab_size=256000,
            padded_vocab_size=256000,
            n_layer=L,
            n_head=H,
            n_embd=D,
            n_query_groups=G,
            head_size=hs,
            rotary_percentage=1.0,
            parallel_residual=False,
            bias=False,
            norm_class_name="RMSNorm",
            norm_eps=1e-6,
            mlp_class_name="GemmaMLP",
            gelu_approximate="tanh",
            intermediate_size=I,
            scale_embeddings=True,
            tie_embeddings=True,
            rmsnorm_add_unit_offset=True,
        )
    )

# ---- Danube2 (reference config.py:1009-1034) ------------------------------
_add(
    dict(
        name="Danube2-1.8b-chat",
        hf_config=dict(org="h2oai", name="h2o-danube2-1.8b-chat"),
        block_size=4096,
        vocab_size=32000,
        padding_multiple=64,
        n_layer=24,
        n_head=32,
        n_embd=2560,
        n_query_groups=8,
        norm_eps=1e-5,
        intermediate_size=6912,
        rope_base=10000,
        **_llama,
    )
)

# ---- Function-calling Llama 2 (reference config.py:1643-1662) -------------
_add(
    dict(
        name="Llama-2-7b-chat-hf-function-calling-v2",
        hf_config=dict(org="Trelis", name="Llama-2-7b-chat-hf-function-calling-v2"),
        block_size=4096,
        vocab_size=32000,
        padding_multiple=64,
        n_layer=32,
        n_head=32,
        n_embd=4096,
        norm_eps=1e-5,
        intermediate_size=11008,
        **_llama,
    )
)

# ---- GPT-2 family (legacy generation parity, old/GPT2/sub/model.py) -------
for nm, (L, D, H) in {
    "gpt2": (12, 768, 12),
    "gpt2-medium": (24, 1024, 16),
    "gpt2-large": (36, 1280, 20),
    "gpt2-xl": (48, 1600, 25),
}.items():
    _add(
        dict(
            name=nm,
            hf_config=dict(org="openai-community", name=nm),
            block_size=1024,
            vocab_size=50257,
            padding_multiple=64,
            n_layer=L,
            n_head=H,
            n_embd=D,
            rotary_percentage=0.0,
            pos_embedding="learned",
            parallel_residual=False,
            bias=True,
            norm_class_name="LayerNorm",
            mlp_class_name="GptNeoxMLP",
            gelu_approximate="tanh",  # HF gpt2 uses gelu_new
            tie_embeddings=True,
        )
    )

name_to_config: Dict[str, Dict[str, Any]] = {
    d["name"]: d for d in configs if "_template" not in d
}
