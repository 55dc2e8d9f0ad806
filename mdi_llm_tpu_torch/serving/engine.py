"""Continuous-batching serving engine over the paged KV pool.

Port of `mdi_llm_tpu/serving/engine.py` for one device.  One pooled block
cache (`transformer.init_paged_kv_cache`) is shared by every request in
flight; the scheduler (`serving/scheduler.py`, a copy of the JAX
package's) admits requests into `max_batch` slots, and every engine step
is one of:

- the unified mixed step (`_run_mixed`): whenever prefill work exists,
  every decode lane's pending token plus prefill chunks up to the token
  budget pack slot-major into ONE (1, token_budget) ragged forward
  (`ops/paged_attention.paged_prefill`, kernel K1 on the card);
- speculative decode (`_run_spec_decode`, with `spec_k`): each slot drafts
  up to `spec_k` tokens (prompt n-gram lookup, or the draft model where it
  misses) and ONE ragged verify forward of width `spec_k + 1` per slot
  scores them; exact-match accept at temperature 0, the rejection-sampled
  accept/resample of `ops/sampling.speculative_verify` above it.  A turn
  where no slot drafts falls back to the decode below;
- chunked decode (`_run_decode_chunk`): K decode steps run back to back on
  the device with per-slot limit and stop masks, and the host reads the K
  tokens once.  With `double_buffer`, chunk N+1 is launched before chunk
  N's tokens are read: the read is a non-blocking copy into pinned memory
  plus a CUDA event, so it overlaps chunk N+1's compute;
- per-token decode (`_run_decode`) when `decode_chunk == 1`.

The mixed step, the decode chunk and the per-token decode are each one
`StepGraph` (`utils/step_graph.py`), the counterpart of the JAX engine's
jitted executables per shape (`_mixed_fn(B, T)`, `_decode_chunk_fn(B, K)`,
`_decode_fn(B)`): static input buffers at (max_batch, token_budget) or
(max_batch, decode_chunk), filled per step, and on the card a CUDA graph
captured over them when the engine is built, with inert operands (all-zero
tables: every write lands in the trash block), and replayed at every step
— kernel K1 included.  The CPU runs the same bodies on the same buffers.
The speculative verify, the draft scan and the draft mirror of the mixed
step stay eager.  The pool is updated in place by every forward (the JAX
package donates it to each jitted step for the same effect).  Its storage
is the Generator's cache dtype, or `ServingConfig.kv_dtype`: a float name
(float8 included) casts on write, "int8" builds the quantized pool of
per-(block, group) scales.  A draft model (`draft_model`, or `Generator.serve(draft_gen=)`)
keeps its own paged pool of the same dtype and follows the target's feed
positions through the mixed steps.  Greedy streams equal the JAX engine's
token for token on the same weights (tests/test_torch_serving.py,
tests/test_torch_spec_serving.py).  Sampling draws come from one
`torch.Generator` per engine, seeded from the Generator's `rng_seed`.

Observability (`obs/`): pass `obs=ServingObserver()` and the engine
feeds it at the host-sync boundaries it already owns, as the JAX engine
does: `obs.step` once per step after the step's host read (mixed,
decode, decode_chunk, draft_scan, verify with `spec_k` and `accepted`),
`obs.prefill_chunk`, `obs.tokens` in `_emit`, `obs.spec` per verified
lane; the scheduler reports the lifecycle edges.  Every hook is Python
outside the captured step bodies (a hook inside a body would run once at
capture and never at replay), adds no host sync, no device op and no
capture.  Under double buffering chunk N's tokens are stamped at chunk
N's own host read.  `ServingObserver(device=True)` measures each step
once when the engine is built (`obs/device.py`), reports cached on the
Generator per (step, shape, pool dtype); the eager verify is measured at
its first call.  `run(step_hook=)` fires after every engine step (the
bounded profiler window and the open-system server hang off it).

The host-RAM KV tier (`ServingConfig.host_pool_mib > 0`,
`serving/host_tier.py`): a preemption victim's blocks are gathered on the
device and copied to host slots instead of being recomputed, and prefix
chains evicted from the pool spill there.  Both are eager, fixed-width
(`swap_chunk_blocks`) torch ops queued on the stream the steps replay on,
outside every step graph: a gather is queued before any later step can
write the freed blocks, its rows are copied into the pinned host slabs
behind the next steps and waited for at the next host-sync boundary
(`_drain_swaps`, after the step's own read: no host sync is added); a
restore copies slab rows into a device buffer and writes it into the
pool's own tensors in place (`index_copy_`), which every captured graph
reads.  Padding reads block 0 and padding writes go to the trash block,
as in the JAX engine.

Tensor-parallel serving (`Generator(mesh=make_mesh({"tp": N}, devices))`)
runs in this engine: the pool is {rank: (L, num_blocks, block_size, G/tp,
hs)} (`Generator.init_paged_kv`; the int8 pool's scales split the same
group axis), one block id indexing every rank's slice, and every forward
is `transformer.sharded_forward`: each rank's K1 over its own heads and
pool slice, with the shared tables and spans, its knobs resolved on the
model's whole geometry.  The scheduler, pool, prefix cache, preemption,
speculation, a draft model (on the same mesh) and the host tier (one slab
per rank leaf) are host-side and run unchanged; the steps stay CUDA
graphs when every rank is on one card, and launch eagerly otherwise.
`validate_serving_mesh` refuses dp, ep and sp meshes with the JAX
package's messages.  Pipeline-parallel serving is `serving/pipeline.py`'s
subclass, which overrides the pool (`_init_pool`), the forward and the
decode chunk.
"""

from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdi_llm_tpu_torch.config import ServingConfig, dtype_bytes
from mdi_llm_tpu_torch.generation import (
    Generator,
    accept_draft,
    detect_stop_tokens,
    find_eot,
    ngram_draft,
    pad_draft,
    rng_for,
)
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.obs.device import (
    StepSpec,
    abstractify,
    introspect_call,
    introspect_step,
)
from mdi_llm_tpu_torch.ops.sampling import (
    sample_mode,
    sample_traced,
    sampling_operands,
    speculative_verify,
)
from mdi_llm_tpu_torch.serving.host_tier import (
    HostBlockStore,
    HostTier,
    SwapCostModel,
    SwapRecord,
    raw_dtype,
)
from mdi_llm_tpu_torch.serving.kv_pool import KVPool
from mdi_llm_tpu_torch.serving.scheduler import Request, Scheduler, SequenceState
from mdi_llm_tpu_torch.utils.step_graph import StepGraph, summarize

__all__ = ["ServingEngine", "ServingStats", "check_serving_config", "validate_serving_mesh"]

_POOL_DTYPES = {
    "float8": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float32": torch.float32, "float64": torch.float64,
}


def validate_serving_mesh(mesh) -> None:
    """Refuse meshes the serving engine cannot run, naming the offending
    axis and the supported alternative (the JAX package's messages).
    Called from `Generator.serve()`, before any pool is allocated.

    Supported: no mesh, a `tp` axis (the paged pool splits its KV-group
    axis) or a `pp` axis.  dp > 1 is not: requests are scheduled into
    slots, not batch-split, so a dp axis would replicate the pool without
    serving anything on the replicas.  ep would need the MoE all_to_all
    threaded through every serving dispatch, and sp's sequence-split
    cache contradicts the pooled block layout."""
    if mesh is None:
        return
    for axis in mesh.axis_names:
        size = int(mesh.shape[axis])
        if size <= 1 or axis in ("tp", "pp"):
            continue
        if axis == "dp":
            raise ValueError(
                f"serving does not support dp={size}: the engine "
                "schedules requests into slots, not dp-split batches — "
                "use a tp and/or pp mesh (or run one engine per replica)"
            )
        if axis == "ep":
            raise ValueError(
                f"serving does not support ep={size}: expert parallelism "
                "would need the MoE all_to_all threaded through every "
                "serving dispatch — shard experts within a stage via tp, "
                "or split layers over pp"
            )
        if axis == "sp":
            raise ValueError(
                f"serving does not support sp={size}: a sequence-sharded "
                "cache contradicts the pooled block layout (every block "
                "holds full heads of a token span) — use tp and/or pp"
            )
        raise ValueError(
            f"serving does not support a mesh with axis {axis!r} "
            f"(size {size}): only tensor parallelism ('tp', KV-group "
            "sharding) and pipeline parallelism ('pp', per-stage pool "
            "shards), alone or composed, serve the paged pool"
        )


def check_serving_config(serving: ServingConfig) -> None:
    """Refuse every ServingConfig knob this port does not carry yet (see
    ROADMAP.md Queue 1), and the combinations the JAX engine refuses, with
    its messages: never ignore one, never compute something else."""
    if serving.block_size < 1:
        raise ValueError("block_size must be positive")
    if serving.decode_chunk < 1:
        raise ValueError("decode_chunk must be >= 1")
    if serving.spec_k < 0:
        raise ValueError("spec_k must be >= 0")
    if (
        serving.spec_k
        and serving.temperature != 0.0
        and not serving.spec_verify_sampled()
    ):
        raise ValueError(
            "spec_sampled=False pins the exact-match verify, which "
            "emits greedy successors and is only exact at "
            "temperature=0 — drop spec_sampled=False (auto selects "
            "the rejection-sampled verify at temperature>0) or set "
            "temperature=0"
        )
    if serving.draft_model and not serving.spec_k:
        raise ValueError(
            "draft_model is a drafter for speculative serving: set "
            "spec_k > 0 (the draft scan proposes up to spec_k tokens "
            "per slot per verify)"
        )


def resolve_pool_dtype(serving: ServingConfig, cache_dtype: torch.dtype):
    """(pool dtype, its name) as the JAX engine resolves `kv_dtype`: None
    keeps the Generator's cache dtype; "int8" is the quantized pool;
    "float8" and "float8_e4m3fn" are e4m3, "float8_e5m2" is e5m2, and the
    float names cast on write.  Unknown names are refused through the byte
    table (`config.dtype_bytes`), known non-storage ones by name."""
    if serving.kv_dtype is None:
        return cache_dtype, str(cache_dtype).replace("torch.", "")
    name = serving.resolved_kv_dtype()
    dtype_bytes(name)  # ValueError on names the table doesn't know
    if name == "int8":
        return "int8", name
    if name not in _POOL_DTYPES:
        raise ValueError(
            f"kv_dtype {name!r} is not a paged-pool storage dtype: "
            "use 'int8' (quantized blocks + per-block scales) or a "
            "float dtype (cast on write)"
        )
    return _POOL_DTYPES[name], name


def pool_bytes(kv) -> int:
    """Device bytes of a pool (payload and scales)."""
    return sum(x.numel() * x.element_size() for x in transformer.tree_leaves(kv))


@dataclass
class ServingStats:
    """The JAX engine's stats with the same keys (`to_dict`), so a stats
    line of either package reads the same.  The host-tier counters are
    folded from the tier at run end, and stay 0 without one."""

    tokens_generated: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    mixed_steps: int = 0
    decode_steps: int = 0
    host_syncs: int = 0
    tokens_dispatched: int = 0
    tokens_useful: int = 0
    _occ_sum: float = 0.0
    _occ_n: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_drafted_ngram: int = 0
    spec_accepted_ngram: int = 0
    spec_drafted_model: int = 0
    spec_accepted_model: int = 0
    requests_finished: int = 0
    preemptions: int = 0
    requests_rejected: int = 0
    queue_depth_peak: int = 0
    offered_qps: float = 0.0
    resident_peak: int = 0
    prefix_cache_hits: int = 0
    swaps_out: int = 0
    swaps_in: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    prefix_hits_host: int = 0
    restore_issue_s: float = 0.0
    wall_s: float = 0.0
    decode_s: float = 0.0
    prefill_s: float = 0.0
    _kv_util_sum: float = 0.0
    _kv_util_n: int = 0
    _kv_util_peak: float = 0.0

    def observe_kv_utilization(self, util: float) -> None:
        self._kv_util_sum += util
        self._kv_util_n += 1
        self._kv_util_peak = max(self._kv_util_peak, util)

    def observe_dispatch(self, dispatched: int, useful: int) -> None:
        self.tokens_dispatched += dispatched
        self.tokens_useful += useful

    def observe_mixed_occupancy(self, live: int, max_batch: int) -> None:
        self._occ_sum += live / max(1, max_batch)
        self._occ_n += 1

    def observe_resident(self, live: int) -> None:
        self.resident_peak = max(self.resident_peak, live)

    @property
    def padded_token_frac(self) -> float:
        if not self.tokens_dispatched:
            return 0.0
        return 1.0 - self.tokens_useful / self.tokens_dispatched

    @property
    def mixed_batch_occupancy(self) -> float:
        return self._occ_sum / self._occ_n if self._occ_n else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s else 0.0

    @property
    def tokens_per_sync(self) -> float:
        return self.tokens_generated / self.host_syncs if self.host_syncs else 0.0

    @property
    def spec_accept_rate(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    @property
    def kv_utilization_mean(self) -> float:
        return self._kv_util_sum / self._kv_util_n if self._kv_util_n else 0.0

    @property
    def kv_utilization_peak(self) -> float:
        return self._kv_util_peak

    def to_dict(self) -> Dict[str, Any]:
        return {
            "requests": self.requests_finished,
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": round(self.tokens_per_s, 2),
            "wall_s": round(self.wall_s, 2),
            "decode_s": round(self.decode_s, 3),
            "prefill_s": round(self.prefill_s, 3),
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "host_syncs": self.host_syncs,
            "tokens_per_sync": round(self.tokens_per_sync, 2),
            "padded_token_frac": round(self.padded_token_frac, 4),
            "mixed_batch_occupancy": round(self.mixed_batch_occupancy, 4),
            "spec_accept_rate": round(self.spec_accept_rate, 4),
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_drafted_ngram": self.spec_drafted_ngram,
            "spec_accepted_ngram": self.spec_accepted_ngram,
            "spec_drafted_model": self.spec_drafted_model,
            "spec_accepted_model": self.spec_accepted_model,
            "kv_block_utilization_mean": round(self.kv_utilization_mean, 4),
            "kv_block_utilization_peak": round(self.kv_utilization_peak, 4),
            "prefix_cache_hits": self.prefix_cache_hits,
            "preemptions": self.preemptions,
            "swaps_out": self.swaps_out,
            "swaps_in": self.swaps_in,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
            "prefix_hits_host": self.prefix_hits_host,
            "restore_issue_s": round(self.restore_issue_s, 4),
            "resident_peak": self.resident_peak,
            "requests_rejected": self.requests_rejected,
            "queue_depth_peak": self.queue_depth_peak,
            "offered_qps": round(self.offered_qps, 3),
        }


def _raw(t: torch.Tensor) -> torch.Tensor:
    """`t`'s bytes as the integer dtype of its element width (a view)."""
    return t.view(raw_dtype(t.dtype))


def _weak(method):
    """A bound method held weakly: hooks on the pool and the scheduler must
    not keep a finished engine (and its device pool) alive."""
    ref = weakref.WeakMethod(method)
    return lambda *args: ref()(*args)


class ServingEngine:
    """Paged-KV continuous-batching loop bound to one `Generator`.  Build
    it with `Generator.serve(...)`::

        engine = gen.serve(block_size=16, max_batch=8)
        engine.add_request("a", prompt_tokens, max_new_tokens=128)
        results, stats = engine.run()
    """

    # which axis of a pool leaf indexes blocks: the host tier's gathers,
    # restores and slab layout key off it
    _kv_block_axis = 1
    # the engine's own int counters that a replayed step advances
    _step_counters = ("forward_calls",)

    def __init__(self, gen: Generator, serving: ServingConfig, obs=None,
                 policy=None, draft_gen: Optional[Generator] = None,
                 _graphs: Optional[bool] = None):
        """`_graphs` (private, for comparisons on the card only): False
        runs the step bodies as eager launches; None follows the
        Generator's switch (CUDA graphs on the card)."""
        check_serving_config(serving)
        self.gen = gen
        self.cfg = serving
        self.device = gen.device
        bs = serving.block_size
        self._pool_dtype, self.kv_dtype_name = resolve_pool_dtype(
            serving, gen.cache_dtype
        )
        self.token_budget = serving.resolved_token_budget()
        if self.token_budget <= serving.max_batch:
            raise ValueError(
                f"token_budget {self.token_budget} must exceed max_batch "
                f"{serving.max_batch}: the unified step packs one decode "
                "token per live slot first, so a budget at or below "
                "max_batch leaves no room for any prefill token"
            )
        self.max_seq_length = gen.max_seq_length
        self.max_blocks_per_seq = -(-self.max_seq_length // bs)
        num_blocks = serving.num_pool_blocks(self.max_seq_length)
        self.pool = KVPool(num_blocks, bs, prefix_caching=serving.prefix_caching)
        self.scheduler = Scheduler(
            self.pool, serving.max_batch, serving.prefill_chunk,
            self.max_seq_length, policy=policy,
        )
        # observability (obs.ServingObserver or None): fed only at host-sync
        # boundaries, outside the captured step bodies
        self.obs = obs
        self.scheduler.observer = obs  # lifecycle edges report from there
        self._kv = self._init_pool(num_blocks, bs)
        # host-RAM tier (serving/host_tier.py): host_pool_mib = 0 leaves
        # every table, hook and step untouched
        self.host_tier: Optional[HostTier] = None
        self._host_block_bytes = 0
        # gathers whose copies into host slots are queued: (start and end
        # timing events on a CUDA device, host seconds, live block count)
        self._pending_swaps: List[Tuple[Any, Any, float, int]] = []
        if serving.host_pool_mib > 0:
            self._init_host_tier()
        # persistent host-side block table, updated incrementally
        self._tables = np.zeros(
            (serving.max_batch, self.max_blocks_per_seq), np.int32
        )
        self._table_seq: List[Optional[SequenceState]] = [None] * serving.max_batch
        self._table_len = [0] * serving.max_batch
        self._t_op, self._p_op = sampling_operands(
            serving.temperature, serving.top_p, self.device
        )
        self._sample_mode = sample_mode(
            serving.temperature, serving.top_k, serving.top_p
        )
        self._rng = rng_for(self.device, gen.rng_seed)
        self.forward_calls = 0  # model forwards this engine ran (all layers)
        self.draft_forward_calls = 0  # the draft model's forwards
        # optional draft model with its own paged pool; all None without
        # draft_model, so every other path is untouched
        self.draft_gen: Optional[Generator] = None
        self.draft_pool: Optional[KVPool] = None
        self._draft_kv = None
        self._draft_tables: Optional[np.ndarray] = None
        if serving.draft_model:
            self._init_draft(draft_gen)
        self.stats = ServingStats()
        self._results: Dict[str, List[int]] = {}
        self._stream_cb = None
        self._graphs = gen._graphs if _graphs is None else bool(_graphs)
        self._steps = self._build_steps()
        self._capture_steps()

    def _init_pool(self, num_blocks: int, bs: int):
        """The device pool every step reads and writes: one (L, num_blocks,
        bs, G, hs) tree of the pool dtype on the engine's device, or on a tp
        mesh one (L, num_blocks, bs, G/tp, hs) tree per rank on its device
        (`Generator.init_paged_kv`)."""
        return self.gen.init_paged_kv(num_blocks, bs, self._pool_dtype)

    # -- the per-shape steps (CUDA graphs on the card) -----------------------

    def _build_steps(self) -> Dict[str, StepGraph]:
        """The mixed step at (max_batch, token_budget) and the decode step
        this engine takes: the K-step chunk at (max_batch, decode_chunk), or
        the per-token decode at max_batch.  Each keys on the sampler's mode
        and top_k too, as the JAX engine's executables do; temperature and
        top_p ride as the device operands `_t_op`/`_p_op`."""
        B, T = self.scheduler.max_batch, self.token_budget
        MB, K = self.max_blocks_per_seq, self.cfg.decode_chunk
        sampler = (self._sample_mode, self.cfg.top_k)

        def buf(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def step(name, key, body, **inputs):
            return StepGraph(
                name, key + sampler, self, body, inputs, capture=self._graphs,
                generators=[self._rng], counters=self._step_counters,
            )

        cls = type(self)
        steps = {"mixed": step(
            "mixed", (B, T), cls._mixed_body, tokens=buf(1, T), pos=buf(1, T),
            q_slot=buf(T), q_start=buf(B), q_len=buf(B),
            last_idx=buf(B, dtype=torch.int64), tables=buf(B, MB),
        )}
        if K > 1:
            steps["decode_chunk"] = step(
                "decode_chunk", (B, K), cls._decode_chunk_body, tok=buf(B),
                pos=buf(B), tables=buf(B, MB), limit=buf(B), stop_tok=buf(B),
            )
        else:
            steps["decode"] = step(
                "decode", (B,), cls._decode_body, tok=buf(B), pos=buf(B),
                tables=buf(B, MB),
            )
        return steps

    def _capture_steps(self) -> None:
        """Capture every step over its zero-filled (inert) inputs: all-zero
        tables send every write to the trash block, so no live block
        changes.  A no-op on the CPU and with `_graphs` off, except that an
        observer with device capture measures each step here, once per
        (step, shape, pool dtype) per Generator (`obs/device.py`)."""
        for label, s in self._steps.items():
            if self._device_capture():
                self._publish(label, s.key[:-2], lambda s=s, label=label:
                              introspect_step(s, label, s.key[:-2], self.kv_dtype_name,
                                              alias_bytes=pool_bytes(self._kv)))
            s.prime()

    def _device_capture(self) -> bool:
        return self.obs is not None and self.obs.device.capture_enabled

    def _publish(self, label, key, measure) -> None:
        """Measure (label, key) once per Generator and publish the report."""
        cache = self.gen._exec_reports
        k = (label, tuple(key), self.kv_dtype_name)
        if k not in cache:
            cache[k] = measure()
        self.obs.publish_device_report(cache[k])

    def _observed(self, label, key, fn, *args):
        """`fn(*args)`, an eager step: its first call per Generator runs
        under the observer's probe when device capture is on."""
        k = (label, tuple(key), self.kv_dtype_name)
        if not self._device_capture() or k in self.gen._exec_reports:
            return fn(*args)
        out, rep = introspect_call(fn, args, label, key, self.kv_dtype_name,
                                   alias_bytes=pool_bytes(self._kv))
        self._publish(label, key, lambda: rep)
        return out

    def graph_stats(self) -> Dict[str, Any]:
        """Steps built, graphs captured and replayed, capture seconds."""
        return summarize(self._steps.values())

    @property
    def devices(self) -> int:
        """Distinct devices the pool lies on (tp ranks may share one)."""
        return len({x.device for x in transformer.tree_leaves(self._kv)})

    # -- draft model (speculative drafting over a second paged pool) ---------

    def _init_draft(self, draft_gen: Optional[Generator]) -> None:
        """Build the draft Generator and its own paged pool, sized by
        `ServingConfig.num_draft_blocks`.  The draft pool has the target
        pool's dtype, no prefix cache and no host tier: draft KV is always
        recomputable from the token list, so retire/preempt drop it
        wholesale (`Scheduler._release_draft`)."""
        serving = self.cfg
        tcfg = self.gen.cfg
        dcfg = draft_gen.cfg if draft_gen is not None else serving.draft_config()
        if dcfg.padded_vocab_size != tcfg.padded_vocab_size:
            raise ValueError(
                f"draft_model {serving.draft_model!r} has padded vocab "
                f"{dcfg.padded_vocab_size}, the target has "
                f"{tcfg.padded_vocab_size}: the rejection verify compares "
                "token ids, so drafter and verifier must share a vocabulary"
            )
        if dcfg.block_size < self.max_seq_length:
            raise ValueError(
                f"draft_model {serving.draft_model!r} context window "
                f"{dcfg.block_size} is smaller than the engine's "
                f"max_seq_length {self.max_seq_length}: the draft must "
                "follow every lane to the window edge"
            )
        if draft_gen is None:
            draft_gen = self._build_draft_gen(dcfg)
        self.draft_gen = draft_gen
        n_blocks = serving.num_draft_blocks(self.max_seq_length)
        self.draft_pool = KVPool(n_blocks, serving.block_size, prefix_caching=False)
        self.scheduler.draft_pool = self.draft_pool
        self._draft_kv = draft_gen.init_paged_kv(n_blocks, serving.block_size,
                                                 self._pool_dtype)
        self._draft_tables = np.zeros(
            (serving.max_batch, self.max_blocks_per_seq), np.int32
        )

    def _build_draft_gen(self, dcfg) -> Generator:
        """The draft Generator when the caller hands none in: random
        weights (seed 0, as the JAX engine's PRNGKey(0)) at the target's
        parameter dtype, on the target's device and mesh."""
        gen = self.gen
        dtype = transformer.param_dtype(gen.params)
        if gen.abstract:  # a traced engine's draft: meta stubs, as its target
            from mdi_llm_tpu_torch.analysis.plan import abstract_params

            dparams = abstract_params(dcfg, str(dtype).replace("torch.", ""))
        else:
            dparams = transformer.init_params(dcfg, 0, dtype=dtype, device=gen.device)
        return Generator(
            dcfg, dparams, max_seq_length=self.max_seq_length,
            cache_dtype=gen.cache_dtype, rng_seed=gen.rng_seed, device=gen.device,
            mesh=gen._tp_mesh, abstract=gen.abstract,
        )

    def _ensure_draft_blocks(self, seq: SequenceState, n_tokens: int) -> bool:
        """Grow `seq`'s draft-pool table to cover `n_tokens` positions,
        without preemption (the draft pool is a fixed carve-out; a lane it
        cannot cover keeps the n-gram drafter)."""
        pool = self.draft_pool
        need = pool.blocks_needed(min(n_tokens, self.max_seq_length))
        while len(seq.draft_blocks) < need:
            got = pool.alloc(1)
            if got is None:
                return False
            seq.draft_blocks.extend(got)
        return True

    def _sync_draft_tables(self, seqs: Sequence[SequenceState]) -> np.ndarray:
        """Block table into the draft pool, rebuilt per dispatch; zero rows
        send every absent or stale lane's writes to its trash block."""
        t = self._draft_tables
        t[:] = 0
        for seq in seqs:
            t[seq.slot, : len(seq.draft_blocks)] = seq.draft_blocks
        return t

    # -- host-RAM tier (serving/host_tier.py) --------------------------------

    def _kv_leaf_shapes(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) per pool leaf in sorted-key order: the slab
        template the host store mirrors and what fetch and restore move."""
        return [(tuple(x.shape), x.dtype) for x in transformer.tree_leaves(self._kv)]

    def _init_host_tier(self) -> None:
        """Build the host block store and cost model and install the tier
        hooks on the pool and the scheduler.  Slab shapes come from the
        live pool leaves, so fp, float8 and int8 (payload and scales)
        pools round-trip byte for byte; the slot count divides the
        `host_pool_mib` budget by the per-block bytes, exactly
        `ServingConfig.num_host_blocks`.  On a CUDA device the slabs are
        pinned and the link prior is looked up by the device's name."""
        ba = self._kv_block_axis
        leaf_shapes = self._kv_leaf_shapes()
        per_block = sum(
            dtype.itemsize * math.prod(shape[:ba] + shape[ba + 1:])
            for shape, dtype in leaf_shapes
        )
        self._host_block_bytes = per_block
        num_slots = (self.cfg.host_pool_mib * 2**20) // max(1, per_block)
        cuda = self.device.type == "cuda"
        device_kind = torch.cuda.get_device_name(self.device) if cuda else None
        self.host_tier = HostTier(
            HostBlockStore(leaf_shapes, ba, num_slots, pin_memory=cuda),
            SwapCostModel(link_gbps=self.cfg.resolved_host_link_gbps(device_kind)),
            # spilling rides the hash chain: without prefix caching there
            # is no chain to key the spilled blocks
            prefix_spill=self.cfg.host_prefix_spill and self.cfg.prefix_caching,
        )
        self.pool.host = self.host_tier
        if self.host_tier.prefix_spill:
            self.pool.spill_hook = _weak(self._spill_block)
            self.pool.restore_hook = _weak(self._restore_spilled)
        self.scheduler.swap_out_hook = _weak(self._swap_out)
        self.scheduler.swap_in_hook = _weak(self._swap_in)
        self.scheduler.swap_drop_hook = _weak(self._swap_drop)

    def _issue_fetch(self, blocks: List[int], slots: List[int]) -> None:
        """Queue gather snapshots of `blocks` in fixed-width chunks of
        `swap_chunk_blocks` (short tails pad with reads of block 0), each
        followed by its rows' copies into the host `slots`.  They run on the
        stream the steps replay on, after every step already queued and
        before any later one: the blocks may return to the free list at
        once.  The copies are waited for at the next host-sync boundary
        (`_drain_swaps`); on a CUDA device two timing events bracket them,
        so the cost model learns the transfer's own time."""
        W = max(1, self.cfg.swap_chunk_blocks)
        ba = self._kv_block_axis
        leaves = [_raw(x) for x in transformer.tree_leaves(self._kv)]
        store = self.host_tier.store
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        start = end = None
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        for i in range(0, len(blocks), W):
            chunk = blocks[i : i + W]
            idx = np.zeros((W,), np.int64)
            idx[: len(chunk)] = chunk
            gathered = self._gather_blocks(self._upload_per_device(idx, leaves))
            store.write(slots[i : i + W], gathered, non_blocking=cuda)
        if cuda:
            end.record()
        self._pending_swaps.append((start, end, time.perf_counter() - t0, len(blocks)))

    def _drain_swaps(self) -> None:
        """Wait for every pending gather's copies into the host slots.
        Runs at host-sync boundaries (each step, and before any host-slab
        read), so the copies overlap the steps queued after them; their
        measured time (device time between the events on a CUDA device,
        the synchronous copies' host time on the CPU) feeds the cost
        model's link estimate."""
        if not self._pending_swaps:
            return
        seconds = 0.0
        nbytes = 0
        for start, end, host_s, n in self._pending_swaps:
            if end is not None:
                end.synchronize()  # the slots are readable only now
                seconds += start.elapsed_time(end) / 1e3
            else:
                seconds += host_s
            nbytes += n * self._host_block_bytes
        self._pending_swaps.clear()
        self.host_tier.cost_model.observe_transfer(nbytes, seconds)

    def _restore(self, slots: List[int], blocks: List[int]) -> None:
        """Write the payload of host `slots` into pool `blocks` in place,
        in fixed-width chunks: each chunk's rows are copied from the pinned
        slabs into a device buffer and written with `index_copy_` into the
        pool's own tensors (a captured step graph reads them, so they are
        never rebound); padding rows go to the trash block 0.  The copies
        are queued on the stream, ahead of the next step and of any later
        fetch into the same slots, so the slots may be released at once."""
        W = max(1, self.cfg.swap_chunk_blocks)
        leaves = transformer.tree_leaves(self._kv)
        store = self.host_tier.store
        for i in range(0, len(blocks), W):
            chunk = blocks[i : i + W]
            idx = np.zeros((W,), np.int64)  # padding writes to the trash block
            idx[: len(chunk)] = chunk
            rows = store.read(slots[i : i + W], width=W, device=self.device,
                              non_blocking=True)
            self._restore_blocks(self._upload_per_device(idx, leaves), rows)

    def _gather_blocks(self, idx_d) -> List[torch.Tensor]:
        """The tier's gather on the device (the JAX `_fetch_blocks_fn(W)`):
        each pool leaf's W blocks `idx_d[leaf's device]`, block axis first,
        as raw bytes."""
        ba = self._kv_block_axis
        leaves = [_raw(x) for x in transformer.tree_leaves(self._kv)]
        return [x.index_select(ba, idx_d[x.device]).movedim(ba, 0).contiguous()
                for x in leaves]

    def _restore_blocks(self, idx_d, rows) -> None:
        """The tier's restore on the device (the JAX `_restore_blocks_fn(W)`):
        each leaf's payload rows written into its W blocks
        `idx_d[leaf's device]` in place (`index_copy_`)."""
        ba = self._kv_block_axis
        leaves = [_raw(x) for x in transformer.tree_leaves(self._kv)]
        for leaf, payload in zip(leaves, rows):
            payload = payload.to(leaf.device, non_blocking=True)
            leaf.index_copy_(ba, idx_d[leaf.device], payload.view(leaf.dtype).movedim(0, ba))

    def _swap_out(self, seq: SequenceState) -> Optional[SwapRecord]:
        """Scheduler hook at `preempt_latest`, called while the victim
        still owns its blocks: decide swap vs recompute from the cost
        model, claim host slots and queue the gather.  Returns the
        SwapRecord riding the preempted entry, or None for recompute."""
        tier = self.host_tier
        if tier is None or seq.fed <= 0:
            return None
        n_blocks = self.pool.blocks_needed(seq.fed)
        nbytes = n_blocks * self._host_block_bytes
        # recompute would re-prefill every fed token on resume
        if not tier.cost_model.should_swap(nbytes, seq.fed):
            return None
        slots = tier.alloc_for_swap(n_blocks)
        if slots is None:
            return None
        self._issue_fetch(seq.blocks[:n_blocks], slots)
        tier.swaps_out += 1
        tier.swap_out_bytes += nbytes
        if self.obs is not None:
            self.obs.tier_swap_out(n_blocks, nbytes)
        return SwapRecord(slots=slots, n_tokens=seq.fed, nbytes=nbytes)

    def _swap_in(self, record: SwapRecord, blocks: List[int]) -> None:
        """Scheduler hook at a swapped resume's admission: restore the
        record's payload into the freshly allocated `blocks`, queued ahead
        of the resumed sequence's next step."""
        if len(blocks) != len(record.slots):
            raise ValueError(
                f"swap-in of {len(record.slots)} host slots into {len(blocks)} blocks"
            )
        tier = self.host_tier
        self._drain_swaps()  # the record's own gather may still be pending
        t0 = time.perf_counter()
        self._restore(record.slots, blocks)
        tier.store.release(record.slots)
        tier.swaps_in += 1
        tier.swap_in_bytes += record.nbytes
        dt = time.perf_counter() - t0
        self.stats.restore_issue_s += dt
        if self.obs is not None:
            self.obs.tier_swap_in(len(blocks), record.nbytes)
            self.obs.restore_wait(dt)

    def _swap_drop(self, record: SwapRecord) -> None:
        """Release a swap record's host slots without restoring (the
        frontend cancelled the preempted request)."""
        self._drain_swaps()  # its gather may still target those slots
        self.host_tier.store.release(record.slots)

    def _spill_block(self, blk: int, chain_hash: int) -> None:
        """Pool hook as a cached chain block is evicted: copy it to a host
        slot instead of dropping it.  The gather is queued before the
        block's new owner can write it, so eviction stays copy-free in the
        pool."""
        tier = self.host_tier
        slot = tier.alloc_for_spill()
        if slot is None:
            return
        self._issue_fetch([blk], [slot])
        tier.record_spill(chain_hash, slot)

    def _restore_spilled(self, chain_hash: int) -> Optional[int]:
        """Pool hook on a prefix-cache miss: if the chain spilled to the
        host tier, claim a fresh block (refcount 1), restore its payload
        and hand it back to `match_prefix`; the hit counts as
        `prefix_hits_host`.  None when the hash is not spilled or the pool
        has no block to spare (the host copy is then dropped)."""
        tier = self.host_tier
        slot = tier.take_spill(chain_hash)
        if slot is None:
            return None
        got = self.pool.alloc(1)
        if got is None:
            tier.store.release([slot])
            return None
        self._drain_swaps()  # the spill's gather may still be in flight
        t0 = time.perf_counter()
        self._restore([slot], got)
        tier.store.release([slot])
        tier.swaps_in += 1
        tier.swap_in_bytes += self._host_block_bytes
        dt = time.perf_counter() - t0
        self.stats.restore_issue_s += dt
        if self.obs is not None:
            self.obs.tier_swap_in(1, self._host_block_bytes)
            self.obs.restore_wait(dt)
        return got[0]

    # -- device helpers ------------------------------------------------------

    def _upload(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Host array -> device tensor (the engine's device by default)
        without waiting for the device: a pinned staging copy and a
        non-blocking transfer on CUDA (a plain pageable copy would
        synchronize the stream and defeat double buffering)."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.array(arr, copy=True))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def _upload_per_device(self, arr: np.ndarray, leaves) -> Dict[torch.device, torch.Tensor]:
        """`arr` uploaded once to each device that holds one of `leaves`
        (a staged pool spreads its leaves over the stages' devices)."""
        return {d: self._upload(arr, d) for d in {x.device for x in leaves}}

    def _read_async(self, x: torch.Tensor):
        """Start a device -> host copy of `x`; `_wait` returns it as numpy.
        A step's outputs are overwritten by its next run, so the CPU copies
        too."""
        if self.device.type != "cuda":
            return x.clone(), None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _wait(pending) -> np.ndarray:
        host, event = pending
        if event is not None:
            event.synchronize()
        return host.numpy()

    def _forward(self, tokens, pos, tables, paged_ragged=None) -> torch.Tensor:
        """One model forward over the shared pool; the pool is updated in
        place (no copy of it is ever made)."""
        self.forward_calls += 1
        return self.gen._forward(tokens, pos, self._kv, paged_tables=tables,
                                 paged_kernel=self.cfg.use_kernel,
                                 paged_ragged=paged_ragged)

    def _draft_forward(self, tokens, pos, tables, paged_ragged=None) -> torch.Tensor:
        """One draft-model forward over the draft pool, in place."""
        self.draft_forward_calls += 1
        return self.draft_gen._forward(tokens, pos, self._draft_kv, paged_tables=tables,
                                       paged_kernel=self.cfg.use_kernel,
                                       paged_ragged=paged_ragged)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_traced(
            logits, self._rng, self._t_op, self._p_op,
            mode=self._sample_mode, top_k=self.cfg.top_k,
        ).to(torch.int32)

    # -- request surface -----------------------------------------------------

    def add_request(
        self,
        rid: str,
        prompt: Sequence[int],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
        priority: int = 0,
        tenant: str = "",
        ttft_slo_s: Optional[float] = None,
    ) -> str:
        """Queue a request; raises ValueError if it can never fit."""
        self.scheduler.add(Request(
            rid=rid, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            stop_sequences=stop_sequences,
            priority=int(priority), tenant=str(tenant),
            ttft_slo_s=ttft_slo_s,
        ))
        return rid

    def _sync_tables(self, live: Sequence[SequenceState]) -> np.ndarray:
        """The persistent (max_batch, max_blocks_per_seq) block table,
        updated incrementally; every slot not in `live` is zeroed, so a
        dead lane's writes land in the trash block, never in a real one."""
        want: List[Optional[SequenceState]] = [None] * self.scheduler.max_batch
        for seq in live:
            want[seq.slot] = seq
        for slot, seq in enumerate(want):
            if seq is None:
                if self._table_seq[slot] is not None or self._table_len[slot]:
                    self._tables[slot] = 0
                    self._table_seq[slot], self._table_len[slot] = None, 0
                continue
            n = len(seq.blocks)
            if seq is not self._table_seq[slot] or n < self._table_len[slot]:
                row = self._tables[slot]
                row[:] = 0
                row[:n] = seq.blocks
                self._table_seq[slot], self._table_len[slot] = seq, n
            elif n > self._table_len[slot]:
                self._tables[slot, self._table_len[slot]: n] = \
                    seq.blocks[self._table_len[slot]:]
                self._table_len[slot] = n
        return self._tables

    # -- execution -----------------------------------------------------------

    def _run_mixed(self, entries: List[Tuple[SequenceState, int]]) -> None:
        """ONE unified ragged forward serving every lane: each decode lane's
        pending token and each prefilling lane's next chunk, packed
        slot-major into a (1, token_budget) axis; the tail pads with
        positions past every table, whose writes go to the trash block."""
        t0 = time.perf_counter()
        need = {id(s): n for s, n in entries}
        live = [
            (s, need[id(s)])
            for s in self._live_reserved(
                [s for s, _ in entries], lambda s: need[id(s)]
            )
        ]
        if not live:
            return
        n_prefill_toks = sum(n for s, n in live if s.needs_prefill)
        B = self.scheduler.max_batch
        T = self.token_budget
        trash_pos = self.max_blocks_per_seq * self.pool.block_size
        tokens = np.zeros((1, T), np.int32)
        pos = np.full((1, T), trash_pos, np.int32)
        q_slot = np.zeros((T,), np.int32)
        q_start = np.zeros((B,), np.int32)
        q_len = np.zeros((B,), np.int32)
        last_idx = np.zeros((B,), np.int64)
        off = 0
        for seq, n in live:
            feed = (seq.tokens[seq.fed : seq.fed + n]
                    if seq.needs_prefill else [seq.next_tok])
            tokens[0, off : off + n] = feed
            pos[0, off : off + n] = np.arange(seq.fed, seq.fed + n)
            q_slot[off : off + n] = seq.slot
            q_start[seq.slot] = off
            q_len[seq.slot] = n
            last_idx[seq.slot] = off + n - 1
            off += n
        tables = self._sync_tables([s for s, _ in live])
        step = self._steps["mixed"]
        read = self._read_async(step.run(
            tokens=tokens, pos=pos, q_slot=q_slot, q_start=q_start, q_len=q_len,
            last_idx=last_idx, tables=tables,
        ))
        # the draft model follows the same packed batch, queued before the
        # host waits on the step's one read
        self._mirror_mixed_to_draft(live, step.inputs)
        nxt = self._wait(read)  # the step's one host read
        self.stats.mixed_steps += 1
        self.stats.host_syncs += 1
        self.stats.observe_dispatch(T, off)
        self.stats.observe_mixed_occupancy(len(live), B)
        self.stats.observe_resident(len(self.scheduler.running()))
        self.stats.observe_kv_utilization(self.pool.utilization)
        if self.obs is not None:
            # one stamp at THIS boundary; every token/retirement below
            # shares it
            self.obs.step(
                "mixed", width=T, live=len(live), t_start=t0,
                kv_utilization=self.pool.utilization,
                queue_depth=self._queue_depth(), useful_tokens=off,
            )
        any_decode = False
        for seq, n in live:
            if seq.needs_prefill:
                seq.fed += n
                self.stats.prefill_tokens += n
                self.stats.prefill_chunks += 1
                if self.obs is not None:
                    self.obs.prefill_chunk(seq.req.rid, n)
                if seq.fed >= seq.prefill_target:
                    # the prompt's KV (as far as it was fed) is in the pool
                    # now: publish its full blocks for prefix reuse
                    self.pool.register_prefix(
                        seq.blocks, seq.req.prompt[: seq.fed]
                    )
                    if seq.resume_tok is not None:
                        seq.next_tok = seq.resume_tok  # kept across preemption
                    else:
                        self._emit(seq, int(nxt[seq.slot]))
            else:
                any_decode = True
                seq.fed += 1
                self._emit(seq, int(nxt[seq.slot]))
        if any_decode:
            self.stats.decode_steps += 1
        if self.host_tier is not None and n_prefill_toks:
            self.host_tier.cost_model.observe_prefill(
                n_prefill_toks, time.perf_counter() - t0
            )
        self.stats.prefill_s += time.perf_counter() - t0

    def _mixed_body(self, tokens, pos, q_slot, q_start, q_len, last_idx, tables):
        """The mixed step (the JAX `_mixed_fn`): one ragged forward, then
        the sampled successor of each slot's last packed token, (B,)."""
        logits = self._forward(tokens, pos, tables, paged_ragged=(q_slot, q_start, q_len))
        return self._sample(logits[0, last_idx])

    def _mirror_mixed_to_draft(self, live, inputs: Dict[str, torch.Tensor]) -> None:
        """Feed the mixed step's packed batch through the draft model, so
        its pool tracks the target's feed positions (`draft_fed == fed`).
        It reads the mixed step's static inputs, which hold this step's
        batch until the next step loads its own (stream order).  Only lanes
        the draft follows get table rows: stale lanes, and lanes the draft
        carve-out cannot cover, write into the draft trash block and keep
        the n-gram drafter."""
        if self.draft_gen is None:
            return
        fresh = []
        for seq, n in live:
            if seq.draft_stale or seq.draft_fed != seq.fed:
                continue
            if not self._ensure_draft_blocks(seq, seq.fed + n):
                seq.draft_stale = True  # the carve-out cannot follow it
                continue
            fresh.append((seq, n))
        if not fresh:
            return
        tables = self._upload(self._sync_draft_tables([s for s, _ in fresh]))
        self._draft_mixed_body(inputs["tokens"], inputs["pos"], tables, inputs["q_slot"],
                               inputs["q_start"], inputs["q_len"])
        for seq, n in fresh:
            seq.draft_fed += n

    def _draft_mixed_body(self, tokens, pos, tables, q_slot, q_start, q_len):
        """The draft model's mirror of the mixed step (the JAX
        `_draft_mixed_fn`): one ragged draft forward over the packed batch,
        writing the draft pool in place."""
        return self._draft_forward(tokens, pos, tables, paged_ragged=(q_slot, q_start, q_len))

    def _queue_depth(self) -> int:
        return len(self.scheduler.waiting) + len(self.scheduler.preempted)

    def _emit(self, seq: SequenceState, tok: int) -> None:
        """Append one generated token, stream it, and retire on stop/limit."""
        seq.tokens.append(tok)
        seq.next_tok = tok
        self.stats.tokens_generated += 1
        if self.obs is not None:
            self.obs.tokens(seq.req.rid)  # stamped at the last sync
        if self._stream_cb is not None:
            self._stream_cb(seq.req.rid, tok)
        gen_tokens = seq.generated()
        if (
            len(gen_tokens) >= seq.req.max_new_tokens
            or detect_stop_tokens(gen_tokens, seq.req.stop_sequences)
            or len(seq.tokens) >= self.max_seq_length
        ):
            self._finish(seq)

    def pop_result(self, rid: str) -> Optional[List[int]]:
        """Take one finished request's tokens (prompt + generation,
        stop-trimmed) out of the engine, or None if it has not finished."""
        return self._results.pop(rid, None)

    def _finish(self, seq: SequenceState) -> None:
        gen_tokens = seq.generated()
        cut = find_eot(gen_tokens, seq.req.stop_sequences)
        self._results[seq.req.rid] = seq.tokens[: seq.n_prompt + cut]
        self.scheduler.retire(seq)
        self.stats.requests_finished += 1

    def _live_reserved(self, seqs: List[SequenceState], n_writes_of) -> List[SequenceState]:
        """Sequences that still own their slot AND have block coverage for
        their next writes; growth may preempt, so re-check slot ownership."""
        live: List[SequenceState] = []
        for seq in seqs:
            if self.scheduler.slots[seq.slot] is seq and \
                    self.scheduler.ensure_blocks_for(seq, n_writes_of(seq)):
                live.append(seq)
        return [s for s in live if self.scheduler.slots[s.slot] is s]

    def _run_decode(self, seqs: List[SequenceState]) -> None:
        t0 = time.perf_counter()
        live = self._live_reserved(seqs, lambda s: 1)
        if not live:
            return
        B = self.scheduler.max_batch
        tok = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        for seq in live:
            tok[seq.slot] = seq.next_tok
            pos[seq.slot] = seq.fed
        tables = self._sync_tables(live)
        nxt = self._wait(self._read_async(
            self._steps["decode"].run(tok=tok, pos=pos, tables=tables)
        ))
        self.stats.decode_steps += 1
        self.stats.host_syncs += 1
        self.stats.observe_dispatch(B, len(live))
        self.stats.observe_resident(len(self.scheduler.running()))
        self.stats.observe_kv_utilization(self.pool.utilization)
        if self.obs is not None:
            self.obs.step(
                "decode", width=B, live=len(live), t_start=t0,
                kv_utilization=self.pool.utilization,
                queue_depth=self._queue_depth(),
            )
        for seq in live:
            seq.fed += 1
            self._emit(seq, int(nxt[seq.slot]))
        self.stats.decode_s += time.perf_counter() - t0

    def _decode_body(self, tok, pos, tables):
        """The per-token decode step (the JAX `_decode_fn`): (B,) successors."""
        return self._sample(self._forward(tok[:, None], pos, tables)[:, -1])

    # -- chunked decode (the multi-token serving step) ------------------------

    def _decode_chunk_body(self, tok, pos, tables, limit, stop_tok):
        """K = decode_chunk batched decode steps on the device with no host
        read (the JAX `_decode_chunk_fn`).  A lane advances while `i <
        limit[lane]` and it has not sampled its stop token; a frozen lane
        re-forwards its last (token, position), which rewrites the
        identical K/V bytes, and a dead lane's zero table row
        sends its writes to the trash block — so no masked step perturbs a
        live stream.  Returns (tokens (K, B), final token, final pos)."""
        done = torch.zeros_like(tok, dtype=torch.bool)
        toks = []
        for i in range(self.cfg.decode_chunk):
            active = (limit > i) & ~done
            logits = self._forward(tok[:, None], pos, tables)
            nxt = torch.where(active, self._sample(logits[:, -1]), tok)
            done = done | (active & (nxt == stop_tok))
            pos = pos + active.to(pos.dtype)
            tok = nxt
            toks.append(nxt)
        return torch.stack(toks), tok, pos

    def _chunk_limit(self, seq: SequenceState, K: int, ahead: int = 0) -> int:
        """Steps this slot may advance in a K-step chunk: its remaining
        token budget and window room, minus `ahead` tokens already
        committed to an in-flight chunk."""
        remaining = seq.req.max_new_tokens - seq.n_generated - ahead
        window = self.max_seq_length - len(seq.tokens) - ahead
        return max(0, min(K, remaining, window))

    @staticmethod
    def _stop1(seq: SequenceState) -> int:
        """The slot's single-token stop id for the device-side stop mask
        (-1 for none); longer stop sequences are found host-side."""
        for s in seq.req.stop_sequences:
            if len(s) == 1:
                return int(s[0])
        return -1

    def _drain_tokens(self, live: List[SequenceState], limits: np.ndarray,
                      toks: np.ndarray) -> bool:
        """Credit one drained chunk: emit each live slot's retained tokens
        (up to its limit, stopping at the first retirement).  True when
        every slot emitted its full limit and survived."""
        self.stats.host_syncs += 1
        self.stats.observe_kv_utilization(self.pool.utilization)
        self.stats.observe_resident(len(self.scheduler.running()))
        if self.obs is not None:
            # stamped at THIS chunk's host read (its tokens were just
            # read); the span starts at the previous boundary, which under
            # double buffering is this chunk's wall window
            self.obs.step(
                "decode_chunk",
                width=self.scheduler.max_batch * self.cfg.decode_chunk,
                live=len(live), kv_utilization=self.pool.utilization,
                queue_depth=self._queue_depth(),
            )
        clean = True
        for seq in live:
            if self.scheduler.slots[seq.slot] is not seq:
                clean = False
                continue
            lim = int(limits[seq.slot])
            emitted = 0
            for s in range(lim):
                seq.fed += 1
                emitted += 1
                self._emit(seq, int(toks[s, seq.slot]))
                if seq.done:
                    break
            self.stats.tokens_useful += emitted
            if seq.done or emitted < lim:
                clean = False
        return clean

    def _can_pipeline(self) -> bool:
        """Double buffering is sound only while the scheduler has no other
        work: an admission or prefill would change the live set in flight,
        and a preemption would free blocks the device is still writing."""
        sched = self.scheduler
        # with spec_k a chunk is only the no-draft fallback: control returns
        # to the scheduler after every chunk so drafting lanes verify again
        return (
            self.cfg.double_buffer
            and not self.cfg.spec_k
            and not sched.waiting
            and not sched.preempted
            and not any(s.needs_prefill for s in sched.running())
        )

    def _run_decode_chunk(self, seqs: List[SequenceState]) -> None:
        """One decode action in chunked mode: K device steps per host read,
        and — while the scheduler has no other work — chunk N+1 launched
        (chained on the device tensors of chunk N's last step) before chunk
        N's tokens are read.  Blocks for the next chunk must be reserved
        without preemption: a victim's blocks could be reallocated while
        the chunk in flight still writes them."""
        t0 = time.perf_counter()
        K = self.cfg.decode_chunk
        live = self._live_reserved(seqs, lambda s: self._chunk_limit(s, K))
        if not live:
            return
        B = self.scheduler.max_batch
        tok = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        stop1 = np.full((B,), -1, np.int32)
        limits = np.zeros((B,), np.int32)
        for seq in live:
            tok[seq.slot] = seq.next_tok
            pos[seq.slot] = seq.fed
            stop1[seq.slot] = self._stop1(seq)
            limits[seq.slot] = self._chunk_limit(seq, K)
        step = self._steps["decode_chunk"]
        # chunk N+1 starts from chunk N's final token and position: the
        # step's own outputs, copied into its inputs on the device
        carry = dict(tok=tok, pos=pos, stop_tok=stop1)
        tables = self._sync_tables(live)
        pending = None  # (limits, tokens being copied to the host)
        while True:
            toks_d, tok_d, pos_d = step.run(tables=tables, limit=limits, **carry)
            carry = dict(tok=tok_d, pos=pos_d)
            self.stats.decode_steps += K
            # useful tokens are credited at drain time (a lane frozen
            # mid-chunk reports its remaining steps as padding)
            self.stats.observe_dispatch(B * K, 0)
            read = self._read_async(toks_d)
            clean = True
            if pending is not None:
                prev_limits, prev_read = pending
                # THE chunk-boundary read, overlapping the chunk just launched
                clean = self._drain_tokens(live, prev_limits, self._wait(prev_read))
            pending = (limits, read)
            if not (clean and self._can_pipeline()):
                break
            # next chunk's limits assuming full emission of this one
            nxt = np.zeros((B,), np.int32)
            for seq in live:
                nxt[seq.slot] = self._chunk_limit(
                    seq, K, ahead=int(limits[seq.slot])
                )
            if not nxt.any():
                break
            ok = True
            for seq in live:
                ok = ok and self.scheduler.try_reserve(
                    seq, int(limits[seq.slot]) + int(nxt[seq.slot])
                )
            if not ok:
                break  # pool too tight to reserve without preemption
            limits = nxt
            tables = self._sync_tables(live)
        prev_limits, prev_read = pending
        self._drain_tokens(live, prev_limits, self._wait(prev_read))
        self.stats.decode_s += time.perf_counter() - t0

    # -- speculative decode (ragged verify over the paged pool) ---------------

    def _draft_ready(self, seq: SequenceState) -> bool:
        """May this lane use the model drafter this round?  Its draft KV
        must trail by a gap the (K+2)-wide catch-up absorbs, and the draft
        pool must cover every scan write (positions through fed + K + 1).
        A lane past the absorbable gap goes stale for good and keeps the
        n-gram drafter (the JAX engine's rule)."""
        if self.draft_gen is None or seq.draft_stale:
            return False
        gap = seq.fed - seq.draft_fed
        if not 0 <= gap <= self.cfg.spec_k + 1:
            seq.draft_stale = True
            return False
        return self._ensure_draft_blocks(seq, seq.fed + self.cfg.spec_k + 2)

    def _draft_scan(self, toks_in, tables, pos0, n_in, K: int) -> torch.Tensor:
        """K greedy draft tokens per lane (the JAX `_draft_scan_fn`): one
        ragged catch-up forward over the lane's last `n_in` undrafted tokens
        (pending token included), then K-1 single-token steps feeding each
        proposal back.  Greedy drafts keep `p_draft` one-hot, as
        `speculative_verify` assumes.  Rows with n_in = 0 are dead lanes;
        their zero table rows send every write to the draft trash block.
        Returns (B, K) int32 on the device."""
        logits = self._draft_forward(toks_in, pos0, tables)  # (B, F, V)
        rows = torch.arange(logits.shape[0], device=logits.device)
        tok = torch.argmax(logits[rows, (n_in - 1).clamp(min=0).long()], dim=-1)
        drafts = [tok]
        pos = pos0 + n_in.clamp(min=1)
        for _ in range(K - 1):
            tok = torch.argmax(self._draft_forward(tok[:, None], pos, tables)[:, -1], dim=-1)
            drafts.append(tok)
            pos = pos + 1
        return torch.stack(drafts, dim=1).to(torch.int32)

    def _run_draft_scan(self, seqs: List[SequenceState], K: int):
        """One draft scan proposing K tokens for each of `seqs`; costs one
        host read, paid only on rounds where some lane uses the model
        drafter."""
        t0 = time.perf_counter()
        B = self.scheduler.max_batch
        F = K + 2
        toks_in = np.zeros((B, F), np.int32)
        pos0 = np.zeros((B,), np.int32)
        n_in = np.zeros((B,), np.int32)
        for seq in seqs:
            # decode-phase invariant: tokens[fed] is the pending token, so
            # the catch-up feed is every token the draft has not seen yet
            feed = seq.tokens[seq.draft_fed : seq.fed + 1]
            toks_in[seq.slot, : len(feed)] = feed
            pos0[seq.slot] = seq.draft_fed
            n_in[seq.slot] = len(feed)
        up = self._upload
        d = self._draft_scan(
            up(toks_in), up(self._sync_draft_tables(seqs)), up(pos0), up(n_in), K
        )
        d = self._wait(self._read_async(d))
        self.stats.host_syncs += 1
        # the scan's F-wide feed plus K-1 single steps; useful credit rides
        # the verify's accepted tokens
        self.stats.observe_dispatch(B * F + B * max(K - 1, 0), 0)
        if self.obs is not None:
            self.obs.step(
                "draft_scan", width=B * F, live=len(seqs), t_start=t0,
                kv_utilization=self.pool.utilization,
                queue_depth=self._queue_depth(), spec_k=K,
            )
        return [(seq, [int(t) for t in d[seq.slot]]) for seq in seqs]

    def _verify(self, toks_in, tables, pos) -> torch.Tensor:
        """Greedy verify: one ragged multi-query forward scoring every
        slot's [pending] + draft at its own depth; the argmax successor at
        every position, (B, K+1) int32."""
        return torch.argmax(self._forward(toks_in, pos, tables), dim=-1).to(torch.int32)

    def _verify_sample(self, toks_in, tables, pos, draft_len):
        """Rejection-sampled verify: the same forward, then the accept /
        resample rule of `speculative_verify` against the distribution the
        per-step sampler draws from.  Returns (out, n_emit)."""
        logits = self._forward(toks_in, pos, tables)
        return speculative_verify(
            logits, toks_in[:, 1:], draft_len, self._rng, self._t_op, self._p_op,
            mode=self._sample_mode, top_k=self.cfg.top_k,
        )

    def _run_spec_decode(self, seqs: List[SequenceState]) -> bool:
        """Batched speculative step: draft up to `spec_k` tokens per slot —
        prompt lookup first (`ngram_draft`), the draft model where it
        misses — score every slot's [pending] + draft in ONE ragged verify
        forward, and emit each slot's accepted prefix and one more token.
        Exact-match verify at temperature 0, rejection-sampled above it
        (`ServingConfig.spec_verify_sampled`).  Returns False when no slot
        drafted: the caller then runs a plain decode turn."""
        K = self.cfg.spec_k
        sampled = self.cfg.spec_verify_sampled()
        candidates = [s for s in seqs if self.scheduler.slots[s.slot] is s]
        drafts: Dict[int, List[int]] = {}
        source: Dict[int, str] = {}
        model_lanes: List[SequenceState] = []
        for seq in candidates:
            # draft only with window room for all K+1 writes and at least 2
            # tokens of budget left, capped at remaining-1 so the
            # reservation never exceeds what admission guaranteed
            room = self.max_seq_length - seq.fed - 1
            remaining = seq.req.max_new_tokens - seq.n_generated
            if room >= K + 1 and remaining >= 2:
                d = ngram_draft(seq.tokens, K)[: remaining - 1]
                if d:
                    drafts[seq.slot] = [int(t) for t in d]
                    source[seq.slot] = "ngram"
                elif self._draft_ready(seq):
                    model_lanes.append(seq)
        if model_lanes:
            for seq, d in self._run_draft_scan(model_lanes, K):
                remaining = seq.req.max_new_tokens - seq.n_generated
                d = d[: remaining - 1]
                if d:
                    drafts[seq.slot] = d
                    source[seq.slot] = "model"
        if not drafts:
            return False
        t0 = time.perf_counter()
        live = self._live_reserved(
            candidates, lambda s: len(drafts.get(s.slot, ())) + 1
        )
        if not live:
            self.stats.decode_s += time.perf_counter() - t0
            return True
        B = self.scheduler.max_batch
        toks_in = np.zeros((B, K + 1), np.int32)
        pos = np.zeros((B,), np.int32)
        dlen = np.zeros((B,), np.int32)
        fed0 = {id(s): s.fed for s in live}
        for seq in live:
            toks_in[seq.slot] = [int(seq.next_tok)] + pad_draft(drafts.get(seq.slot, []), K)
            pos[seq.slot] = seq.fed
            dlen[seq.slot] = len(drafts.get(seq.slot, ()))
        up = self._upload
        args = (up(toks_in), up(self._sync_tables(live)), up(pos))
        if sampled:
            out, n_emit = self._observed("verify_sample", (B, K + 1),
                                         self._verify_sample, *args, up(dlen))
            # tokens and emit counts in one host read
            got = self._wait(self._read_async(torch.cat([out, n_emit[:, None]], dim=1)))
            bursts = {
                seq.slot: [int(t) for t in got[seq.slot, : int(got[seq.slot, -1])]]
                for seq in live
            }
        else:
            g = self._wait(self._read_async(
                self._observed("verify", (B, K + 1), self._verify, *args)))
            # accept only over the real draft length: a 0-padded row must
            # not luck into matching the model's 0-token successor
            bursts = {
                seq.slot: accept_draft(
                    pad_draft(drafts.get(seq.slot, []), K), g[seq.slot],
                    len(drafts.get(seq.slot, ())),
                )
                for seq in live
            }
        self.stats.decode_steps += 1
        self.stats.host_syncs += 1
        if self.obs is not None:
            self.obs.step(
                "verify", width=B * (K + 1), live=len(live), t_start=t0,
                kv_utilization=self.pool.utilization,
                queue_depth=self._queue_depth(), spec_k=K,
                accepted=sum(len(b) - 1 for b in bursts.values()),
            )
        # useful side credited per slot below as len(burst); rejected
        # draft rows are padding
        self.stats.observe_dispatch(B * (K + 1), 0)
        self.stats.observe_kv_utilization(self.pool.utilization)
        self.stats.observe_resident(len(self.scheduler.running()))
        for seq in live:
            d = drafts.get(seq.slot, [])
            burst = bursts[seq.slot]
            src = source.get(seq.slot)
            accepted = len(burst) - 1
            self.stats.spec_drafted += len(d)
            self.stats.spec_accepted += accepted
            if src == "model":
                self.stats.spec_drafted_model += len(d)
                self.stats.spec_accepted_model += accepted
            elif src == "ngram":
                self.stats.spec_drafted_ngram += len(d)
                self.stats.spec_accepted_ngram += accepted
            if self.obs is not None and src is not None:
                self.obs.spec(len(d), accepted, src)
            self.stats.tokens_useful += len(burst)
            for t in burst:
                seq.fed += 1
                self._emit(seq, int(t))
                if seq.done:
                    break
            if src == "model" and not seq.done:
                # the scan wrote draft KV for proposals d_1..d_{K-1}; their
                # accepted prefix is real sequence now, and the next
                # catch-up resumes right after it
                seq.draft_fed = fed0[id(seq)] + 1 + min(accepted, K - 1)
        self.stats.decode_s += time.perf_counter() - t0
        return True

    def prime(self) -> None:
        """Run the speculative forwards once with inert operands: one
        verify (the sampled one when the engine samples), and with a draft
        model one draft scan and one draft mixed step.  Every table row is
        0, so every write lands in a trash block and no live block or
        sequence changes.  The JAX engine compiles its executables here; on
        the card it warms the same kernels and library handles (the step
        graphs were captured when the engine was built)."""
        K = self.cfg.spec_k
        if not K:
            return
        B = self.scheduler.max_batch
        up = self._upload
        tables = up(np.zeros((B, self.max_blocks_per_seq), np.int32))
        toks = up(np.zeros((B, K + 1), np.int32))
        zB = up(np.zeros((B,), np.int32))
        if self.cfg.spec_verify_sampled():
            self._verify_sample(toks, tables, zB, zB)
        else:
            self._verify(toks, tables, zB)
        if self.draft_gen is None:
            return
        dtables = up(np.zeros_like(self._draft_tables))
        self._draft_scan(up(np.zeros((B, K + 2), np.int32)), dtables, zB, zB, K)
        T = self.token_budget
        trash_pos = self.max_blocks_per_seq * self.pool.block_size
        self._draft_mixed_body(
            up(np.zeros((1, T), np.int32)), up(np.full((1, T), trash_pos, np.int32)),
            dtables, up(np.zeros((T,), np.int32)), zB, zB,
        )

    # -- the compile set (analysis/ir.py, analysis/liveness.py) ---------------

    def reachable_signatures(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Every (label, shape-key) `step()` can dispatch for this engine's
        ServingConfig, as the JAX engine's `reachable_signatures`:

        - ``mixed(max_batch, token_budget)`` always;
        - ``verify(max_batch, spec_k + 1)`` with speculative decoding and
          the exact-match verify, ``verify_sample`` at the same shape with
          the rejection-sampled one (`ServingConfig.spec_verify_sampled`);
          a turn where no slot drafts falls through to the decode below, so
          it stays reachable beside it;
        - ``draft_mixed(max_batch, token_budget)`` and
          ``draft_scan(max_batch, spec_k + 2)`` with a draft model;
        - ``decode_chunk(max_batch, decode_chunk)`` when decode_chunk > 1,
          else ``decode(max_batch,)``;
        - ``fetch(W,)`` and ``restore(W,)`` with a host tier, W =
          `swap_chunk_blocks`.

        The captured steps (`_steps`) are the mixed step and the decode;
        the rest launch eagerly at their dispatch sites.  The analysis's
        compile-set-closure rule re-derives this set from the ServingConfig
        alone (`analysis.ir.reachable_serving_set`) and diffs it against
        `enumerate_executables()`."""
        B = self.scheduler.max_batch
        sigs: List[Tuple[str, Tuple[int, ...]]] = [("mixed", (B, self.token_budget))]
        if self.cfg.spec_k:
            label = "verify_sample" if self.cfg.spec_verify_sampled() else "verify"
            sigs.append((label, (B, self.cfg.spec_k + 1)))
            if self.cfg.draft_model:
                sigs.append(("draft_mixed", (B, self.token_budget)))
                sigs.append(("draft_scan", (B, self.cfg.spec_k + 2)))
        if self.cfg.decode_chunk > 1:
            sigs.append(("decode_chunk", (B, self.cfg.decode_chunk)))
        else:
            sigs.append(("decode", (B,)))
        if self.cfg.host_pool_mib > 0:
            W = max(1, self.cfg.swap_chunk_blocks)
            sigs.append(("fetch", (W,)))
            sigs.append(("restore", (W,)))
        return sigs

    def _step_params(self, gen: Generator):
        """The weights as `gen`'s forward reads them: the tree, or on a tp
        mesh {rank: its slices} (views of the tree)."""
        return gen.params if gen._shards is None else gen._shards

    def enumerate_executables(self) -> List[StepSpec]:
        """One `StepSpec` per reachable signature, on a meta twin of this
        engine (`obs.device.abstractify`): the exact body each dispatch site
        calls (a captured step's body over its static inputs' twins, or the
        eager method), the weights, the pool and the sampling operands as
        the args it reads from the owner, the run operands as the args it
        is passed.  Works alike on a live engine (nothing on the card is
        read, written or counted; a CPU engine's twin keeps the plain
        route it runs) and on an abstract one (`Generator(abstract=True)`,
        the card's route); builds the specs, traces nothing.
        The pipelined engine inherits it: its bodies are the ring's."""
        memo: Dict[int, Any] = {}
        twin = abstractify(self, memo)
        if self.device.type == "cpu" and twin.cfg.use_kernel is None:
            twin.cfg.use_kernel = False  # a CPU engine runs K1's plain route
        cls = type(self)
        B, T = self.scheduler.max_batch, self.token_budget
        MB = self.max_blocks_per_seq
        meta = torch.device("meta")

        def sds(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=meta)

        target = abstractify({"params": self._step_params(self.gen), "kv": self._kv,
                              "operands": (self._t_op, self._p_op)}, memo)
        roles = {"params": "params", "kv": "kv"}

        def spec(label, key, body, inputs, static=None, state=target, writes=("kv",)):
            return StepSpec(label, key, body, twin, {**state, **inputs}, static,
                            dict(roles), tuple(state), writes)

        specs: List[StepSpec] = []
        for label, k in self.reachable_signatures():
            if label in self._steps:  # mixed, decode, decode_chunk
                st = self._steps[label]
                specs.append(spec(label, k, st.body, abstractify(st.inputs, memo), st.static))
            elif label == "verify":
                specs.append(spec(label, k, cls._verify, dict(
                    toks_in=sds(B, k[1]), tables=sds(B, MB), pos=sds(B))))
            elif label == "verify_sample":
                specs.append(spec(label, k, cls._verify_sample, dict(
                    toks_in=sds(B, k[1]), tables=sds(B, MB), pos=sds(B), draft_len=sds(B))))
            elif label in ("draft_mixed", "draft_scan"):
                draft = abstractify({"params": self._step_params(self.draft_gen),
                                     "kv": self._draft_kv}, memo)
                if label == "draft_mixed":
                    specs.append(spec(label, k, cls._draft_mixed_body, dict(
                        tokens=sds(1, T), pos=sds(1, T), tables=sds(B, MB), q_slot=sds(T),
                        q_start=sds(B), q_len=sds(B)), state=draft))
                else:
                    specs.append(spec(label, k, cls._draft_scan, dict(
                        toks_in=sds(B, k[1]), tables=sds(B, MB), pos0=sds(B), n_in=sds(B)),
                        static=dict(K=self.cfg.spec_k), state=draft))
            elif label in ("fetch", "restore"):
                # the tier's transfer pair moves pool blocks: the pool only
                W, ba = k[0], self._kv_block_axis
                pool = abstractify({"kv": self._kv}, memo)
                idx = {meta: sds(W, dtype=torch.long)}
                if label == "fetch":
                    specs.append(spec(label, k, cls._gather_blocks, dict(idx_d=idx),
                                      state=pool, writes=()))
                else:
                    rows = [sds(W, *(shape[:ba] + shape[ba + 1:]), dtype=raw_dtype(dt))
                            for shape, dt in self._kv_leaf_shapes()]
                    specs.append(spec(label, k, cls._restore_blocks,
                                      dict(idx_d=idx, rows=rows), state=pool))
        return specs

    def step(self) -> bool:
        """Run one scheduler action; False when nothing was runnable."""
        action = self.scheduler.next_batch(self.token_budget)
        self.stats.queue_depth_peak = max(
            self.stats.queue_depth_peak, self._queue_depth()
        )
        if action is None:
            return False
        if action[0] == "mixed":
            self._run_mixed(action[1])
        elif self.cfg.spec_k and self._run_spec_decode(action[1]):
            pass  # the speculative verify served this decode turn
        elif self.cfg.decode_chunk > 1:
            self._run_decode_chunk(action[1])
        else:
            self._run_decode(action[1])
        # host tier: this step's preemptions and spills queued gathers; their
        # copies completed behind the step, whose own read already waited
        self._drain_swaps()
        return True

    def run(self, stream_cb=None,
            step_hook=None) -> Tuple[Dict[str, List[int]], ServingStats]:
        """Drive the loop until every queued request finishes.  Returns
        {rid: prompt + generation (stop-trimmed)} and the stats;
        `stream_cb(rid, token)` fires per generated token, `step_hook(i)`
        after the i-th engine step (1-based): `cli.serve --xprof-steps`
        hangs its profiler window there, the open-system server its
        admissions (`server/frontend.py`)."""
        self._stream_cb = stream_cb
        t0 = time.perf_counter()
        n_steps = 0
        if self.obs is not None:
            self.obs.attach_compile_hook()
        try:
            while self.scheduler.has_work:
                if not self.step():
                    break
                if step_hook is not None:
                    n_steps += 1
                    step_hook(n_steps)
        finally:
            self.stats.preemptions = self.scheduler.preemptions
            self.stats.prefix_cache_hits = self.pool.prefix_hits
            if self.host_tier is not None:
                self._drain_swaps()  # park in-flight snapshots in the slabs
                tier = self.host_tier
                self.stats.swaps_out = tier.swaps_out
                self.stats.swaps_in = tier.swaps_in
                self.stats.swap_out_bytes = tier.swap_out_bytes
                self.stats.swap_in_bytes = tier.swap_in_bytes
                self.stats.prefix_hits_host = self.pool.prefix_hits_host
            self.stats.wall_s += time.perf_counter() - t0
            self._stream_cb = None
            if self.obs is not None:
                self._publish_run_end()
        return dict(self._results), self.stats

    def _publish_run_end(self) -> None:
        """The JAX engine's run epilogue: detach the captures hook, publish
        every report cached on the Generator for this pool dtype (a fresh
        observer on a warm model gets them without measuring), the prefix
        hit counter and the pool gauges."""
        obs = self.obs
        obs.detach_compile_hook()
        for (_l, _k, variant), rep in self.gen._exec_reports.items():
            if variant == self.kv_dtype_name:
                obs.publish_device_report(rep)
        hits = obs.metrics.counter(
            "serving_prefix_hit_blocks_total", "pool blocks reused copy-free",
        )
        if self.pool.prefix_hits > hits.value:  # observer may be shared
            hits.set_to(self.pool.prefix_hits)
        for k, v in self.pool.snapshot().items():
            obs.metrics.gauge(f"serving_kv_pool_{k}", f"KVPool.{k} at run end").set(v)
