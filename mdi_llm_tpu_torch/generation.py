"""Generation: sequential generation and the serving engine's model handle.

Port of `mdi_llm_tpu/generation.py`, on one device or on a tp/dp mesh:

- `Generator.generate`: pow2 prompt buckets, a dense KV cache sized to
  the run, one prefill (a shared-prompt batch prefills one lane and
  broadcasts it), decode in chunks of `chunk_size` steps with one host
  read per chunk, batch compaction of early-stopped lanes (floor of 4
  lanes), and greedy n-gram speculative decoding for one prompt.
- `generate_chat` and `ChatSession`: single-sample token streams with
  stop-prefix hold-back; the session keeps its cache across turns and
  prefills only each new turn at its offset.
- `Generator.serve`: the paged-KV serving engine (`serving/engine.py`);
  on a pipeline mesh (`Generator(mesh=parallel.mesh.pipeline_mesh(S,
  devices))`, S >= 2) the engine over the stage ring
  (`serving/pipeline.py`).  The other paths run on stage 0's device.
- `Generator(mesh=parallel.mesh.make_mesh({"dp": D, "tp": N}, devices))`:
  the weights split under the Megatron rules (`parallel/sharding.py`),
  each position's slice on its device (one device entry: every position
  on it, as one card runs tp = 2 or 4).  Every forward is
  `transformer.sharded_forward` over each dp replica's tp ranks, on its
  rows of the batch; the dense cache splits its groups over tp and its
  rows over dp, the serving pool its groups over tp.  A batch dp does
  not divide, streaming under dp, and serving under dp, ep or sp are
  refused with the JAX package's messages; batch compaction and the
  shared-prompt prefill stay off on a mesh, as there.  The decode chunk
  stays a CUDA graph when every position is on one card.
- `Generator(mesh=make_mesh({"ep": N}, devices), moe_capacity_factor=...)`
  on an MoE config: every MoE layer dispatches its tokens to the experts
  of N ranks (`parallel.expert.ep_moe_forward`; the ranks' expert slices
  `place_ep`'s views of the one tree); attention and every other leaf
  run whole, once per device, and the decode chunk stays a CUDA graph
  when the ranks share one card.  A dense config on an ep mesh runs as
  without one.  Over the processes of a job (`make_mesh({"ep": N},
  [device], process_id, num_processes)`) each process keeps only its
  ranks' experts, the dispatch and the return cross processes in one
  all-to-all each, and the combined tokens are all-gathered, so every
  process runs the replicated layers on the whole batch and draws the
  same tokens.  Serving refuses ep, as the JAX engine does; ep beside
  another axis is ROADMAP item 20.
- `Generator(quantize="int8" | "w8a8" | "int4")`: the linears and an
  untied head quantized once, on the device (`ops/quant.py`); a tree
  that is quantized already (a `prepare_model --quantize` checkpoint) is
  recognised by its leaves.  The caches take the float weights' dtype.

`generate`'s decode chunk, the JAX package's `_decode_chunk_fn(B, K)`, is
a `StepGraph` (`utils/step_graph.py`) per (B, cache_len, n_steps, mode,
top_k): on the card a CUDA graph captured at its first run and replayed,
over a dense KV cache kept per (B, cache_len) on the Generator and zeroed
at the start of every call (the JAX package starts each call from fresh
zeros and donates the cache to each step).  The caches and graphs of one
cache length are kept between calls, so a second call with the same
shapes captures nothing.  The other jitted executables (`_prefill_fn(B,
T)`, `_verify_fn(T)`, `_prefill_at_fn(T)`, `_grow_kv_fn(S)`) become plain
methods that launch eagerly (`_prefill`, `_verify`, `_prefill_at`,
`_grow_kv`), as do the one-step decodes of `ChatSession` and the n-gram
speculative path (`_decode_chunk`); the cache is updated in place where
the JAX package donates it.  A prefill whose bucket reaches
`flash_min_len` runs its attention through kernel K2 (`ops/flash.py`) when
`use_flash` is on — by default on a CUDA device.
The random draws come from one `torch.Generator` seeded with `rng_seed`:
sampled streams follow the JAX package's distribution, not its draws;
greedy streams are the same token for token.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdi_llm_tpu_torch.config import TEMPERATURE, TOP_K, Config
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.ops.flash import KERNEL_HEAD_SIZES
from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params, tree_has_quantized
from mdi_llm_tpu_torch.ops.sampling import (
    operand_values,
    sample,
    sample_mode,
    sample_traced,
    sampling_operands,
)
from mdi_llm_tpu_torch.parallel.mesh import PIPE_AXES, Mesh, make_mesh, pipe_axis, stage_ranks
from mdi_llm_tpu_torch.utils.context_managers import catch_loop_errors
from mdi_llm_tpu_torch.utils.step_graph import StepGraph, summarize


def rng_for(device: torch.device, seed: int) -> torch.Generator:
    """The sampling generator of a model or engine on `device`, seeded: on
    the meta device (a traced step) a CPU one, since meta has none, and
    `torch.multinomial` on meta tensors takes it."""
    where = "cpu" if device.type == "meta" else device
    return torch.Generator(device=where).manual_seed(int(seed))


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, "cuda" when None.  A CUDA device on a
    machine without one raises: the port never falls back to the CPU by
    itself — pass device="cpu" (or --device cpu) to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mdi_llm_tpu_torch runs on the GPU by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Stop-token and drafting helpers (host-side)
# ---------------------------------------------------------------------------


def detect_stop_tokens(tokens: Sequence[int], stop_sequences: Sequence[Sequence[int]]) -> bool:
    """True if `tokens` ends with any of the stop sequences."""
    for seq in stop_sequences:
        n = len(seq)
        if n and len(tokens) >= n and list(tokens[-n:]) == list(seq):
            return True
    return False


def find_eot(tokens: Sequence[int], stop_sequences: Sequence[Sequence[int]]) -> int:
    """Index of the first stop-sequence start in `tokens` (len(tokens) if
    none): where a finished stream is cut."""
    tokens = list(tokens)
    best = len(tokens)
    for seq in stop_sequences:
        n = len(seq)
        if not n:
            continue
        for i in range(len(tokens) - n + 1):
            if tokens[i : i + n] == list(seq):
                best = min(best, i)
                break
    return best


class StopPrefixFilter:
    """Streaming stop-sequence suppression: tokens are pushed as sampled;
    all but the trailing max_stop-1 (a potential stop-sequence prefix) are
    released to `emit`, and once a full stop sequence appears the stream
    ends without ever emitting any part of the marker."""

    def __init__(self, stop_sequences: Sequence[Sequence[int]], emit):
        self.stop_sequences = stop_sequences
        self.emit = emit
        self.hold = max(0, max((len(s) for s in stop_sequences), default=0) - 1)
        self.seen: List[int] = []
        self.emitted = 0
        self.stopped = False

    def push(self, tok: int) -> None:
        if self.stopped:
            return
        self.seen.append(tok)
        if detect_stop_tokens(self.seen, self.stop_sequences):
            # a shorter stop sequence may fire while longer-prefix tokens
            # are still held back; release everything before the stop start
            # so the stream matches the find_eot-trimmed result exactly
            cut = find_eot(self.seen, self.stop_sequences)
            while self.emitted < cut:
                self.emit(self.seen[self.emitted])
                self.emitted += 1
            self.stopped = True
            return
        while self.emitted < len(self.seen) - self.hold:
            self.emit(self.seen[self.emitted])
            self.emitted += 1

    def flush(self) -> None:
        """End of stream without a stop: release the held-back tail."""
        if self.stopped:
            return
        while self.emitted < len(self.seen):
            self.emit(self.seen[self.emitted])
            self.emitted += 1


def stop_filtered_stream(raw_stream, stop_sequences):
    """Wrap a raw sampled-token iterator with StopPrefixFilter semantics:
    yield tokens as they clear the hold-back window, end at a stop without
    ever emitting any part of the marker, flush the tail at exhaustion."""
    ready: List[int] = []
    filt = StopPrefixFilter(stop_sequences, ready.append)
    for t in raw_stream:
        filt.push(t)
        yield from ready
        ready.clear()
        if filt.stopped:
            return
    filt.flush()
    yield from ready


class StreamPrinter:
    """Incremental console printer for a token stream (the chat CLI's):
    stop-prefix hold-back (StopPrefixFilter) plus incremental re-decode,
    so multi-byte and merged tokens print correctly — text is written only
    once the decoded reply extends what was printed.

    `push(tok)` feeds the filtered live stream; `emit(tok)` bypasses the
    filter (for sources that already filtered, e.g. generate_chat);
    `finish(final_tokens)` reconciles with the authoritative trimmed
    output — emitting any held-back or missed tail — and returns the
    printed token list."""

    def __init__(self, tokenizer, stop_sequences: Sequence[Sequence[int]], out=None):
        import sys

        self.tokenizer = tokenizer
        self.out = out or sys.stdout
        self.reply: List[int] = []
        self.printed = ""
        self.filter = StopPrefixFilter(stop_sequences, self.emit)

    def emit(self, tok: int) -> None:
        self.reply.append(tok)
        text = self.tokenizer.decode(np.asarray(self.reply))
        if text.startswith(self.printed):
            self.out.write(text[len(self.printed) :])
            self.out.flush()
            self.printed = text

    def push(self, tok: int) -> None:
        self.filter.push(tok)

    def finish(self, final_tokens: Sequence[int]) -> List[int]:
        for tok in list(final_tokens)[len(self.reply) :]:
            self.emit(tok)
        return self.reply


def ngram_draft(tokens: Sequence[int], k: int, ngram: int = 3) -> List[int]:
    """Prompt-lookup drafting for speculative decoding: find the most recent
    earlier occurrence of the trailing `ngram` tokens and propose the k
    tokens that followed it."""
    tokens = list(tokens)
    if len(tokens) <= ngram:
        return []
    tail = tokens[-ngram:]
    for start in range(len(tokens) - ngram - 1, -1, -1):
        if tokens[start : start + ngram] == tail:
            return tokens[start + ngram : start + ngram + k]
    return []


def pad_draft(draft, K: int) -> List[int]:
    """Pad/trim an n-gram draft to exactly K tokens (0-padding; padded
    positions can only be rejected)."""
    return (list(draft) + [0] * K)[:K]


def accept_draft(draft, g, K: int) -> List[int]:
    """Longest-accepted-prefix rule: `g[i]` is the greedy successor of
    ([tok]+draft)[i]; accept while the draft agrees, return the accepted
    tokens plus the bonus successor."""
    a = 0
    while a < K and draft[a] == int(g[a]):
        a += 1
    return [int(x) for x in g[: a + 1]]


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _cache_bucket(n: int, granularity: int = 256) -> int:
    """KV-cache length bucket: decode attention reads the whole cache
    buffer every step, so it is sized to the run (prompt + max_new rounded
    up), not to max_seq_length."""
    return max(granularity, -(-n // granularity) * granularity)


def _run_cache_len(max_seq_length: int, total_max: int, Tb: int) -> int:
    """Cache length for one run: covers the generation horizon AND the
    padded prompt bucket (prefill writes the whole Tb-wide chunk), capped at
    the engine maximum.  Callers must clamp Tb <= max_seq_length."""
    return min(max_seq_length, _cache_bucket(max(total_max, Tb)))


@dataclass
class GenerationStats:
    tok_time: List[Tuple[int, float]] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_generated: int = 0
    # pipeline engine: full ring rotations executed (scheduling efficiency)
    rotations: int = 0
    # pipeline engine: lanes refilled token by token (partial-slot refills)
    token_fills: int = 0
    # batch compactions performed (early-stop lane reclaim)
    compactions: int = 0
    # True when the decode loop ended on Ctrl-C (partial output)
    interrupted: bool = False
    # decode-chunk graphs this call captured, and the seconds that took
    # (inside decode_s)
    captures: int = 0
    capture_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.decode_s if self.decode_s else 0.0


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"Generator({what}) is not ported to mdi_llm_tpu_torch yet "
        "(see ROADMAP.md Queue 1)"
    )


def _check_inference_mesh(mesh: Mesh) -> None:
    """A `make_mesh` mesh the Generator runs: `tp`, `dp`, `sp`, `ep` and a
    pipeline axis (`pp` or `pipe`; any axis of size 1 is harmless).  An sp
    axis is replicated, as the JAX Generator (which reads only tp, dp and
    ep) leaves it: the sequence splits over sp in
    `parallel.sp_inference.SPGenerator`.  An ep axis splits an MoE config's
    experts (`parallel/expert.py`), alone or beside tp, dp and a
    replicated sp; not beside a pipeline axis, whose staged engines run
    the dense MoE layers.  A mesh over processes (`sample --coordinator`,
    or `make_mesh(..., process_id, num_processes)` through the API)
    splits its tp and ep axes: each process holds a contiguous block of
    positions (`Mesh.owned`) with whole dp replicas, so a part of each
    replica's tp group, a range of the ep ranks with their experts, or
    both (`{"ep": 2, "tp": 2}` over two processes: one ep rank with its
    tp group each; `{"tp": 2, "ep": 2}`: one tp rank with every expert
    each; `{"ep": 2, "dp": 2[, "tp": 2]}`: one ep rank with every
    replica each); or its sp axis (`SPGenerator`)."""
    for axis, size in mesh.shape.items():
        if size <= 1 or axis in ("tp", "dp", "sp", "ep") + PIPE_AXES:
            continue
        raise ValueError(f"mesh axis {axis!r} (size {size}): the Generator "
                         "runs tp, dp, sp, ep and pipeline axes")
    pa = pipe_axis(mesh)
    if mesh.shape.get("ep", 1) > 1 and pa and mesh.shape[pa] > 1:
        raise ValueError(f"mesh {mesh.shape}: an ep axis runs beside tp, dp and sp, not "
                         "beside a pipeline axis (its stages run the dense MoE layers)")
    if mesh.num_processes > 1:
        if mesh.shape.get("dp", 1) > 1 and len(mesh.held("dp")) < mesh.shape["dp"] or (
                pa and mesh.shape[pa] > 1):
            raise ValueError(
                f"mesh {mesh.shape} over {mesh.num_processes} processes: a Generator's "
                "processes split the tp and ep axes only, each holding whole dp replicas "
                "(the ring over processes is parallel.pipeline.PipelineEngine(ring=...), "
                "`sample --coordinator --pipeline-stages`)")


def _without(mesh: Mesh, axis: str) -> Mesh:
    """`mesh` with `axis` dropped (the positions at its coordinate 0): the
    Generator replicates over sp, and runs an ep axis beside the mesh."""
    i = mesh.axis_names.index(axis)
    names = mesh.axis_names[:i] + mesh.axis_names[i + 1:]
    devices = np.take(mesh.devices, [0], axis=i)
    return Mesh(devices.reshape([n for a, n in mesh.shape.items() if a != axis] or [1]),
                names or ("tp",), mesh.process_id, mesh.num_processes)


def _process_group(mesh: Mesh, axis: str):
    """This process's `CommGroup` over the processes that split `axis`
    (`Mesh.process_groups`), None when it holds the whole axis.  Every
    process builds every such group, in one order."""
    from mdi_llm_tpu_torch.parallel.collectives import CommGroup

    mine = None
    for ranks in mesh.process_groups(axis):
        group = CommGroup(ranks)
        if mesh.process_id in ranks:
            mine = group
    return mine


def _tp_part(full: Mesh, mesh: Mesh, group) -> Mesh:
    """The tp/dp `mesh` (`full` without its sp and ep axes) as this
    process holds it: over the processes of its tp `group` (one process,
    holding every position, without one), its positions a contiguous
    block (`Mesh.owned`), checked against those it holds of `full`."""
    mesh = Mesh(mesh.devices, mesh.axis_names,
                *((0, 1) if group is None else (group.index, group.size)))
    names = [a for a in mesh.axis_names if a in full.shape]
    want = sorted({tuple(c.get(a, 0) for a in names)
                   for i, c in enumerate(full.positions()) if i in full.owned()})
    coords = list(mesh.positions())
    got = sorted(tuple(coords[i].get(a, 0) for a in names) for i in mesh.owned())
    if names and got != want:
        raise ValueError(
            f"process {full.process_id} of {full.num_processes} holds the {names} "
            f"coordinates {want} of mesh {full.shape}: not a contiguous part of one tp "
            "group (order the mesh's axes so that each process holds whole dp replicas)")
    return mesh


def _pipeline_mesh(mesh, device) -> Dict[int, torch.device]:
    """`mesh` as {stage: device}, stages 0..S-1: the dict
    `parallel.mesh.pipeline_mesh` returns; `device`, when given, must be
    stage 0's.  Any other dict is refused: a tp, dp or pipe x tp mesh is
    a `parallel.mesh.make_mesh` Mesh, as in the JAX package."""
    if not (isinstance(mesh, dict) and mesh and set(mesh) == set(range(len(mesh)))):
        raise TypeError(
            f"mesh={mesh!r}: pass the {{stage: device}} dict of "
            "parallel.mesh.pipeline_mesh or a parallel.mesh.make_mesh Mesh "
            "(tp, dp and pipeline axes)")
    stages = {s: resolve_device(d) for s, d in mesh.items()}
    if device is not None and torch.device(device) != stages[0]:
        raise ValueError(f"device={device!r} is not stage 0's device {stages[0]}: "
                         "a Generator on a pipeline mesh runs on stage 0's device")
    return stages


class Generator:
    """One model on one device: config, parameters (the layer-stacked tree
    of `transformer.init_params`), context window, KV dtype, rope tables,
    the sampling generator and the flash routing of prefills."""

    def __init__(
        self,
        cfg: Config,
        params: Any,
        max_seq_length: Optional[int] = None,
        cache_dtype: Optional[torch.dtype] = None,  # None → params dtype
        rng_seed: int = 1337,
        use_flash: Optional[bool] = None,  # None → on for a CUDA device
        flash_min_len: int = 2048,  # engage flash at prompt buckets >= this
        device=None,  # None → "cuda"
        flash_kernel: Optional[bool] = None,  # None → K2 on a CUDA device,
        # its plain version on the CPU; False → the plain version anywhere
        quantize: Optional[str] = None,  # None | "none" | "int8" (weight-only)
        # | "w8a8" (int8 activations too) | "int4" (ops/quant.py)
        mesh: Any = None,  # {stage: device} of parallel.mesh.pipeline_mesh,
        # or a parallel.mesh.make_mesh Mesh of tp, dp, sp (replicated), ep
        # and pipeline axes
        moe_capacity_factor: Optional[float] = None,  # ep mesh: None → exact
        # dispatch (no dropped assignments); a finite factor bounds the
        # dispatch buffers at the cost of Switch-style drops
        scan_unroll: int = 1,
        abstract: bool = False,
        _graphs: Optional[bool] = None,  # None → CUDA graphs on the card;
        # False launches the step bodies eagerly (comparisons on the card)
    ):
        if quantize not in (None, "none") and quantize not in FLAG_TO_MODE:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        tp_mesh = None
        # {stage: [its tp ranks' devices]} on a pipeline mesh of S >= 2
        # stages (the staged serving engine's layout), else None
        self.stage_ranks = None
        ep_mesh = None
        # over processes: the processes that split the tp axis and the ep
        # axis with this one (each None where it holds the whole axis)
        tp_group = ep_group = None
        self._procs = isinstance(mesh, Mesh) and mesh.num_processes > 1
        if isinstance(mesh, Mesh):
            _check_inference_mesh(mesh)
            full = mesh
            if mesh.shape.get("ep", 1) > 1:
                ep_mesh = mesh
            if self._procs:
                tp_group, ep_group = (_process_group(mesh, a) for a in ("tp", "ep"))
            for axis in ("sp", "ep"):
                if isinstance(mesh, Mesh) and axis in mesh.shape:
                    mesh = _without(mesh, axis)
                    if mesh.size == 1:  # sp or ep alone: the replica on one device
                        device = mesh.devices.flat[0] if device is None else device
                        mesh = None
            if isinstance(mesh, Mesh) and self._procs:
                mesh = _tp_part(full, mesh, tp_group)
        if isinstance(mesh, Mesh):
            pa = pipe_axis(mesh)
            if pa is not None and mesh.shape[pa] > 1:
                # the staged engine runs the stages; generate() runs, as
                # the JAX Generator's replicated pipeline axis does, over
                # stage 0's tp ranks
                self.stage_ranks = stage_ranks(mesh)
                devs0 = self.stage_ranks[0]
                if len(devs0) > 1:
                    tp_mesh = make_mesh({"tp": len(devs0)}, devs0)
                mesh = {s: devs[0] for s, devs in self.stage_ranks.items()}
            else:
                tp_mesh = mesh
        if tp_mesh is not None:
            first = resolve_device(tp_mesh.devices.flat[tp_mesh.owned()[0]])
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device={device!r} is not the mesh's first device "
                                 f"{first}: a Generator on a mesh runs there")
            device = first
        if isinstance(mesh, dict):
            mesh = _pipeline_mesh(mesh, device)
            device = mesh[0]
            if self.stage_ranks is None:
                self.stage_ranks = {s: [d] for s, d in mesh.items()}
        else:
            mesh = tp_mesh
        if scan_unroll != 1:
            _refuse(f"scan_unroll={scan_unroll}: the layers run as a Python loop")
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        # trace-only construction (analysis/ir.py): every tensor on the meta
        # device (the parameters from `analysis.plan.abstract_params`),
        # nothing allocated on a card; the steps then take the card's route
        # (K1, K2) and can only be traced
        self.abstract = bool(abstract)
        if self.abstract and device is None:
            device = "meta"
        self.device = resolve_device(device)
        if self.abstract and self.device.type != "meta":
            raise ValueError(f"abstract=True runs on the meta device, not {self.device}")
        params = transformer.tree_map(lambda x: x.to(self.device), params)
        if quantize in FLAG_TO_MODE:
            # quantized leaf by leaf on the device, where the tree stays
            params = quantize_params(params, mode=FLAG_TO_MODE[quantize])
        self.params = params
        # structural: a pre-quantized checkpoint loads with quantize=None
        self.quantized = tree_has_quantized(params)
        dispatch = ep_mesh is not None and cfg.mlp_class_name == "LLaMAMoE"
        # the JAX `_place_ep_quantized`: a quantized tree's experts split over
        # ep and every other leaf whole, so the tp and dp axes replicate
        whole = dispatch and self.quantized and tp_mesh is not None
        self._init_mesh(None if whole else tp_mesh, dispatch, tp_group)
        if whole:  # the batch still divides over dp, as there
            self.dp = int(tp_mesh.shape.get("dp", 1))
        self._init_ep(ep_mesh, moe_capacity_factor, ep_group)
        if cache_dtype is None:  # the float weights' dtype, never a scale's
            cache_dtype = transformer.param_dtype(self.params)
        self.cache_dtype = cache_dtype
        self.max_seq_length = int(
            min(max_seq_length or cfg.block_size, cfg.block_size)
        )
        self.rope = transformer.get_rope_cache(cfg, device=self.device)
        if self._shards is not None:
            self._ropes = {i: self.rope if d == self.device
                           else transformer.get_rope_cache(cfg, device=d)
                           for i, d in self._devices.items()}
        self.rng_seed = int(rng_seed)
        self.rng = rng_for(self.device, self.rng_seed)
        # the card's route on the card and on meta (a traced step)
        self.use_flash = self.device.type != "cpu" if use_flash is None else bool(use_flash)
        # the crossover on the card is measured by chip_smoke.py (PERF.md)
        self.flash_min_len = int(flash_min_len)
        self.flash_kernel = flash_kernel
        kernel_route = self.device.type != "cpu" and flash_kernel is not False
        if self.use_flash and kernel_route and cfg.head_size not in KERNEL_HEAD_SIZES:
            raise ValueError(
                f"{cfg.name}: head size {cfg.head_size} is not one kernel K2 "
                f"is built for {KERNEL_HEAD_SIZES}; pass use_flash=False"
            )
        one_card = not self._procs and (
            self._shards is None or len(set(self._devices.values())) == 1) and (
            ep_mesh is None or {str(d) for d in ep_mesh.device_list()} == {str(self.device)})
        if _graphs and not one_card:
            raise ValueError("the decode chunk is captured only when every rank "
                             "of the mesh runs on one device, in one process")
        self._graphs = (self.device.type == "cuda" and one_card
                        if _graphs is None else bool(_graphs))
        # generate's dense caches per (B, cache_len) and decode-chunk steps
        # per (B, cache_len, n_steps, mode, top_k), one cache length at a time
        self._caches: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._steps: Dict[tuple, StepGraph] = {}
        # step reports (obs/device.py), keyed (label, shape key, pool dtype)
        # and shared across the engines of this Generator, so each step is
        # measured once, when its first engine is built
        self._exec_reports: Dict[Any, Any] = {}
        # generate()'s reports: attach_device_obs() sets a
        # DeviceReportRegistry; its prefill and decode-chunk steps are
        # measured into it at their first run per shape
        self.device_obs = None

    def _init_mesh(self, mesh: Optional[Mesh], dispatch: bool = False, group=None) -> None:
        """Lay the weights over a tp/dp mesh (`parallel/sharding.py`): each
        position's slice of every leaf on its device, and per dp replica its
        positions in tp order.  Without a mesh, every field is None.  With
        `dispatch` (an ep axis beside the mesh) the positions' trees leave
        out the MoE layers' router and experts: the dispatch runs them from
        the one tree, split over ep and whole over tp and dp, as the JAX
        `param_specs(ep_axis="ep")` lays them.  Over processes `mesh` holds
        this process's positions (`Mesh.owned`) and `group` the processes
        holding the other parts of its tp groups (`_group`)."""
        self._tp_mesh = mesh
        self._shards = self._replicas = self._devices = self._group = None
        self.tp = self.dp = 1
        if mesh is None:
            return
        from mdi_llm_tpu_torch.parallel.sharding import (
            regroup_w4_row_scales,
            shard_params,
            validate_tp_divisibility,
        )

        self.tp, self.dp = int(mesh.shape.get("tp", 1)), int(mesh.shape.get("dp", 1))
        # vocab counts here: the Generator splits the embedding and head
        validate_tp_divisibility(self.cfg, self.tp, check_vocab=True)
        tree = self.params
        if dispatch:
            tree = {**tree, "blocks": {k: v for k, v in tree["blocks"].items() if k != "mlp"}}
        self._shards = shard_params(tree, self.cfg, mesh, "tp" if self.tp > 1 else None)
        regroup_w4_row_scales(self.params, self._shards, mesh)
        owned = set(mesh.owned())
        self._shards = {i: t for i, t in self._shards.items() if i in owned}
        coords = list(mesh.positions())
        self._devices = {i: resolve_device(d) for i, d in enumerate(mesh.device_list())
                         if i in owned}
        self._replicas = [
            sorted((i for i, c in enumerate(coords) if c.get("dp", 0) == d and i in owned),
                   key=lambda i: coords[i].get("tp", 0))
            for d in range(self.dp)
        ]
        if mesh.num_processes > 1:
            # every process holds a contiguous part of its replicas' tp
            # group (`_check_inference_mesh`): their partial sums meet in
            # the group's collectives, and each samples the same tokens
            # from the same gathered logits, its generator seeded alike
            self._group = group

    def _init_ep(self, mesh: Optional[Mesh], capacity_factor: Optional[float],
                 group=None) -> None:
        """On an ep mesh, an MoE config's experts run the token dispatch
        (`parallel.expert.ep_moe_forward`, `_moe_impl`) over the ranks'
        expert slices, views of the one tree whose layout `place_ep`
        checks here, and the whole batch's tokens split over the ep ranks
        (over dp x ep replicas too, as the JAX Generator's dispatch, which
        names no dp axis, routes them); attention and every other leaf run
        whole, once per device, or over the tp ranks of each dp replica
        (`_init_mesh`, `transformer.replicas_forward`).  A dense config on
        an ep mesh runs as without one, as in the JAX package.  `_ep_mesh`
        keeps the mesh for `serve`'s refusal.  Over processes that split
        the ep axis (`group`, the processes holding its other ranks beside
        the same tp ranks) each process keeps only its ranks' expert
        slices (`params` may hold just those, as `sample --coordinator`
        loads them; a whole tree is cut, copies, so its stacks can go) and
        the exchange and the combined output go through `group`
        (`_ep_group`); a
        process that holds every ep rank (its processes split tp only)
        runs the whole dispatch itself."""
        self._ep_mesh, self._moe_impl, self._ep_group = mesh, None, None
        if mesh is None or self.cfg.mlp_class_name != "LLaMAMoE":
            return
        from functools import partial

        from mdi_llm_tpu_torch.parallel.expert import ep_moe_forward, local_experts, place_ep

        ep = int(mesh.shape["ep"])
        if self.cfg.n_expert % ep:
            raise ValueError(f"ep={ep} does not divide n_expert={self.cfg.n_expert}")
        if mesh.num_processes > 1:
            # a tree drawn or loaded with only this process's experts stays
            self.params = local_experts(self.params, mesh, self.cfg.n_expert)
        else:
            place_ep(self.params, mesh, self.cfg.n_expert)  # refuses a layout it cannot split
        self._ep_group = group
        self._moe_impl = partial(ep_moe_forward, mesh=mesh, capacity_factor=capacity_factor,
                                 group=group)

    def attach_device_obs(self, registry) -> None:
        """Attach an `obs.device.DeviceReportRegistry`: later `generate()`
        calls measure each prefill (B, bucket) and decode chunk (B,
        n_steps) once, at its first run (the decode chunk's warm-up
        before capture, the prefill's real call).  None detaches.  The
        serving engine has its own hook, `ServingObserver(device=True)`."""
        self.device_obs = registry

    def _dev_call(self, label, key, fn, *args):
        """`fn(*args)`, measured as the (label, key) report at its first
        call when a registry that captures is attached."""
        reg = self.device_obs
        if reg is None or not reg.capture_enabled or reg.get(label, key) is not None:
            return fn(*args)
        from mdi_llm_tpu_torch.obs.device import introspect_call

        out, rep = introspect_call(fn, args, label, key)
        reg.add(rep)
        return out

    # -- model steps ---------------------------------------------------------

    def _forward(self, tokens, input_pos, kv, **kw) -> torch.Tensor:
        """The model's logits; the cache in `kv` is updated in place.  On a
        mesh, each dp replica runs `transformer.sharded_forward` over its
        tp ranks on its rows of the batch (`kv` then holds each position's
        cache), and the logits meet on the first device; beside an ep axis
        the replicas run layer by layer, `transformer.replicas_forward`."""
        with torch.no_grad():
            if self._shards is None:
                return transformer.forward(
                    self.cfg, self.params, tokens, input_pos, kv, rope=self.rope,
                    moe_impl=self._moe_impl, **kw
                )
            if self._moe_impl is not None:
                # the MoE layers dispatch every replica's rows at once
                units = [transformer.TPRanks(self.cfg, [self._shards[i] for i in ranks],
                                             self._group) for ranks in self._replicas]
                return transformer.replicas_forward(
                    self.cfg, units, (self._moe_impl, self.params["blocks"]["mlp"]), tokens,
                    input_pos, None if kv is None else [[kv[i] for i in r]
                                                        for r in self._replicas],
                    ropes=[[self._ropes[i] for i in r] for r in self._replicas], **kw,
                ).to(self.device)
            rows = tokens.shape[0] // self.dp
            outs = []
            for d, ranks in enumerate(self._replicas):
                sl = slice(d * rows, (d + 1) * rows)
                outs.append(transformer.sharded_forward(
                    self.cfg, [self._shards[i] for i in ranks], tokens[sl], input_pos[sl],
                    None if kv is None else [kv[i] for i in ranks],
                    ropes=[self._ropes[i] for i in ranks], group=self._group, **kw,
                ).to(self.device))
            return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    def _init_kv(self, B: int, cache_len: int):
        """The dense cache of B rows; on a mesh {position: its replica's
        B/dp rows and its rank's G/tp groups, on its device}."""
        if self._shards is None:
            return transformer.init_kv_cache(
                self.cfg, B, cache_len, dtype=self.cache_dtype, device=self.device
            )
        cfg_r = transformer.shard_config(self.cfg, self.tp)
        return {i: transformer.init_kv_cache(cfg_r, B // self.dp, cache_len,
                                             dtype=self.cache_dtype, device=d)
                for i, d in self._devices.items()}

    def init_paged_kv(self, num_blocks: int, block_size: int, dtype):
        """The serving engine's pool (`transformer.init_paged_kv_cache`); on
        a tp mesh {rank: (L, num_blocks, block_size, G/tp, hs) on its
        device}, with the int8 pool's (L, num_blocks, G/tp) scales."""
        if self._shards is None:
            return transformer.init_paged_kv_cache(
                self.cfg, num_blocks, block_size, dtype=dtype, device=self.device)
        cfg_r = transformer.shard_config(self.cfg, self.tp)
        return {i: transformer.init_paged_kv_cache(cfg_r, num_blocks, block_size,
                                                   dtype=dtype, device=self._devices[i])
                for i in self._replicas[0]}

    def _last_logits(self, logits, true_len) -> torch.Tensor:
        rows = torch.arange(logits.shape[0], device=self.device)
        return logits[rows, self._tensor(true_len) - 1]

    def _prefill(self, batch: np.ndarray, kv, true_len) -> torch.Tensor:
        """A fresh prefill of the (B, Tb) bucket at offset 0 into the empty
        cache; returns the logits at each row's last real token."""
        return self._prefill_body(self._tensor(batch), kv, self._tensor(true_len))

    def _prefill_body(self, tokens, kv, true_len) -> torch.Tensor:
        """`_prefill` on device tensors (the JAX `_prefill_fn(B, T)`): tokens
        (B, Tb), true_len (B,)."""
        B, T = tokens.shape
        logits = self._forward(
            tokens, torch.zeros(B, dtype=torch.long, device=self.device),
            kv, fresh_prefill=True,
            # flash pays off on big tiles; small buckets stay dense
            use_flash=self.use_flash and T >= self.flash_min_len,
            flash_kernel=self.flash_kernel,
        )
        rows = torch.arange(B, device=self.device)
        return logits[rows, true_len.long() - 1]

    def _prefill_at(self, batch: np.ndarray, kv, pos: int, true_len: int):
        """Chunk prefill at a running cache offset (`ChatSession`): attends
        THROUGH the cache so earlier turns' entries participate; masking is
        strictly by absolute position, so slots at or beyond a query's
        position are invisible whatever they hold."""
        logits = self._forward(self._tensor(batch), self._tensor([pos]), kv)
        return self._last_logits(logits, [true_len])

    def _decode_steps(self, tok, pos, kv, n_steps: int, t_op, p_op, mode: str,
                      top_k) -> torch.Tensor:
        """`n_steps` decode steps from the last tokens `tok` (B,) at
        positions `pos` (B,), device tensors; returns (n_steps, B) on the
        device, with no host read."""
        toks = []
        for _ in range(n_steps):
            logits = self._forward(tok[:, None], pos, kv)
            tok = sample_traced(logits[:, -1], self.rng, t_op, p_op, mode=mode, top_k=top_k)
            toks.append(tok)
            pos = pos + 1
        return torch.stack(toks)

    def _decode_chunk(self, tok, kv, positions, n_steps: int, t_op, p_op,
                      mode: str, top_k) -> np.ndarray:
        """`_decode_steps` launched eagerly from host values; one host read
        at the end.  Returns (n_steps, B)."""
        toks = self._decode_steps(
            self._tensor(tok), self._tensor(positions), kv, n_steps, t_op, p_op, mode, top_k
        )
        return toks.cpu().numpy()

    def _run_cache(self, B: int, cache_len: int) -> Dict[str, torch.Tensor]:
        """generate's dense cache of (B, cache_len), kept on the Generator:
        the decode-chunk graphs read and write it at a fixed address."""
        key = (B, cache_len)
        if key not in self._caches:
            self._caches[key] = self._init_kv(B, cache_len)
        return self._caches[key]

    def _keep_cache_len(self, cache_len: int) -> None:
        """Drop the caches and steps of every other cache length: what a
        Generator keeps between calls is bounded by one run's shapes."""
        self._caches = {k: v for k, v in self._caches.items() if k[1] == cache_len}
        self._steps = {k: v for k, v in self._steps.items() if k[1] == cache_len}

    def _decode_step(self, B: int, cache_len: int, n_steps: int, mode: str,
                     top_k) -> StepGraph:
        """generate's decode chunk (the JAX `_decode_chunk_fn(B, n_steps)`)
        at one key, over the cache of (B, cache_len)."""
        key = (B, cache_len, n_steps, mode, top_k)
        if key not in self._steps:

            def buf(*shape, dtype=torch.long):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            self._steps[key] = StepGraph(
                "generate.decode_chunk", key, self, Generator._decode_steps,
                dict(tok=buf(B), pos=buf(B), t_op=buf(dtype=torch.float32),
                     p_op=buf(dtype=torch.float32)),
                static=dict(kv=self._run_cache(B, cache_len), n_steps=n_steps,
                            mode=mode, top_k=top_k),
                capture=self._graphs, generators=[self.rng],
            )
        return self._steps[key]

    def _measure_decode_chunk(self, step: StepGraph, key, values, kv) -> None:
        """With a registry attached, the decode chunk's report at its first
        run per key: its warm-up over this run's values (which writes the
        bytes the run then writes) under the probe."""
        if self.device_obs is None:
            return
        from mdi_llm_tpu_torch.obs.device import introspect_step, tensor_bytes

        def measure():
            step.load(**values)
            return introspect_step(step, "decode_chunk", key, alias_bytes=tensor_bytes(kv))

        self.device_obs.capture("decode_chunk", key, measure)

    def graph_stats(self) -> Dict[str, Any]:
        """generate's decode-chunk steps held now: built, captured,
        replayed, capture seconds."""
        return summarize(self._steps.values())

    def _verify(self, tokens: np.ndarray, kv, positions) -> np.ndarray:
        """Greedy verification forward for speculative decoding: the greedy
        successor of every position of `tokens` (1, T).  Exact because
        attention masks strictly by absolute position: stale cache entries
        past a rejected draft stay invisible until overwritten."""
        return self._verify_body(self._tensor(tokens), kv, self._tensor(positions)).cpu().numpy()

    def _verify_body(self, tokens, kv, positions) -> torch.Tensor:
        """`_verify` on device tensors (the JAX `_verify_fn(T)`): the
        greedy successors (1, T), on the device."""
        return torch.argmax(self._forward(tokens, positions, kv), dim=-1)

    def _grow_kv(self, old, new_len: int):
        """A longer session cache with the old entries in its leading
        corner."""
        fresh = self._init_kv(1, new_len)
        for new, x in zip(transformer.tree_leaves(fresh), transformer.tree_leaves(old)):
            new[..., : x.shape[3], :] = x
        return fresh

    def _sampling(self, temperature, top_k, top_p):
        t_op, p_op = sampling_operands(temperature, top_p, device=self.device)
        return t_op, p_op, sample_mode(temperature, top_k, top_p)

    def _first_token(self, logits, temperature, top_k, top_p) -> np.ndarray:
        tok = sample(logits, self.rng, temperature=temperature, top_k=top_k, top_p=top_p)
        return tok.to(torch.int32).cpu().numpy()

    # -- the compile set (analysis/ir.py, analysis/liveness.py) --------------

    def enumerate_executables(
        self,
        batch_size: int = 1,
        prompt_len: int = 32,
        max_new_tokens: int = 32,
        chunk_size: int = 16,
        temperature: float = TEMPERATURE,
        top_k: Optional[int] = TOP_K,
        top_p: Optional[float] = None,
        speculative: Optional[int] = None,
        compact: bool = True,
    ) -> List[Any]:
        """`generate()`'s steps for ONE workload shape, as `StepSpec`s on a
        meta twin of this Generator (the JAX `enumerate_executables`): the
        prefill at the prompt's pow2 bucket (through K2 once the bucket
        reaches `flash_min_len` with `use_flash`), the decode-chunk ladder
        (the full chunk width, the tail chunk, and every lane count batch
        compaction can gather down to) and, with `speculative=K`, the
        verify forward.  Like the JAX set, this is the nominal set of one
        (B, prompt_len, max_new_tokens) workload: `generate()` builds its
        steps per shape by design."""
        from mdi_llm_tpu_torch.obs.device import StepSpec, abstractify

        B = int(batch_size)
        if B < 1 or prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("batch_size, prompt_len and max_new_tokens must be >= 1")
        total_max = prompt_len + max_new_tokens
        if total_max > self.max_seq_length:
            raise ValueError(
                f"prompt+generation length {total_max} exceeds max_seq_length "
                f"{self.max_seq_length}"
            )
        Tb = min(_bucket(prompt_len), self.max_seq_length)
        cache_len = _run_cache_len(self.max_seq_length, total_max, Tb)
        memo: Dict[int, Any] = {}
        twin = abstractify(self, memo)
        if self.device.type == "cpu" and twin.flash_kernel is None:
            twin.flash_kernel = False  # a CPU Generator runs K2's plain version
        params = abstractify(self.params if self._shards is None else self._shards, memo)

        def sds(*shape, dtype=torch.long):
            return torch.empty(shape, dtype=dtype, device=twin.device)

        # every step reads the weights from the Generator and is passed the
        # dense cache, which it writes in place (the JAX roles: params at
        # argnum 0, the donated cache at argnum 2)
        def spec(label, key, body, inputs, static=None):
            return StepSpec(label, key, body, twin, {"params": params, **inputs}, static,
                            {"params": "params", "kv": "kv"}, ("params",), ("kv",))

        specs = [spec("prefill", (B, Tb), Generator._prefill_body, dict(
            tokens=sds(B, Tb), kv=twin._init_kv(B, cache_len), true_len=sds(B)))]
        mode = sample_mode(temperature, top_k, top_p)
        # decode-chunk widths the host loop runs: n starts at 1 (the
        # prefill-sampled token), so the full width is min(chunk_size,
        # max_new_tokens - 1) and the remainder rides in one tail chunk
        k_full = min(int(chunk_size), max_new_tokens - 1)
        widths = []
        if k_full >= 1:
            widths.append(k_full)
            tail = (max_new_tokens - 1) % k_full
            if tail and tail != k_full:
                widths.append(tail)
        # compaction gathers survivors into the next pow2 >= the live count,
        # floored at min(4, B) and only when that is <= half the lanes; off
        # on a mesh (`generate`)
        lane_counts = {B}
        if compact and self._shards is None:
            v = 1
            while v <= B // 2:
                if v >= min(4, B):
                    lane_counts.add(v)
                v *= 2
        for nb in sorted(lane_counts, reverse=True):
            kv = twin._init_kv(nb, cache_len)
            for w in widths:
                specs.append(spec("decode_chunk", (nb, w), Generator._decode_steps, dict(
                    tok=sds(nb), pos=sds(nb), kv=kv, t_op=sds(dtype=torch.float32),
                    p_op=sds(dtype=torch.float32)), dict(n_steps=w, mode=mode, top_k=top_k)))
        if speculative:
            K = int(speculative)
            specs.append(spec("verify", (K + 1,), Generator._verify_body, dict(
                tokens=sds(1, K + 1), kv=twin._init_kv(1, cache_len), positions=sds(1))))
        return specs

    # -- sequential generation -----------------------------------------------

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
        temperature: float = TEMPERATURE,
        top_k: Optional[int] = TOP_K,
        top_p: Optional[float] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
        stream_cb=None,
        chunk_size: int = 16,
        speculative: Optional[int] = None,
        compact: bool = True,
        shared_prefill: Optional[bool] = None,
    ) -> Tuple[List[List[int]], GenerationStats]:
        """Generate continuations for a batch of token-id prompts.

        Returns (full token lists incl. prompt, truncated at stop sequences)
        and timing stats.  `stream_cb(sample_idx, token)` is invoked per
        generated token when given.

        `chunk_size` decode steps run between host reads; stop sequences
        are checked between chunks, so up to chunk_size-1 extra tokens are
        computed then discarded — the token stream itself is unchanged.

        `compact` reclaims lanes of early-stopped samples by gathering the
        survivors into a smaller batch.  Greedy streams are unchanged; with
        temperature > 0 the survivors keep their distribution but not
        their exact draws.

        `speculative=K`: greedy speculative decoding with prompt-lookup
        (n-gram) drafts of K tokens verified in one forward, up to K+1
        tokens per forward.  Exact; requires temperature == 0 and one
        prompt.

        `shared_prefill`: when every prompt is identical, prefill runs once
        at B=1 and the cache/logits broadcast across lanes.  None (default)
        takes it only for greedy decoding; True always; False never.
        """
        if speculative:
            if temperature != 0.0 or len(prompts) != 1:
                raise ValueError(
                    "speculative decoding requires temperature=0 and exactly "
                    "one prompt (it is a latency optimization for B=1 greedy)"
                )
        B = len(prompts)
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        max_len = max(lens)
        total_max = max_len + max_new_tokens
        if total_max > self.max_seq_length:
            raise ValueError(
                f"prompt+generation length {total_max} exceeds max_seq_length "
                f"{self.max_seq_length}; pass --sequence-length or shorten"
            )

        # clamp the pow2 bucket at the engine max so a non-pow2
        # max_seq_length can never leave the cache narrower than the chunk
        Tb = min(_bucket(max_len), self.max_seq_length)
        batch = np.zeros((B, Tb), np.int32)
        for i, p in enumerate(prompts):
            batch[i, : lens[i]] = np.asarray(p, np.int32)
        if B % self.dp:
            raise ValueError(
                f"batch of {B} samples must be divisible by the mesh's "
                f"dp={self.dp}"
            )
        cache_len = _run_cache_len(self.max_seq_length, total_max, Tb)

        stats = GenerationStats()
        t0 = time.perf_counter()
        self._keep_cache_len(cache_len)
        graphs0 = self.graph_stats()
        p0 = list(prompts[0])
        if shared_prefill is None:  # greedy only (see the docstring)
            shared_prefill = temperature == 0.0
        # unmeshed only, as in the JAX package: on a mesh the lanes and the
        # cache are split, and the plain prefill is parallel already
        shared = (shared_prefill and B > 1 and self._shards is None
                  and all(list(p) == p0 for p in prompts[1:]))
        if shared:
            kv1 = self._run_cache(1, cache_len)
            for x in kv1.values():
                x.zero_()
            last1 = self._dev_call("prefill", (1, Tb), self._prefill, batch[:1], kv1, lens[:1])
            last_logits = last1.expand(B, -1)
            kv = self._run_cache(B, cache_len)
            for n, x in kv1.items():
                kv[n].copy_(x.expand(-1, B, -1, -1, -1))
        else:
            kv = self._run_cache(B, cache_len)
            for x in transformer.tree_leaves(kv):
                x.zero_()
            last_logits = self._dev_call("prefill", (B, Tb), self._prefill, batch, kv, lens)
        # first sampled token (from the prefill logits)
        tok = self._first_token(last_logits, temperature, top_k, top_p)
        stats.prefill_s = time.perf_counter() - t0

        out = [list(p) for p in prompts]
        done = [False] * B
        positions = np.asarray(lens, np.int64)
        t_dec = time.perf_counter()
        # decode lane -> original sample index (None = padding after a batch
        # compaction); every per-lane structure below is indexed through it
        lanes: List[Optional[int]] = list(range(B))

        def emit(toks_bvec, n_emitted):
            for b, j in enumerate(lanes):
                if j is not None and not done[j]:
                    out[j].append(int(toks_bvec[b]))
                    if stream_cb is not None:
                        stream_cb(j, int(toks_bvec[b]))
                    if detect_stop_tokens(out[j][lens[j] :], stop_sequences):
                        done[j] = True
            stats.tok_time.append((n_emitted, time.perf_counter() - t0))

        n = 1
        emit(tok, n)

        # ---- speculative fast path (B=1 greedy): draft K via n-gram lookup,
        # verify in one forward, emit the matching prefix + bonus token ----
        if speculative:
            K = int(speculative)
            t_greedy, p_greedy, _ = self._sampling(0.0, top_k, top_p)
            with catch_loop_errors() as g_spec:
                while (
                    n < max_new_tokens
                    and not done[0]
                    and cache_len - int(positions[0]) - 1 >= K + 1
                ):
                    draft = ngram_draft(out[0], K)
                    if not draft:
                        # no lookup match: a (K+1)-wide verify would burn
                        # (K+1)x the step cost to emit one token — run a
                        # plain chunked burst instead and retry drafting
                        c = min(
                            chunk_size,
                            max_new_tokens - n,
                            cache_len - int(positions[0]) - 1,
                        )
                        toks_np = self._decode_chunk(
                            tok, kv, positions, c, t_greedy, p_greedy, "greedy", top_k
                        )
                        fed = 0
                        for i in range(c):
                            n += 1
                            fed = i + 1
                            emit(toks_np[i], n)
                            if done[0]:
                                break
                        # advance by tokens actually emitted: a stop sequence
                        # mid-chunk must not leave positions past the last
                        # real token
                        tok = toks_np[fed - 1]
                        positions = positions + fed
                        continue
                    emitted = _verify_accept(self, kv, tok, draft, K, positions)
                    allowed = min(len(emitted), max_new_tokens - n)
                    fed = 0
                    for t in emitted[:allowed]:
                        n += 1
                        fed += 1
                        emit(np.asarray([t]), n)
                        if done[0]:
                            break
                    tok = np.asarray([emitted[fed - 1]], np.int32)
                    positions = positions + fed
            stats.interrupted = g_spec.interrupted
            # the plain loop below finishes any tail the cache window allows

        def compact_lanes():
            """Batch compaction: once enough samples have finished that the
            live set fits a power-of-two bucket <= half the current lane
            count, gather the surviving lanes (KV cache, last tokens,
            positions) into the smaller batch — decode bytes/step are
            proportional to the lane count.  Greedy streams are unchanged
            (pure gather)."""
            nonlocal kv, tok, positions, lanes
            active = [b for b, j in enumerate(lanes) if j is not None and not done[j]]
            if not active or len(lanes) <= 1:
                return
            nB = 1
            while nB < len(active):
                nB *= 2
            # floor at 4 lanes, as in the JAX package (each new lane count
            # cost it a compile; the shape set is kept the same here)
            nB = max(nB, min(4, len(lanes)))
            if nB > len(lanes) // 2:
                return
            sel = active + [active[0]] * (nB - len(active))
            sel_t = self._tensor(sel)
            small = self._run_cache(nB, cache_len)
            for kk, vv in kv.items():
                small[kk].copy_(vv.index_select(1, sel_t))
            kv = small
            tok = tok[np.asarray(sel)]
            positions = positions[np.asarray(sel)]
            lanes = [lanes[b] for b in active] + [None] * (nB - len(active))
            stats.compactions += 1

        mode = sample_mode(temperature, top_k, top_p)
        t_val, p_val = operand_values(temperature, top_p)
        # Ctrl-C mid-loop returns what was generated so far
        with catch_loop_errors() as guard:
            while n < max_new_tokens and not all(done) and not stats.interrupted:
                # mesh runs keep their lane count: the cache is laid out
                # for the dp-divisible batch
                if compact and self._shards is None:
                    compact_lanes()
                room = cache_len - int(positions.max()) - 1
                k = min(chunk_size, max_new_tokens - n, room)
                if k < 1:
                    break
                step = self._decode_step(len(lanes), cache_len, k, mode, top_k)
                values = dict(tok=tok, pos=positions, t_op=t_val, p_op=p_val)
                self._measure_decode_chunk(step, (len(lanes), k), values, kv)
                # a copy: the step's outputs are overwritten by its next run
                # mdi-lint: disable-next-line=host-sync -- one read per decode chunk of k steps, the JAX loop's batched fetch
                toks_np = np.array(step.run(**values).cpu())
                for i in range(k):
                    n += 1
                    emit(toks_np[i], n)
                tok = toks_np[-1]
                positions = positions + k

        stats.interrupted = stats.interrupted or guard.interrupted
        stats.decode_s = time.perf_counter() - t_dec
        graphs = self.graph_stats()
        stats.captures = graphs["captures"] - graphs0["captures"]
        stats.capture_s = graphs["capture_s"] - graphs0["capture_s"]
        stats.tokens_generated = sum(len(o) - l for o, l in zip(out, lens))

        # final truncation at the earliest stop sequence
        trimmed = []
        for o, l in zip(out, lens):
            cut = find_eot(o[l:], stop_sequences)
            trimmed.append(o[: l + cut])
        return trimmed, stats

    def generate_chat(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        temperature: float = TEMPERATURE,
        top_k: Optional[int] = TOP_K,
        top_p: Optional[float] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
    ) -> Iterator[int]:
        """Streaming single-sample generation: yields tokens as they are
        sampled, holding back potential stop-sequence prefixes so a partial
        stop marker is never emitted."""
        # at call time: a raise in the generator body would surface only at
        # the caller's first next()
        if self.dp > 1:
            raise ValueError("streaming generates one sample; use a tp-only mesh")
        return stop_filtered_stream(
            self._generate_stream(
                prompt, max_new_tokens, temperature, top_k, top_p, stop_sequences
            ),
            stop_sequences,
        )

    def _generate_stream(self, prompt, max_new_tokens, temperature, top_k, top_p, stop_sequences):
        lens = len(prompt)
        total_max = lens + max_new_tokens
        if total_max > self.max_seq_length:
            raise ValueError("prompt too long for max_seq_length")
        Tb = min(_bucket(lens), self.max_seq_length)
        batch = np.zeros((1, Tb), np.int32)
        batch[0, :lens] = np.asarray(prompt, np.int32)
        cache_len = _run_cache_len(self.max_seq_length, total_max, Tb)
        kv = self._init_kv(1, cache_len)
        last_logits = self._prefill(batch, kv, [lens])
        tok = self._first_token(last_logits, temperature, top_k, top_p)
        yield from _decode_token_stream(
            self, kv, tok, lens, cache_len, max_new_tokens,
            temperature, top_k, top_p, stop_sequences,
        )

    def chat_session(self) -> "ChatSession":
        """A stateful conversation handle with cross-turn KV reuse."""
        return ChatSession(self)

    # -- serving -------------------------------------------------------------

    def serve(self, serving=None, obs=None, policy=None, draft_gen=None, **knobs):
        """A paged-KV continuous-batching engine over this model
        (`serving/engine.py`).  Pass a `ServingConfig`, or its fields as
        keywords::

            engine = gen.serve(block_size=16, max_batch=8)
            engine.add_request("r0", prompt_tokens, max_new_tokens=128)
            results, stats = engine.run()

        `obs` takes a `ServingObserver` (`obs/`). `draft_gen` takes a
        Generator for `ServingConfig.draft_model`'s weights (same
        vocabulary as this model); None lets the engine initialise the
        named config with random weights.  On a pipeline mesh of S >= 2
        stages (a tp axis inside each stage or not) the engine is
        `serving/pipeline.PipelinedServingEngine`, with the same request
        and stats surface.
        """
        from mdi_llm_tpu_torch.config import ServingConfig
        from mdi_llm_tpu_torch.serving.engine import ServingEngine, validate_serving_mesh

        # refused here, naming the axis, before any pool is allocated
        validate_serving_mesh(self._ep_mesh or self._tp_mesh)
        if self._procs:
            raise ValueError(
                "serving over processes: each process would run its own scheduler "
                "over the shared collectives; serve in one process (the serve CLI has "
                "no --coordinator, as the JAX package's has none)")
        if serving is None:
            serving = ServingConfig(**knobs)
        elif knobs:
            raise ValueError("pass a ServingConfig or keywords, not both")
        if isinstance(self.mesh, dict) and len(self.mesh) > 1:
            from mdi_llm_tpu_torch.serving.pipeline import PipelinedServingEngine

            return PipelinedServingEngine(self, serving, obs=obs, policy=policy,
                                          draft_gen=draft_gen)
        return ServingEngine(self, serving, obs=obs, policy=policy, draft_gen=draft_gen)


def _verify_accept(gen: Generator, kv, tok, draft, K: int, positions) -> List[int]:
    """Speculative verify-and-accept core, shared by `generate()`'s fast
    path and `ChatSession`: pad the draft to K, score [tok]+draft in one
    forward (`_verify`), and return the accepted burst."""
    draft = pad_draft(draft, K)
    toks_in = np.asarray([[int(tok[0])] + draft], np.int64)
    g = gen._verify(toks_in, kv, positions)
    return accept_draft(draft, g[0], K)


def _decode_token_stream(
    gen: Generator,
    kv: Dict[str, torch.Tensor],
    first_tok: np.ndarray,
    start_pos: int,
    cache_len: int,
    max_new: int,
    temperature, top_k, top_p, stop_sequences,
    fed: Optional[List[int]] = None,
):
    """Shared single-sample decode loop: yield raw sampled tokens one at a
    time (stop filtering is the caller's job).  `kv` is updated in place,
    so a caller that keeps it (ChatSession) sees every fed token even if
    the stream is abandoned; `fed`, when given, counts tokens actually
    forwarded through the model (all but the final sampled one)."""
    tok = first_tok
    pos = np.asarray([start_pos], np.int64)
    t_op, p_op, mode = gen._sampling(temperature, top_k, top_p)
    emitted: List[int] = []
    for i in range(max_new):
        t = int(tok[0])
        emitted.append(t)
        yield t
        if detect_stop_tokens(emitted, stop_sequences):
            return
        if i == max_new - 1 or int(pos[0]) + 1 >= cache_len:
            return
        tok = gen._decode_chunk(tok, kv, pos, 1, t_op, p_op, mode, top_k)[0]
        if fed is not None:
            fed[0] += 1
        pos = pos + 1


class ChatSession:
    """Cross-turn KV reuse for interactive chat: the session keeps one KV
    cache and a running position; each `send` prefills only the new tokens
    at that offset, so turn latency scales with the turn length, not the
    conversation length.

    Turn prefills use power-of-two buckets only (the session slides the
    window early rather than prefill an arbitrary residual width), and the
    cache grows geometrically from the first turn's run-sized length toward
    `max_seq_length`.

    State invariant between sends: `history` is the logical conversation;
    the cache holds real entries for all of it except the trailing
    `_pending` tokens (at most the final sampled reply token, which was
    never fed through the model).  Rolled-back slots (stop-marker tokens
    trimmed from a reply) are dead by the absolute-position masking
    contract and are overwritten by the next turn's prefill.
    """

    def __init__(self, gen: Generator):
        if gen.dp > 1:
            raise ValueError("chat session streams one sample; use a tp-only mesh")
        self.gen = gen
        self.reset()

    def reset(self) -> None:
        self.history: List[int] = []
        self._kv: Optional[Dict[str, torch.Tensor]] = None
        self._cache_len = 0
        self._pos = 0  # cache slots holding real (attendable) entries
        self._pending: List[int] = []  # history tail not yet in the cache

    def rollback(self, history: Sequence[int]) -> None:
        """Restore a logical conversation (e.g. after interrupting a reply
        mid-stream): the cache is rebuilt by one full prefill on the next
        send."""
        self.reset()
        self.history = list(history)
        self._pending = list(history)

    @property
    def capacity(self) -> int:
        return self.gen.max_seq_length

    @property
    def used(self) -> int:
        return len(self.history)

    def send(
        self,
        turn: Sequence[int],
        max_new_tokens: int,
        temperature: float = TEMPERATURE,
        top_k: Optional[int] = TOP_K,
        top_p: Optional[float] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
        speculative: Optional[int] = None,
    ) -> Iterator[int]:
        """Stream the reply to `turn` (stop-filtered, like generate_chat).
        Session state updates as the iterator is consumed; exhaust it before
        the next send.

        `speculative=K` (greedy only): draft K tokens by prompt-lookup over
        the whole conversation and verify them in one forward, emitting up
        to K+1 tokens per forward.  Exact (token-identical to the plain
        stream)."""
        turn = list(turn)
        max_new = int(max_new_tokens)
        if not turn:
            raise ValueError("empty turn")
        if max_new + 1 >= self.gen.max_seq_length:
            raise ValueError("max_new_tokens too large for max_seq_length")
        if speculative and temperature != 0.0:
            raise ValueError("speculative chat requires temperature=0")
        return self._send(
            turn, max_new, temperature, top_k, top_p, stop_sequences,
            speculative=int(speculative) if speculative else None,
        )

    def _grow_cache(self, needed: int) -> None:
        """Ensure the cache covers `needed` slots: grow geometrically (at
        least doubling, 256-slot granularity), existing entries copied into
        the leading corner."""
        gen = self.gen
        if self._cache_len >= needed:
            return
        new_len = min(
            gen.max_seq_length,
            max(_cache_bucket(needed), 2 * self._cache_len),
        )
        if self._kv is None or self._pos == 0:
            self._kv = gen._init_kv(1, new_len)
        else:
            self._kv = gen._grow_kv(self._kv, new_len)
        self._cache_len = new_len

    def _spec_raw_stream(
        self, tok0, prompt_end, cache_len, max_new, K, top_k, top_p,
        stop_sequences, posbox,
    ):
        """Greedy speculative raw stream for a session turn: draft K tokens
        by n-gram lookup over conversation+reply, verify in one forward,
        emit the matching prefix + bonus token.  Falls back to single plain
        decode steps when no draft is found or the cache is nearly full.
        `posbox[0]` tracks the absolute position of the current (unfed)
        token so the caller can reconcile cache state."""
        gen = self.gen
        tok = tok0
        pos = prompt_end  # absolute slot of the current unfed token
        t_greedy, p_greedy, _ = gen._sampling(0.0, top_k, top_p)
        emitted: List[int] = [int(tok[0])]
        posbox[0] = pos
        yield emitted[0]
        miss_skip = 0  # after a lookup miss, decode a few plain steps
        # before rescanning: the O(history) host-side n-gram scan per token
        # would otherwise rival the device step cost on non-echoing replies
        while len(emitted) < max_new:
            if detect_stop_tokens(emitted, stop_sequences):
                return
            room = cache_len - pos - 1
            if room < 1:
                return
            draft = []
            if room >= K + 1 and miss_skip == 0:
                draft = ngram_draft(self.history + emitted, K)
                if not draft:
                    miss_skip = 4
            if draft:
                burst = _verify_accept(gen, self._kv, tok, draft, K, [pos])
                fed = 0
                stopped = False
                for t in burst[: max_new - len(emitted)]:
                    emitted.append(t)
                    fed += 1
                    yield t
                    if detect_stop_tokens(emitted, stop_sequences):
                        stopped = True
                        break
                tok = np.asarray([emitted[-1]], np.int32)
                pos += fed
                posbox[0] = pos
                if stopped:
                    return
            else:
                miss_skip = max(0, miss_skip - 1)
                tok = gen._decode_chunk(
                    tok, self._kv, [pos], 1, t_greedy, p_greedy, "greedy", top_k
                )[0]
                pos += 1
                posbox[0] = pos
                emitted.append(int(tok[0]))
                yield emitted[-1]

    def _send(self, turn, max_new, temperature, top_k, top_p, stop_sequences,
              speculative=None):
        gen = self.gen
        cap = gen.max_seq_length
        self.history.extend(turn)
        feed = self._pending + turn
        lens = len(feed)
        # Slide the window when the conversation outgrows capacity — and
        # also, at a nonzero offset, when the pow2 prefill bucket no longer
        # fits: pay one full re-prefill instead of an arbitrary width
        fits_exact = self._pos + lens + max_new + 1 <= cap
        fits_bucket = self._pos + _bucket(lens) + max_new + 1 <= cap
        if not fits_exact or (self._pos > 0 and not fits_bucket):
            window = self.history[-(cap - max_new - 1):]
            self._kv, self._cache_len = None, 0
            self._pos, self._pending = 0, []
            self.history = list(window)
            feed = window
            lens = len(feed)
        fresh_start = self._pos == 0
        Tb = min(_bucket(lens), cap) if fresh_start else _bucket(lens)
        self._grow_cache(min(cap, self._pos + max(Tb, lens + max_new)))
        cache_len = self._cache_len
        batch = np.zeros((1, Tb), np.int32)
        batch[0, :lens] = np.asarray(feed, np.int32)
        if fresh_start:
            # empty cache at offset 0: the fresh-prefill path applies (and
            # engages flash on long pasted prompts)
            last = gen._prefill(batch, self._kv, [lens])
        else:
            last = gen._prefill_at(batch, self._kv, self._pos, lens)
        prompt_end = self._pos + lens
        self._pos = prompt_end
        self._pending = []

        tok = gen._first_token(last, temperature, top_k, top_p)
        if speculative:
            posbox = [prompt_end]
            raw = self._spec_raw_stream(
                tok, prompt_end, cache_len, max_new, speculative,
                top_k, top_p, stop_sequences, posbox,
            )
        else:
            fed = [0]
            raw = _decode_token_stream(
                gen, self._kv, tok, prompt_end, cache_len, max_new,
                temperature, top_k, top_p, stop_sequences, fed=fed,
            )
        reply: List[int] = []
        for t in stop_filtered_stream(raw, stop_sequences):
            reply.append(t)
            yield t
        # reconcile: the cache holds prompt + the fed reply prefix; the
        # logical reply may be shorter (stop marker trimmed -> roll back
        # those slots) or longer than what was fed (the final sampled token
        # — or a speculative bonus burst — was never fed -> carry as
        # pending for the next turn's prefill)
        self.history.extend(reply)
        advance = (posbox[0] - prompt_end) if speculative else fed[0]
        keep = min(len(reply), advance)
        self._pos = prompt_end + keep
        self._pending = reply[keep:]
