"""Recurrent pipeline-parallel generation: the paper's ring of stages.

Port of `mdi_llm_tpu/parallel/pipeline.py` (`PipelineEngine`):

- The model's blocks split into S stages (`partition.stage_layers`, the
  reference's table); stage 0 also holds the embedding, the final norm
  and the head.  Each stage runs its true layer count (the JAX package
  zero-pads every stage to the largest count so its SPMD program stays
  uniform; a zero-weight block is an exact identity, so the tokens are
  the same).
- Recurrent pipeline parallelism: the ring holds S slot groups of
  `samples_per_slot` (M) samples.  In one micro-step every stage runs its
  blocks on the payload in front of it, and every payload (the
  activations `x`, the slot id `sid`, the positions `pos` and the valid
  flags) moves one stage on; S micro-steps are one rotation, which gives
  every in-flight sample one new token.  Stage 0 applies the head and
  samples on the activations returning from the last stage, then embeds
  the sampled (or overridden, or injected) tokens.
- Per-sample caches: each stage keeps a dense cache of (layers,
  n_slots = S + 1, M, G, seq, hs); the slot id travels with the payload,
  and the trailing slot absorbs the writes of bubble payloads.
- A tensor-parallel axis inside each stage (`tp`, or the ("pipe", "tp")
  `Mesh` of `pipeline_mesh(S, devices, tp=N)`): each stage's blocks are
  sliced per rank under the Megatron rules (`sharding.shard_ranks`) and
  run over its ranks (`models.transformer.TPRanks`), one all-reduce per
  row-parallel product, each rank over its own cache of G/tp groups.
  After a stage's last all-reduce the activations are replicated, so the
  payload and the hop stay as they are: one copy travels.  The embedding
  and the head stay whole on stage 0, as the JAX ring keeps them
  replicated.
- The continuous scheduler: the first S * M prompts prefill in one
  pipelined call; a sample that finishes frees its lane, fully free slots
  are refilled by another pipelined prefill, a free lane of a busy slot
  by feeding its prompt one token per rotation through the override
  channel (`token_fills`).

Where the stages run (`parallel/mesh.pipeline_mesh`):

- One process, one device: the `ppermute` hop is a shift of the stage
  payloads on the device.  On the card the steady decode chunk (R * S
  micro-steps, R = `rotations_per_call`), the counterpart of the JAX
  package's one jitted scan per call, is a CUDA graph (`StepGraph`): the
  overrides are its static input buffers, the payload and the caches its
  persistent state, sampling inside it as in `Generator`'s decode chunk.
  The prefill ring launches eagerly.  `_graphs=False` launches the chunk
  eagerly too (comparisons on the card).
- One process, S devices: the hop copies the payload to the next stage's
  device; the ring launches eagerly.
- Several processes (`ring`, a `nodes.RingGroup`): each owns a
  contiguous group of S / n_processes stages (with tp > 1, their ranks
  too, all on its one device: the collectives inside a stage stay in the
  process); the hop between processes
  is one send/recv of the payload per micro-step.  Process 0 runs the
  host loop and broadcasts each ring call (its micro-step count and
  overrides) before making it, so every process runs the same
  micro-steps; the others follow until process 0 sends the finished
  outputs, so `generate` returns the same lists on every process.  A
  failure on process 0 sends an abort through the same channel.  The
  multi-process ring launches eagerly (a send/recv is not captured).

Bubble lanes: an invalid lane's position keeps growing (`pos + 1` every
rotation) and may pass the cache.  Every stage clamps the positions it
runs at to the cache (`_stage_forward`); only invalid lanes, the dummy
slot or a finished lane's surplus tokens are ever clamped, and the rows
are independent, so the emitted tokens do not change.

The ring runs the blocks over dense caches without flash, as the JAX ring
does: it launches none of the port's kernels.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdi_llm_tpu_torch.config import TEMPERATURE, TOP_K, Config
from mdi_llm_tpu_torch.generation import (
    GenerationStats,
    _bucket,
    _run_cache_len,
    detect_stop_tokens,
    find_eot,
    resolve_device,
    rng_for,
)
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params
from mdi_llm_tpu_torch.ops.rope import gather_rope
from mdi_llm_tpu_torch.ops.sampling import operand_values, sample, sample_mode, sample_traced
from mdi_llm_tpu_torch.parallel.mesh import Mesh, make_mesh, pipe_axis, pipeline_mesh, stage_ranks
from mdi_llm_tpu_torch.parallel.partition import split_params, stage_layers
from mdi_llm_tpu_torch.parallel.sharding import shard_ranks, validate_tp_divisibility
from mdi_llm_tpu_torch.utils.context_managers import catch_loop_errors
from mdi_llm_tpu_torch.utils.step_graph import StepGraph, summarize

Payload = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # x, sid, pos, val


class PipelineAbort(RuntimeError):
    """Process 0 of a multi-process ring stopped the run."""


class PipelineEngine:
    """Pipeline generation engine: `params` is the full layer-stacked
    tree, split over the stages by `partition.stage_layers`."""

    def __init__(
        self,
        cfg: Config,
        params: Any,
        n_stages: Optional[int] = None,
        mesh: Any = None,  # {stage: device} of pipeline_mesh, or its pipe x tp Mesh
        max_seq_length: Optional[int] = None,
        cache_dtype: Optional[torch.dtype] = None,  # None -> params dtype
        rng_seed: int = 1337,
        devices: Optional[Sequence] = None,  # one device, or one per stage
        # (per position, stage-major, with tp > 1)
        quantize: Optional[str] = None,  # None | "none" | "int8" | "w8a8" | "int4"
        samples_per_slot: int = 1,  # M: samples travelling together per ring slot
        rotations_per_call: int = 16,  # steady-state ring rotations per call
        tp: int = 1,  # tensor-parallel ranks per stage (a pipe x tp mesh)
        overlap_chunks: bool = False,  # run the next steady chunk before
        # reading the previous one's emissions
        device=None,  # None -> "cuda"; the device of every stage without devices
        ring=None,  # nodes.RingGroup of a multi-process job
        _graphs: Optional[bool] = None,  # None -> the steady chunk as a CUDA
        # graph where it can be one; False launches it eagerly
    ):
        if quantize not in (None, "none") and quantize not in FLAG_TO_MODE:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if tp < 1:
            raise ValueError(f"tp={tp} must be a positive device count")
        transformer.check_supported(cfg)
        self.ring = ring
        P = 1 if ring is None else ring.world
        rank = 0 if ring is None else ring.rank
        if isinstance(mesh, Mesh):
            pa = pipe_axis(mesh)
            mesh_tp = int(mesh.shape.get("tp", 1))
            if pa is None or tp not in (1, mesh_tp):
                raise ValueError(f"mesh {mesh.shape} for a ring of tp={tp}: pass "
                                 "pipeline_mesh(S, devices, tp=N)")
            tp = mesh_tp
            if n_stages not in (None, mesh.shape[pa]):
                raise ValueError(f"n_stages={n_stages} and a mesh of {mesh.shape[pa]} stages")
            n_stages = mesh.shape[pa]
            if mesh.num_processes != P:
                raise ValueError(f"a mesh over {mesh.num_processes} processes for a ring "
                                 f"of {P}")
        elif isinstance(mesh, dict) and tp > 1:
            raise ValueError("a {stage: device} mesh has no tp axis: pass "
                             "pipeline_mesh(S, devices, tp=N)")
        if n_stages is None:
            n_stages = len(mesh) if mesh else (len(devices) // tp if devices else P)
        S = int(n_stages)
        if S % P:
            raise ValueError(f"{S} stages do not split over {P} processes: the stage "
                             "count must be a multiple of the node count")
        per = S // P
        if mesh is None:
            if devices is None:
                devices = [resolve_device(device) if ring is None else ring.device]
            if tp == 1:
                mesh = pipeline_mesh(S, devices, stages=range(rank * per, (rank + 1) * per))
            elif ring is None:
                mesh = pipeline_mesh(S, devices, tp=tp)
            else:
                if len(devices) != 1:
                    raise ValueError("each process of a pipe x tp ring runs its ranks on "
                                     "its one device")
                mesh = make_mesh({"pipe": S, "tp": tp}, devices, rank, P)
        validate_tp_divisibility(cfg, tp)
        # {stage: [its ranks' devices]} for the stages this process runs
        self.ranks = stage_ranks(mesh)
        for devs in self.ranks.values():
            for d in devs:
                resolve_device(d)  # a CUDA stage without a GPU raises
        self.tp = tp
        self.mesh = {s: devs[0] for s, devs in self.ranks.items()}
        self.owned = sorted(self.mesh)
        self.n_stages = S
        self.cfg = cfg
        self.max_seq_length = int(min(max_seq_length or cfg.block_size, cfg.block_size))
        self.M = int(samples_per_slot)
        if self.M < 1:
            raise ValueError("samples_per_slot must be >= 1")
        self.rotations_per_call = max(1, int(rotations_per_call))
        self.overlap_chunks = bool(overlap_chunks)
        self.n_slots = S + 1  # one cache slot per ring position + the dummy
        self.counts = stage_layers(cfg.n_layer, S)

        if quantize in FLAG_TO_MODE:
            params = quantize_params(params, mode=FLAG_TO_MODE[quantize])
        stages = split_params(cfg, params, S)
        # a process that owns only some stages keeps copies of its slices,
        # so the rest of the full tree can be freed
        own = (lambda x, d: x.to(d).clone()) if len(self.owned) < S else (lambda x, d: x.to(d))
        # tp = 1: each stage's block tree; tp > 1: each stage's ranks
        # (`models.transformer.TPRanks`) over its rank trees, the slices
        # of `sharding.shard_ranks`, and their per-layer views
        self.stage_blocks = {}
        self._tp_ranks: Dict[int, transformer.TPRanks] = {}
        self._tp_layers: Dict[int, list] = {}
        for s in self.owned:
            if tp == 1:
                self.stage_blocks[s] = transformer.tree_map(
                    lambda x, d=self.mesh[s]: own(x, d), stages[s]["blocks"])
                continue
            trees = [transformer.tree_map(lambda x, d=d: own(x, d), t) for t, d in zip(
                shard_ranks(cfg, {"blocks": stages[s]["blocks"]}, self.ranks[s]),
                self.ranks[s])]
            self.stage_blocks[s] = [t["blocks"] for t in trees]
            self._tp_ranks[s] = transformer.TPRanks(cfg, trees)
            self._tp_layers[s] = self._tp_ranks[s].layers()
        first = self.stage_blocks[self.owned[0]]
        self.dtype = transformer.param_dtype(first[0] if tp > 1 else first)
        self.cache_dtype = self.dtype if cache_dtype is None else cache_dtype
        self.head_params = None
        if 0 in self.mesh:
            self.head_params = {
                k: transformer.tree_map(lambda x: own(x, self.mesh[0]), stages[0][k])
                for k in ("wte", "wpe", "ln_f", "lm_head") if k in stages[0]
            }
        self.rope = {s: transformer.get_rope_cache(cfg, device=self.mesh[s]) for s in self.owned}
        dev0 = self.mesh[self.owned[0]]
        self.rng_seed = int(rng_seed)
        self.rng = rng_for(dev0, self.rng_seed)
        one_device = ring is None and len(
            {str(d) for devs in self.ranks.values() for d in devs}) == 1
        self._graphs = (one_device and dev0.type == "cuda") if _graphs is None else bool(_graphs)
        if self._graphs and not one_device:
            raise ValueError("the ring is captured only when every stage runs in one "
                             "process on one device")
        self._caches: Dict[int, Dict[int, Any]] = {}
        self._steps: Dict[tuple, StepGraph] = {}
        self._empty_chunk_cache: Dict[int, Dict[str, torch.Tensor]] = {}
        # the decode payload entering each owned stage: persistent buffers
        # that the decode chunk reads (a graph at their fixed addresses)
        # and that each call's new payload is copied into
        D = cfg.n_embd
        self._pay = {
            s: (torch.zeros(self.M, 1, D, dtype=self.dtype, device=self.mesh[s]),
                torch.full((1,), self.n_slots - 1, dtype=torch.long, device=self.mesh[s]),
                torch.zeros(self.M, dtype=torch.long, device=self.mesh[s]),
                torch.zeros(self.M, dtype=torch.long, device=self.mesh[s]))
            for s in self.owned
        }

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _kv(self, cache_len: int) -> Dict[int, Any]:
        """Each owned stage's cache (layers, n_slots, M, G, cache_len, hs)
        for runs of this cache length, kept between calls (with tp > 1 one
        per rank, each over its G/tp groups, on the rank's device); the
        caches and steps of other lengths are dropped."""
        if cache_len not in self._caches:
            self._caches = {}
            self._steps = {k: v for k, v in self._steps.items() if k[0] == cache_len}
            cfg = transformer.shard_config(self.cfg, self.tp)

            def cache(s, dev):
                return {name: torch.zeros(
                    (self.counts[s], self.n_slots, self.M, cfg.n_query_groups, cache_len,
                     cfg.head_size), dtype=self.cache_dtype, device=dev)
                    for name in ("k", "v")}

            self._caches[cache_len] = {
                s: cache(s, self.mesh[s]) if self.tp == 1
                else [cache(s, d) for d in self.ranks[s]]
                for s in self.owned
            }
        return self._caches[cache_len]

    @staticmethod
    def _zero_caches(kv) -> None:
        for c in kv.values():
            for cache in c if isinstance(c, list) else [c]:
                for x in cache.values():
                    x.zero_()

    def _reset_payload(self) -> None:
        for x, sid, pos, val in self._pay.values():
            x.zero_()
            sid.fill_(self.n_slots - 1)
            pos.zero_()
            val.zero_()

    def graph_stats(self) -> Dict[str, Any]:
        """The decode-chunk steps held now: built, captured, replayed,
        capture seconds."""
        return summarize(self._steps.values())

    # ------------------------------------------------------------------
    # one stage, one micro-step
    # ------------------------------------------------------------------

    @staticmethod
    def _slot(cache: torch.Tensor) -> torch.Tensor:
        # 1-byte floats gather as bytes (index kernels need not cover float8)
        return cache.view(torch.uint8) if cache.element_size() == 1 else cache

    def _stage_forward(self, s: int, kv, x, sid, input_pos) -> torch.Tensor:
        """Stage s's blocks on x (M, T, D), the M samples of ring slot `sid`
        (1,), at per-sample cache offsets `input_pos` (M,); reads and
        writes that slot of the stage's cache (of every rank's, over its
        tp ranks).  Positions are clamped to the cache: only bubble lanes
        ever reach past it."""
        T = x.shape[1]
        caches = kv[s] if self.tp > 1 else [kv[s]]
        cache_len = caches[0]["k"].shape[4]
        input_pos = input_pos.clamp(0, cache_len - T)
        pos = input_pos[:, None] + torch.arange(T, device=x.device)[None, :]
        cos, sin = gather_rope(*self.rope[s], pos)
        slots = [{name: self._slot(c).index_select(1, sid.to(c.device))[:, 0].view(c.dtype)
                  for name, c in cache.items()} for cache in caches]
        attn = dict(input_pos=input_pos, fresh_prefill=False, use_flash=False)
        with torch.no_grad():
            if self.tp == 1:
                out = transformer.run_blocks(self.cfg, self.stage_blocks[s], x, pos, cos, sin,
                                             slots[0], **attn)
            else:
                out = self._tp_ranks[s].stage(self._tp_layers[s], x, pos, cos, sin, slots,
                                              **attn)
        for cache, slot in zip(caches, slots):
            for name, c in cache.items():
                self._slot(c).index_copy_(1, sid.to(c.device), self._slot(slot[name])[:, None])
        return out

    def _advance(self, pay: Dict[int, Payload], proc0: Optional[Payload], kv,
                 input_pos: Dict[int, torch.Tensor]) -> Dict[int, Payload]:
        """Every owned stage runs its blocks on its payload (stage 0 on
        `proc0`); then each payload moves one stage on: a shift inside the
        process, a copy to another device, a send/recv to the next
        process."""
        outs = {}
        for s in self.owned:
            x, sid, pos, val = proc0 if s == 0 else pay[s]
            outs[s] = (self._stage_forward(s, kv, x, sid, input_pos.get(s, pos)), sid, pos, val)
        new: Dict[int, Payload] = {}
        S = self.n_stages
        for s in self.owned:
            nxt = (s + 1) % S
            if nxt in self.mesh:
                dev = self.mesh[nxt]
                new[nxt] = tuple(t.to(dev, non_blocking=True) for t in outs[s])
        if self.ring is not None:
            new[self.owned[0]] = self.ring.hop(outs[self.owned[-1]])
        return new

    # ------------------------------------------------------------------
    # the prefill ring (eager)
    # ------------------------------------------------------------------

    def _prefill_ring(self, kv, W: int, T: int, prompts=None, lens=None, gvalid=None,
                      slots=None, sampling=None):
        """W slot groups (each M prompts of bucket width T) injected one per
        micro-step over W + S micro-steps; stage 0 samples each group's
        first tokens as it comes back.  Returns stage 0's emissions (toks
        (n, M), sids (n,), vals (n, M)) on the device, None elsewhere."""
        S, M, dummy = self.n_stages, self.M, self.n_slots - 1
        D = self.cfg.n_embd
        pay = {s: (torch.zeros(M, T, D, dtype=self.dtype, device=self.mesh[s]),
                   torch.full((1,), dummy, dtype=torch.long, device=self.mesh[s]),
                   torch.zeros(M, dtype=torch.long, device=self.mesh[s]),
                   torch.zeros(M, dtype=torch.long, device=self.mesh[s]))
               for s in self.owned}
        zeros = {s: torch.zeros(M, dtype=torch.long, device=self.mesh[s]) for s in self.owned}
        emits = []
        if 0 in self.mesh:
            dev = self.mesh[0]
            grid = torch.arange(T, device=dev)[None, :].expand(M, T)
            rows = torch.arange(M, device=dev)
            dummy_t = torch.full((1,), dummy, dtype=torch.long, device=dev)
        for step in range(W + S):
            proc0 = None
            if 0 in self.mesh:
                x0, sid0, pos0, val0 = pay[0]
                idx = (pos0 - 1).clamp(0, T - 1)
                with torch.no_grad():
                    logits = transformer.head(self.cfg, self.head_params, x0[rows, idx][:, None])[:, 0]
                tok = sample(logits, self.rng, **sampling)
                emits.append((tok, sid0, val0))
                g = min(step, W - 1)
                emb = transformer.embed(self.cfg, self.head_params, prompts[g], grid)
                inject = step < W
                proc0 = (emb.to(self.dtype), slots[g : g + 1] if inject else dummy_t,
                         lens[g], gvalid[g] * int(inject))
            pay = self._advance(pay, proc0, kv, zeros)
        if not emits:
            return None
        return tuple(torch.stack(e) for e in zip(*emits))

    # ------------------------------------------------------------------
    # the decode ring: R * S micro-steps, a CUDA graph on the card
    # ------------------------------------------------------------------

    def _decode_body(self, *, kv, n_steps: int, mode: str, top_k, flag, sid, tok, pos,
                     val, t_op, p_op):
        """n_steps decode micro-steps from the persistent payload, with the
        per-micro-step overrides (flag/tok/pos/val (n, M), sid (n,)).
        Returns stage 0's emissions (toks (n, M), sids (n, 1), vals (n, M);
        none elsewhere) followed by the new payload of every owned stage,
        flat: the body leaves the payload buffers as they were, so a
        graph's warm-up run before its capture moves nothing on."""
        pay = dict(self._pay)
        emits = []
        for i in range(n_steps):
            proc0 = None
            if 0 in self.mesh:
                x0, sid0, pos0, val0 = pay[0]
                with torch.no_grad():
                    logits = transformer.head(self.cfg, self.head_params, x0)[:, -1]
                t = sample_traced(logits, self.rng, t_op, p_op, mode=mode, top_k=top_k)
                emits.append((t, sid0, val0))
                # per-lane overrides: seed a slot after a prefill, or feed a
                # queued prompt's tokens into a freed lane
                use = flag[i] == 1
                tok_sel = torch.where(use, tok[i], t)
                pos_sel = torch.where(use, pos[i], pos0 + 1)
                val_sel = torch.where(use, val[i], val0)
                sid_sel = torch.where(use.any(), sid[i : i + 1], sid0)
                emb = transformer.embed(self.cfg, self.head_params, tok_sel[:, None],
                                        pos_sel[:, None])
                proc0 = (emb.to(self.dtype), sid_sel, pos_sel, val_sel)
            pay = self._advance(pay, proc0, kv, {})
        out = tuple(torch.stack(e) for e in zip(*emits))
        return out + tuple(t for s in self.owned for t in pay[s])

    def _decode_step(self, cache_len: int, n_steps: int, mode: str, top_k) -> StepGraph:
        key = (cache_len, n_steps, mode, top_k)
        if key not in self._steps:
            dev, M = self.mesh[self.owned[0]], self.M

            def buf(*shape, dtype=torch.long):
                return torch.zeros(shape, dtype=dtype, device=dev)

            self._steps[key] = StepGraph(
                "pipeline.decode_chunk", key, self, PipelineEngine._decode_body,
                dict(flag=buf(n_steps, M), sid=buf(n_steps), tok=buf(n_steps, M),
                     pos=buf(n_steps, M), val=buf(n_steps, M),
                     t_op=buf(dtype=torch.float32), p_op=buf(dtype=torch.float32)),
                static=dict(kv=self._kv(cache_len), n_steps=n_steps, mode=mode, top_k=top_k),
                capture=self._graphs, generators=[self.rng],
            )
        return self._steps[key]

    def _run_decode(self, cache_len, ov, mode, top_k, t_val, p_val):
        """One decode ring call over the overrides `ov` (host arrays or
        device tensors, (n, M) / (n,)); returns the emissions on the
        device (stage 0) or None."""
        n_steps = int(ov["flag"].shape[0])
        step = self._decode_step(cache_len, n_steps, mode, top_k)
        outs = step.run(t_op=t_val, p_op=p_val, **ov)
        n_emit = 3 if 0 in self.mesh else 0
        new = iter(outs[n_emit:])
        for s in self.owned:
            for buf in self._pay[s]:
                buf.copy_(next(new))
        return outs[:n_emit] or None

    # ------------------------------------------------------------------
    # the multi-process command channel
    # ------------------------------------------------------------------

    def _command(self, cmd: dict) -> None:
        """Process 0: tell the other processes what comes next."""
        if self.ring is not None:
            self.ring.broadcast_object(cmd)

    def _follow(self) -> Tuple[List[List[int]], GenerationStats]:
        """A process other than 0: run every ring call process 0 announces
        on this process's stages, until it sends the outputs."""
        cache_len = None
        while True:
            cmd = self.ring.broadcast_object(None)
            op = cmd["op"]
            if op == "begin":
                cache_len = cmd["cache_len"]
                self._zero_caches(self._kv(cache_len))
            elif op == "prefill":
                self._prefill_ring(self._kv(cache_len), cmd["W"], cmd["T"])
            elif op == "decode":
                if cmd["reseed"]:
                    self._reset_payload()
                ov = {k: torch.as_tensor(v) for k, v in cmd["ov"].items()}
                self._run_decode(cache_len, ov, cmd["mode"], cmd["top_k"], *cmd["operands"])
            elif op == "end":
                stats = GenerationStats(**cmd["stats"])
                return cmd["outs"], stats
            elif op == "abort":
                raise PipelineAbort(f"process 0 stopped the run: {cmd['msg']}")
            else:
                raise PipelineAbort(f"unknown ring command {op!r}")

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
        temperature: float = TEMPERATURE,
        top_k: Optional[int] = TOP_K,
        top_p: Optional[float] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
        stream_cb=None,
    ) -> Tuple[List[List[int]], GenerationStats]:
        """Continuations of the prompts by recurrent pipeline parallelism
        with continuous sample scheduling; returns (token lists with the
        prompts, cut at stop sequences; stats).

        `stream_cb(sample_idx, token)` is called per generated token as its
        emission is read (per chunk of rotations in the steady state).
        Tokens past a sample's stop sequence are not streamed; the stop
        sequence's own tokens are (the returned lists are cut).

        On a process other than 0 of a multi-process ring the arguments
        are ignored: the process runs the ring calls process 0 makes and
        returns process 0's outputs and stats."""
        if self.ring is not None and self.ring.rank != 0:
            return self._follow()
        stats = GenerationStats()
        t_all = time.perf_counter()
        if not prompts:
            self._command({"op": "end", "outs": [], "stats": vars(stats)})
            return [], stats
        graphs0 = self.graph_stats()
        try:
            results = self._generate_continuous(
                list(prompts), max_new_tokens, temperature, top_k, top_p,
                stop_sequences, stats, t_all, stream_cb,
            )
        except BaseException as e:
            self._command({"op": "abort", "msg": f"{type(e).__name__}: {e}"})
            raise
        stats.decode_s = time.perf_counter() - t_all - stats.prefill_s
        stats.tokens_generated = sum(len(o) - len(p) for o, p in zip(results, prompts))
        graphs = self.graph_stats()
        stats.captures = graphs["captures"] - graphs0["captures"]
        stats.capture_s = graphs["capture_s"] - graphs0["capture_s"]
        self._command({"op": "end", "outs": results, "stats": vars(stats)})
        return results, stats

    def _stage0_emits(self, emits):
        """Host view of one call's emissions: tokens (n, M), slot ids (n,),
        valid flags (n, M), in one read."""
        toks, sids, vals = (e.cpu().numpy() for e in emits)
        return toks, sids[:, 0], vals

    def _empty_overrides(self):
        S, M = self.n_stages, self.M
        return {
            "flag": np.zeros((S, M), np.int64),
            "sid": np.full((S,), self.n_slots - 1, np.int64),
            "tok": np.zeros((S, M), np.int64),
            "pos": np.zeros((S, M), np.int64),
            "val": np.zeros((S, M), np.int64),
        }

    def _empty_chunk(self, n_rot: int):
        """Empty overrides for n_rot rotations (n_rot * S micro-steps), on
        stage 0's device, made once per n_rot."""
        if n_rot not in self._empty_chunk_cache:
            dev = self.mesh[0]
            self._empty_chunk_cache[n_rot] = {
                k: torch.as_tensor(np.concatenate([v] * n_rot, axis=0), device=dev)
                for k, v in self._empty_overrides().items()
            }
        return self._empty_chunk_cache[n_rot]

    def _generate_continuous(
        self, prompts, max_new_tokens, temperature, top_k, top_p,
        stop_sequences, stats, t_all, stream_cb=None,
    ):
        S, M = self.n_stages, self.M
        N = len(prompts)
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        if max(lens) + max_new_tokens > self.max_seq_length:
            raise ValueError(
                f"prompt+generation length {max(lens) + max_new_tokens} exceeds "
                f"max_seq_length {self.max_seq_length}"
            )
        dev0 = self.mesh[0]
        sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        mode = sample_mode(temperature, top_k, top_p)
        t_val, p_val = operand_values(temperature, top_p)

        # ---- initial batch: the first S*M samples, packed in groups of M ----
        n_init = min(N, S * M)
        n_groups = -(-n_init // M)
        Tb = min(_bucket(max(lens[:n_init])), self.max_seq_length)
        prompts_np = np.zeros((n_groups, M, Tb), np.int64)
        lens_np = np.ones((n_groups, M), np.int64)
        valid_np = np.zeros((n_groups, M), np.int64)
        for i in range(n_init):
            g, m = divmod(i, M)
            prompts_np[g, m, : lens[i]] = np.asarray(prompts[i], np.int64)
            lens_np[g, m] = lens[i]
            valid_np[g, m] = 1

        # the cache covers the generation horizon and every prompt bucket
        cache_len = _run_cache_len(
            self.max_seq_length,
            max(lens) + max_new_tokens,
            min(_bucket(max(lens)), self.max_seq_length),
        )
        self._command({"op": "begin", "cache_len": cache_len})
        kv = self._kv(cache_len)
        self._zero_caches(kv)

        out = [list(p) for p in prompts]
        done = [False] * N

        def accept(j, tok):
            out[j].append(tok)
            if stream_cb is not None:
                stream_cb(j, tok)

        def budget(j):
            gen = len(out[j]) - lens[j]
            return min(max_new_tokens - gen, self.max_seq_length - len(out[j]))

        def run_prefill(p_np, l_np, v_np, slots_np):
            """One pipelined prefill of whole slot groups; returns
            {(slot, m): first token}."""
            t_p = time.perf_counter()
            W, _, T = p_np.shape
            self._command({"op": "prefill", "W": W, "T": T})

            def dev(a):
                return torch.as_tensor(a, dtype=torch.long, device=dev0)

            emits = self._prefill_ring(kv, W, T, dev(p_np), dev(l_np), dev(v_np),
                                       dev(slots_np), sampling)
            toks_e, sids_e, vals_e = self._stage0_emits(emits)
            firsts = {}
            slot_set = set(int(s) for s in slots_np)
            for t_row, s, v_row in zip(toks_e, sids_e, vals_e):
                s = int(s)
                if s in slot_set:
                    for m in range(M):
                        if v_row[m]:
                            firsts[(s, m)] = int(t_row[m])
            stats.prefill_s += time.perf_counter() - t_p
            return firsts

        # ---- phase 1: pipelined parallel prefill of the initial batch ----
        firsts = run_prefill(prompts_np, lens_np, valid_np, np.arange(n_groups))
        assert len(firsts) == n_init, f"prefill returned {len(firsts)}/{n_init}"

        queue = list(range(n_init, N))  # samples not yet on the ring
        active: Dict[Tuple[int, int], int] = {}  # lane -> generating sample
        filling: Dict[Tuple[int, int], List[int]] = {}  # lane -> [sample, next_idx]
        # emissions arriving in call r were fed in call r-1: lane -> sample
        fed_prev: Dict[Tuple[int, int], int] = {}
        fed_cur: Dict[Tuple[int, int], int] = {}

        for (g, m), tok in firsts.items():
            j = g * M + m
            accept(j, tok)
            if detect_stop_tokens(out[j][lens[j]:], stop_sequences) or budget(j) <= 0:
                done[j] = True
            else:
                active[(g, m)] = j

        empty_ov = self._empty_chunk(1)

        def batch_refills():
            """Prefill queued prompts into fully free slots (a prefill
            rewrites all M lanes of its slot).  True if the ring must be
            re-seeded."""
            busy_slots = {g for (g, m) in (*active, *filling)}
            free = [g for g in range(S) if g not in busy_slots]
            if not queue or not free:
                return False
            K = min(len(free), -(-len(queue) // M))
            take = queue[: K * M]
            del queue[: K * M]
            Tb2 = min(_bucket(max(lens[j] for j in take)), self.max_seq_length)
            # the group count padded to a power of two (the JAX package's
            # bounded set of compiled shapes); padded groups are invalid and
            # write only the dummy slot
            Kp = 1 << (K - 1).bit_length()
            p_np = np.zeros((Kp, M, Tb2), np.int64)
            l_np = np.ones((Kp, M), np.int64)
            v_np = np.zeros((Kp, M), np.int64)
            slots_np = np.full((Kp,), self.n_slots - 1, np.int64)
            slots_np[:K] = free[:K]
            lane_of = {}
            for i, j in enumerate(take):
                k_, m = divmod(i, M)
                p_np[k_, m, : lens[j]] = np.asarray(prompts[j], np.int64)
                l_np[k_, m] = lens[j]
                v_np[k_, m] = 1
                lane_of[(free[k_], m)] = j
            firsts = run_prefill(p_np, l_np, v_np, slots_np)
            assert len(firsts) == len(take), f"refill prefill returned {len(firsts)}/{len(take)}"
            for lane, tok in firsts.items():
                j = lane_of[lane]
                accept(j, tok)
                if detect_stop_tokens(out[j][lens[j]:], stop_sequences) or budget(j) <= 0:
                    done[j] = True
                else:
                    active[lane] = j
            return True

        def schedule_token_refills():
            """Queued samples into free lanes of partially busy slots, their
            prompts fed one token per rotation."""
            if not queue:
                return
            busy = set(active) | set(filling)
            for g in range(S):
                n_busy = sum((g, m) in busy for m in range(M))
                if n_busy == 0 or n_busy == M:
                    continue
                for m in range(M):
                    if not queue:
                        return
                    if (g, m) not in busy:
                        filling[(g, m)] = [queue.pop(0), 0]
                        stats.token_fills += 1

        def build_reseed_ov():
            """After a prefill the ring payload is discarded: re-feed every
            surviving lane's last token (rewriting its KV is idempotent)
            and the filling lanes' prompt tokens, in one seeding rotation."""
            ov = self._empty_overrides()
            fed = {}
            for (g, m), j in active.items():
                ov["flag"][g, m] = 1
                ov["sid"][g] = g
                ov["tok"][g, m] = out[j][-1]
                ov["pos"][g, m] = len(out[j]) - 1
                ov["val"][g, m] = 1
                fed[(g, m)] = j
            for (g, m), st in filling.items():
                j, idx = st
                ov["flag"][g, m] = 1
                ov["sid"][g] = g
                fed[(g, m)] = j
                if idx == 0:
                    ov["tok"][g, m] = prompts[j][0]
                    ov["pos"][g, m] = 0
                    ov["val"][g, m] = 1 if lens[j] == 1 else 0
                    st[1] = 1
                else:
                    ov["tok"][g, m] = prompts[j][idx - 1]
                    ov["pos"][g, m] = idx - 1
                    ov["val"][g, m] = 0
            return ov, fed

        def build_step_ov():
            """Feed one prompt token per filling lane this rotation."""
            fed = dict(active)
            if not filling:
                return empty_ov, fed
            ov = self._empty_overrides()
            for (g, m), st in filling.items():
                j, idx = st
                ov["flag"][g, m] = 1
                ov["sid"][g] = g
                ov["tok"][g, m] = prompts[j][idx]
                ov["pos"][g, m] = idx
                ov["val"][g, m] = 1 if idx == lens[j] - 1 else 0
                fed[(g, m)] = j
                st[1] = idx + 1
            return ov, fed

        def collect(host, fed_map):
            """Accept one call's emissions (tokens fed one rotation before
            each row, per fed_map)."""
            toks_e, sids_e, vals_e = host
            for t_row, s, v_row in zip(toks_e, sids_e, vals_e):
                s = int(s)
                for m in range(M):
                    j = fed_map.get((s, m))
                    if j is None or not v_row[m] or done[j]:
                        continue
                    accept(j, int(t_row[m]))
                    if detect_stop_tokens(out[j][lens[j]:], stop_sequences) or budget(j) <= 0:
                        done[j] = True
                        active.pop((s, m), None)
            if fed_map:
                stats.tok_time.append(
                    (sum(len(o) - l for o, l in zip(out, lens)), time.perf_counter() - t_all)
                )
            # a lane whose last prompt token was just fed now generates
            for lane in list(filling):
                j, idx = filling[lane]
                if idx >= lens[j]:
                    del filling[lane]
                    active[lane] = j

        def fetch(emits):
            """Queue the emissions' copy to the host now (a graph's outputs
            are overwritten by its next replay); read them later."""
            if dev0.type != "cuda":
                return self._stage0_emits(emits), None
            host = tuple(e.to("cpu", non_blocking=True) for e in emits)
            ev = torch.cuda.Event()
            ev.record()
            return host, ev

        def land(fetched):
            host, ev = fetched
            if ev is None:
                return host
            ev.synchronize()
            toks, sids, vals = (h.numpy() for h in host)
            return toks, sids[:, 0], vals

        # overlap: in the steady state the next chunk runs before the
        # previous chunk's emissions are read; boundaries flush first
        pending = None

        def flush_pending():
            nonlocal pending
            if pending is not None:
                fetched, fm = pending
                pending = None
                collect(land(fetched), fm)

        need_reseed = True
        max_rot = (
            2 + 2 * S + N + sum(l + max_new_tokens for l in lens)
            + (N + 2) * self.rotations_per_call
        )
        with catch_loop_errors() as guard:
            while active or filling or queue or pending:
                if stats.rotations >= max_rot:
                    raise RuntimeError(
                        f"pipeline scheduler exceeded {max_rot} rotations with "
                        f"{len(active)} active / {len(filling)} filling / "
                        f"{len(queue)} queued samples"
                    )
                if queue:
                    flush_pending()
                if batch_refills():
                    need_reseed = True
                schedule_token_refills()
                if not (active or filling):
                    flush_pending()
                    continue
                n_rot = 1
                steady = not (need_reseed or filling)
                reseed = False
                if not steady:
                    flush_pending()
                    if need_reseed:
                        fed_prev = {}
                        reseed = True
                        ov, fed_cur = build_reseed_ov()
                        need_reseed = False
                    else:
                        fed_prev = fed_cur
                        ov, fed_cur = build_step_ov()
                else:
                    # every surviving lane feeds its own sampled token inside
                    # the call: R rotations with empty overrides, R bounded by
                    # the largest remaining budget, floored to a power of two
                    maxbud = max(budget(j) for j in active.values())
                    n_rot = max(1, min(self.rotations_per_call, maxbud))
                    n_rot = 1 << (n_rot.bit_length() - 1)
                    fed_prev = {**fed_cur, **dict(active)}
                    fed_cur = fed_prev
                    ov = self._empty_chunk(n_rot)
                    if not self.overlap_chunks:
                        flush_pending()
                if self.ring is not None:
                    self._command({
                        "op": "decode", "reseed": reseed, "mode": mode, "top_k": top_k,
                        "operands": (t_val, p_val),
                        # mdi-lint: disable-next-line=host-sync -- ships the call's operands to the secondaries once per ring call
                        "ov": {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                               for k, v in ov.items()},
                    })
                if reseed:
                    self._reset_payload()
                emits = self._run_decode(cache_len, ov, mode, top_k, t_val, p_val)
                stats.rotations += n_rot
                fetched = fetch(emits)
                if steady and self.overlap_chunks:
                    flush_pending()  # the previous chunk, under this one
                    pending = (fetched, fed_prev)
                else:
                    collect(land(fetched), fed_prev)

        stats.interrupted = stats.interrupted or guard.interrupted
        trimmed = []
        for o, l in zip(out, lens):
            gen = o[l:]
            trimmed.append(o[: l + find_eot(gen, stop_sequences)])
        return trimmed
