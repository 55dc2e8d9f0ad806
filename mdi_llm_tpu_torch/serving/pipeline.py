"""Pipeline-parallel serving: the paper's recurrent ring under continuous
batching.

Port of `mdi_llm_tpu/serving/pipeline.py` (`PipelinedServingEngine`).  The
model's layers split over S stages (`parallel/partition.stage_layers`, the
reference's starter/secondary table); each stage runs its true layer
count (the JAX package zero-pads every stage to the largest count so its
SPMD ring stays uniform; a zero block is an identity, so the tokens are
the same) and owns its own shard of the paged pool: stage s holds the K/V
of its own layers, `(L_s, num_blocks, block_size, G, hs)` on its device,
under the block ids the host-side `KVPool` hands out to every stage at
once.  Stage 0 also holds the embedding, the final norm and the head.
The stages' devices come from the Generator's mesh
(`parallel/mesh.pipeline_mesh`): all on one device, or one device each.

Everything on the host is the base engine's, unchanged: the scheduler,
the pool and prefix cache, preemption, the host tier (the staged pool
keeps the block axis at 1 in every leaf), double buffering, the stats and
the observer's hooks, so the host-sync cadence is the single engine's by
construction.  What changes is the device math of each step:

- **The forward** (`_forward`, which the mixed step, the per-token
  decode and the eager speculative verify all call) sweeps the ring in
  `2S - 1` ticks.  In tick t stage s runs its blocks on the microbatch in
  front of it, m = t - s, and hands the result to stage s + 1; the last
  stage collects the finished hidden states, and stage 0 applies the head
  at the base engine's shapes, so `_sample` draws at (B, V) from the same
  generator as the single engine does.
  - The packed (1, T) mixed batch pads to S segments of ceil(T/S) tokens
    (padding tokens carry the trash position, as the batch's own tail
    does).  K1 owns a row only inside its slot's span and bounds its key
    walk by the span's first position, so each segment gets its own
    spans: `q_start` and `q_len` clipped to the segment and rebased to its
    first token (`segment_spans`).
  - A (B, Tq) decode or verify batch splits into S lane groups of
    ceil(B/S) lanes; padding lanes ride zeroed table rows.
- **The decode chunk** (`_decode_chunk_body`) is the true recurrent
  ring: each lane group is a payload (activations, tokens, positions,
  stop flags) that circles the stages; when it returns to stage 0 it is
  sampled (head at (Bg, 1, D)), advanced one step under the base masks
  (limit, stop token, freeze), re-embedded and relaunched.  `K·S + S`
  ticks serve K tokens on every lane, and the body returns the base
  body's (tokens (K, B), final token, final position), so the double
  buffer chain works unchanged.  Greedy streams are the single engine's;
  sampled draws at temperature > 0 come from (Bg, V) draws, so they follow
  the same distribution but not the same draws.

Every schedule decision of a tick (which microbatch, which lane group,
which step of the chunk, whether the slot is a bubble) is known from the
tick and the stage alone, so the bodies hold no device-side control flow
and capture as they are.  Bubbles (the fill and drain ticks) and padding
lanes run through zeroed table rows, whose writes land in the stage's
trash block, as in the JAX ring; positions are clamped where the rope
table is read (`ops/rope.gather_rope`) and where a write would pass the
table (`ops/paged_attention.paged_update`).

Attention: every paged call in every stage is K1 on the card
(`use_kernel` None or True; False is the plain route, for comparisons),
where the JAX ring refuses `use_kernel=True` because its Pallas kernel is
not wired into the shard_map ring.  `stage_layer_runs` counts the stage
layers the engine ran (bubbles included): K1 launches once per count.

Where the stages run:

- all on one device (`cli.serve --pp S`): the hop is the payload itself;
  the mixed step, the decode chunk and the per-token decode are
  `StepGraph`s captured when the engine is built, as the base engine's
  are (on the card, CUDA graphs; `_graphs=False` launches eagerly);
- one device per stage: the hop copies the payload to the next stage's
  device; the steps launch eagerly.  Written, not verified on several
  cards.

A tensor-parallel axis inside each stage (`Generator(mesh=make_mesh({"pp":
S, "tp": N}, devices))`, or `pipeline_mesh(S, devices, tp=N)`; the JAX
engine splits each stage's pool on its KV-group axis the same way): each
stage's blocks are sliced per rank (`parallel.sharding.shard_ranks`) and
run over its ranks (`models.transformer.TPRanks`), its pool is one
`(L_s, num_blocks, block_size, G/tp, hs)` tree per rank under the same
block ids, and K1 runs once per stage layer and rank, on the rank's pool
slice, with the same rebased spans, its split knobs resolved on the
model's whole geometry: K1 launches = tp x `stage_layer_runs`.  The
embedding and the head stay whole on stage 0.

Refused, as by the JAX engine: a draft model (the draft pool has no ring);
a model with fewer layers than stages (`partition.stage_layers`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from mdi_llm_tpu_torch.config import ServingConfig
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.ops.rope import gather_rope
from mdi_llm_tpu_torch.parallel.partition import split_params, stage_layers
from mdi_llm_tpu_torch.parallel.sharding import shard_ranks
from mdi_llm_tpu_torch.serving.engine import ServingEngine

__all__ = ["PipelinedServingEngine", "segment_spans"]


def segment_spans(q_start: torch.Tensor, q_len: torch.Tensor, n_seg: int, seg: int):
    """Each slot's span `[q_start, q_start + q_len)` of the packed batch,
    cut to segment m = `[m·seg, (m + 1)·seg)` and rebased to the segment's
    first token: (starts, lens), each (n_seg, n_slots) int32.  A slot with
    no token in the segment gets length 0."""
    off = torch.arange(n_seg, dtype=torch.int32, device=q_start.device)[:, None] * seg
    start = (q_start.to(torch.int32)[None, :] - off).clamp(0, seg)
    end = (q_start.to(torch.int32)[None, :] + q_len.to(torch.int32)[None, :] - off).clamp(0, seg)
    return start, end - start


class PipelinedServingEngine(ServingEngine):
    """Continuous-batching engine over a pipeline mesh of S >= 2 stages.
    Build it with `Generator(mesh=pipeline_mesh(S, devices)).serve(...)`;
    the request surface, scheduler, results and stats are the base
    engine's."""

    _step_counters = ("forward_calls", "stage_layer_runs")

    def __init__(self, gen, serving: ServingConfig, obs=None, policy=None,
                 draft_gen=None, _graphs=None):
        if serving.draft_model or draft_gen is not None:
            raise ValueError(
                "draft_model is not supported by the pipeline-parallel "
                "engine: the draft pool has no per-stage ring — serve "
                "the draft-model config on a single-device Generator"
            )
        mesh = gen.mesh
        if mesh is None or len(mesh) <= 1:
            raise ValueError(
                "PipelinedServingEngine needs a pipeline mesh of >= 2 stages "
                "(Generator(mesh=parallel.mesh.pipeline_mesh(S, devices))); "
                "for single-device serving use ServingEngine"
            )
        S = len(mesh)
        cfg = gen.cfg
        # raises when n_layer < S: every stage needs a block
        self._stage_counts = stage_layers(cfg.n_layer, S)
        self._pp = S
        self._ranks = [gen.stage_ranks[s] for s in range(S)]  # each stage's tp ranks
        self._tp = len(self._ranks[0])
        self._stage_dev = [devs[0] for devs in self._ranks]
        one_device = len({d for devs in self._ranks for d in devs}) == 1
        if _graphs and not one_device:
            raise ValueError("the ring's steps are captured only when every stage "
                             "runs on one device")
        stages = split_params(cfg, gen.params, S)
        if self._tp == 1:
            self._stage_blocks = [
                transformer.tree_map(lambda x, d=dev: x.to(d), st["blocks"])
                for st, dev in zip(stages, self._stage_dev)
            ]
        else:
            # each stage's blocks sliced per rank (views on a rank that
            # shares the weights' device), run over its ranks
            self._stage_tp = [
                transformer.TPRanks(cfg, shard_ranks(cfg, {"blocks": st["blocks"]}, devs))
                for st, devs in zip(stages, self._ranks)]
            self._stage_layers = [tr.layers() for tr in self._stage_tp]
        self._head = {k: stages[0][k] for k in ("wte", "wpe", "ln_f", "lm_head")
                      if k in stages[0]}
        self._stage_rope = [tuple(r.to(d) for r in gen.rope) for d in self._stage_dev]
        self._x_dtype = transformer.param_dtype(gen.params)  # the activations'
        self.stage_layer_runs = 0  # stage layers run (bubbles included)
        super().__init__(gen, serving, obs=obs, policy=policy,
                         _graphs=_graphs if one_device else False)

    # -- the staged pool -----------------------------------------------------

    def _init_pool(self, num_blocks: int, bs: int):
        """{stage: pool of (L_s, num_blocks, bs, G, hs)} on each stage's
        device, or over tp ranks {stage: {rank: (L_s, num_blocks, bs, G/tp,
        hs) on the rank's device}} (the int8 pool's scales (L_s,
        num_blocks, G/tp)): one block id indexes every stage's and every
        rank's pool, and each stores only its own layers' and groups' K/V
        under it."""
        cfg = transformer.shard_config(self.gen.cfg, self._tp)

        def pool(s, dev):
            return transformer.init_paged_kv_cache(
                cfg, num_blocks, bs, dtype=self._pool_dtype, device=dev,
                n_layer=self._stage_counts[s])

        if self._tp == 1:
            return {s: pool(s, self._stage_dev[s]) for s in range(self._pp)}
        kv = {s: {r: pool(s, d) for r, d in enumerate(self._ranks[s])}
              for s in range(self._pp)}
        # K1's split knobs on the model's whole geometry, as the tp
        # engine's `sharded_forward` resolves them
        self._k1_params = None
        dev = self._stage_dev[0]
        if dev.type != "cpu" and self.cfg.use_kernel is not False:
            from mdi_llm_tpu_torch.ops import tuning
            from mdi_llm_tpu_torch.ops.ragged_paged_attention import _pool_parts

            full = self.gen.cfg
            self._k1_params = tuning.global_kernel_params(
                full.n_head, full.n_query_groups, full.head_size, bs, self._x_dtype,
                _pool_parts(kv[0][0]["k"])[0].dtype, dev)
        return kv

    def _step_params(self, gen):
        """The weights as the ring reads them (the compile set's "params"):
        {stage: its blocks, with the embedding, final norm and head on
        stage 0}, or over tp ranks {stage: {rank: its per-layer views}}, the
        head whole on stage 0's first rank (views of the one tree)."""
        if self._tp == 1:
            return {s: {"blocks": b, **(self._head if s == 0 else {})}
                    for s, b in enumerate(self._stage_blocks)}
        return {s: {r: {"blocks": lay, **(self._head if s == 0 and r == 0 else {})}
                    for r, lay in enumerate(layers)}
                for s, layers in enumerate(self._stage_layers)}

    # -- topology (cli reporting) ---------------------------------------------

    @property
    def n_stages(self) -> int:
        return self._pp

    def pipeline_fill(self) -> Dict[str, Any]:
        """The JAX engine's fill model: lanes (max_batch), stages, each
        stage's layers, and the steady-state bubble fraction
        1 - min(lanes, stages) / stages when the lanes cannot cover the
        ring (every stage idles alike)."""
        lanes = self.scheduler.max_batch
        fill = min(lanes, self._pp) / self._pp
        return {
            "stages": self._pp,
            "lanes": lanes,
            "stage_layers": list(self._stage_counts),
            "bubble_fraction": round(max(0.0, 1.0 - fill), 4),
            "stage_occupancy": [round(fill, 4)] * self._pp,
        }

    # -- one stage -------------------------------------------------------------

    def _to(self, s: int, t: torch.Tensor) -> torch.Tensor:
        return t.to(self._stage_dev[s], non_blocking=True)

    def _stage(self, s: int, x, pos, tables, ragged=None) -> torch.Tensor:
        """Stage s's blocks on x (B, T, D) at positions pos (B, T), through
        its own pool (over tp ranks, each rank's K1 on its own pool slice
        with the same tables and spans); `tables` is zeroed for a
        bubble."""
        self.stage_layer_runs += self._stage_counts[s]
        pos = self._to(s, pos).long()
        cos, sin = gather_rope(*self._stage_rope[s], pos)
        if ragged is not None:
            ragged = tuple(self._to(s, r) for r in ragged)
        attn = dict(paged_tables=self._to(s, tables), paged_kernel=self.cfg.use_kernel,
                    paged_ragged=ragged)
        x = self._to(s, x)
        if self._tp == 1:
            return transformer.run_blocks(self.gen.cfg, self._stage_blocks[s], x, pos, cos,
                                          sin, self._kv[s], **attn)
        kv = [self._kv[s][r] for r in range(self._tp)]
        return self._stage_tp[s].stage(self._stage_layers[s], x, pos, cos, sin, kv,
                                       paged_params=self._k1_params, **attn)

    def _embed(self, tokens, pos) -> torch.Tensor:
        return transformer.embed(self.gen.cfg, self._head, tokens, pos.long())

    # -- the forward: a 2S - 1 tick sweep --------------------------------------

    def _forward(self, tokens, pos, tables, paged_ragged=None) -> torch.Tensor:
        """The model forward over the ring (the base engine's contract:
        logits of every row; the stage pools are updated in place)."""
        self.forward_calls += 1
        return transformer.head(self.gen.cfg, self._head,
                                self._ring(tokens, pos, tables, paged_ragged))

    def _ring(self, tokens, pos, tables, paged_ragged=None) -> torch.Tensor:
        """The finished hidden states of one sweep, on stage 0's device:
        (1, T, D) for a packed mixed batch (`paged_ragged` = (q_slot,
        q_start, q_len), pos (1, T)), else (B, Tq, D) for tokens (B, Tq)
        at chunk starts pos (B,)."""
        S = self._pp
        if paged_ragged is not None:
            q_slot, q_start, q_len = paged_ragged
            T = tokens.shape[1]
            seg = -(-T // S)
            pad = seg * S - T
            trash = self.max_blocks_per_seq * self.pool.block_size
            tok_m = F.pad(tokens[0], (0, pad)).view(S, 1, seg)
            pos_m = F.pad(pos[0], (0, pad), value=trash).view(S, 1, seg)
            slot_m = F.pad(q_slot, (0, pad)).view(S, seg)
            start_m, len_m = segment_spans(q_start, q_len, S, seg)

            def micro(m):
                return (tok_m[m], pos_m[m], tables,
                        (slot_m[m], start_m[m], len_m[m]))

            hidden = self._sweep(micro, seg)
            return hidden.reshape(1, S * seg, -1)[:, :T]
        B, Tq = tokens.shape
        Bg = -(-B // S)
        pad = Bg * S - B
        tok_p = F.pad(tokens, (0, 0, 0, pad))
        pos_p = F.pad(pos, (0, pad))[:, None] + torch.arange(Tq, device=pos.device)
        tbl_p = F.pad(tables, (0, 0, 0, pad))

        def micro(g):
            rows = slice(g * Bg, (g + 1) * Bg)
            return tok_p[rows], pos_p[rows], tbl_p[rows], None

        return self._sweep(micro, Tq).reshape(S * Bg, Tq, -1)[:B]

    def _sweep(self, micro, width: int) -> torch.Tensor:
        """2S - 1 ticks over the S microbatches `micro(m)` = (tokens (b,
        width), positions (b, width), tables, ragged spans or None): in tick
        t stage s runs microbatch t - s and passes it on; the last stage's
        outputs, stacked (S, b, width, D), on stage 0's device.  A stage
        with no microbatch in front of it (the fill and the drain) runs a
        bubble through zeroed tables."""
        S = self._pp
        done: List[torch.Tensor] = [None] * S
        x_in: Dict[int, torch.Tensor] = {}
        zero_tables = None
        for t in range(2 * S - 1):
            outs = {}
            for s in range(S):
                m = t - s
                valid = 0 <= m < S
                tok, pos, tables, ragged = micro(min(max(m, 0), S - 1))
                if zero_tables is None:
                    zero_tables = torch.zeros_like(tables)
                if s == 0:
                    x = self._embed(tok, pos)
                else:
                    x = x_in.get(s)
                    if x is None:  # the fill has not reached this stage
                        x = torch.zeros(tok.shape + (self.gen.cfg.n_embd,),
                                        dtype=self._x_dtype, device=self._stage_dev[s])
                out = self._stage(s, x, pos, tables if valid else zero_tables, ragged)
                if valid and s == S - 1:
                    done[m] = out
                outs[s] = out
            x_in = {s + 1: self._to(s + 1, outs[s]) for s in range(S - 1)}
        return torch.stack([self._to(0, h) for h in done])

    # -- the decode chunk: the recurrent ring ----------------------------------

    def _decode_chunk_body(self, tok, pos, tables, limit, stop_tok):  # mdi-lint: captured
        """K = decode_chunk decode steps as one ring of K·S + S ticks (the
        JAX `_decode_chunk_fn`).  Lane group g leaves stage 0 at tick g;
        whenever it returns to stage 0 it is sampled, advanced under the
        base masks (a lane advances while its step is below its limit and
        it has not sampled its stop token; a frozen lane re-forwards its
        last token and position, which rewrites the identical K/V) and
        relaunched.  Returns the base body's (tokens (K, B), final token,
        final position)."""
        cfg, S, K = self.gen.cfg, self._pp, self.cfg.decode_chunk
        B = tok.shape[0]
        Bg = -(-B // S)
        pad = Bg * S - B
        tok_p, pos_p, lim_p = (F.pad(a, (0, pad)) for a in (tok, pos, limit))
        stop_p = F.pad(stop_tok, (0, pad), value=-1)
        tbl_p = F.pad(tables, (0, 0, 0, pad))
        rows = [slice(g * Bg, (g + 1) * Bg) for g in range(S)]
        zero_tables = torch.zeros_like(tbl_p[rows[0]])
        toks: List[List[torch.Tensor]] = [[None] * S for _ in range(K)]
        final: List[Tuple[torch.Tensor, torch.Tensor]] = [None] * S
        # the payload in front of each stage: (x, tok, pos, stopped)
        pay: Dict[int, Tuple[torch.Tensor, ...]] = {}
        for tau in range(K * S + S):
            new = {}
            for s in range(S):
                launched = tau - s  # the tick this payload left stage 0
                g = launched % S
                if s == 0:
                    if tau < S:  # fill: inject group tau
                        t_g, p_g = tok_p[rows[g]], pos_p[rows[g]]
                        d_g = torch.zeros_like(t_g, dtype=torch.bool)
                    else:  # group g is back: its step k
                        x, t_g, p_g, d_g = pay[0]
                        k = tau // S - 1
                        logits = transformer.head(cfg, self._head, x)[:, -1]
                        active = (lim_p[rows[g]] > k) & ~d_g
                        t_g = torch.where(active, self._sample(logits), t_g)
                        d_g = d_g | (active & (t_g == stop_p[rows[g]]))
                        p_g = p_g + active.to(p_g.dtype)
                        toks[k][g] = t_g
                        if k == K - 1:
                            final[g] = (t_g, p_g)
                    x = self._embed(t_g[:, None], p_g[:, None])
                elif launched < 0:  # the fill has not reached this stage
                    t_g = torch.zeros(Bg, dtype=tok.dtype, device=self._stage_dev[s])
                    p_g, d_g = t_g, t_g.bool()
                    x = torch.zeros(Bg, 1, cfg.n_embd, dtype=self._x_dtype,
                                    device=self._stage_dev[s])
                else:
                    x, t_g, p_g, d_g = pay[s]
                valid = 0 <= launched < K * S
                x = self._stage(s, x, p_g[:, None], tbl_p[rows[g]] if valid else zero_tables)
                nxt = (s + 1) % S
                new[nxt] = tuple(self._to(nxt, a) for a in (x, t_g, p_g, d_g))
            pay = new
        self.forward_calls += K
        out = torch.stack([torch.cat(row) for row in toks])[:, :B]
        return (out, torch.cat([f[0] for f in final])[:B],
                torch.cat([f[1] for f in final])[:B])
