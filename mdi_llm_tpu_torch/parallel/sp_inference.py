"""Sequence-parallel (ring-attention) inference: the context grows with the
number of sp ranks.

Port of `mdi_llm_tpu/parallel/sp_inference.py`.

- **Prefill**: the prompt is split into P contiguous chunks, one per sp
  rank.  Each rank embeds its chunk, runs the block stack with ring
  attention (`ops/ring_attention.ring_attention`, through K2 with its LSE
  when `use_flash` and the LOCAL chunk reaches `flash_min_len`), and
  writes its chunk's K/V into its own cache shard at local offset 0.
- **Decode**: the new token is the same on every rank; each rank forms
  online-softmax partials over its cache shard and the partials merge by
  a max and two sums (`ring_decode`).  The token's K/V goes round-robin to
  the ranks' shards (decode step s to rank s % P at local slot
  Tl + s // P), so each shard grows by ~1/P of the generated tokens.
- Slot -> position stamps (`kp`): each local slot carries its absolute
  position (`POS_SENTINEL` for an empty slot), so attention masks by
  position whatever slot a token landed in.

The port's sp ranks share one card, as its tp ranks do: a rank is a
cache shard and a chunk of the prompt, and the layer runner
(`models/transformer.SPRanks`) runs each layer on every rank before the
ring.  Replicated work (the decode token's projections, MLP and head)
runs once per device.  What differs from the JAX package:

- The steps are plain eager calls where the JAX package compiles one
  program per shape bucket; the buckets that decide the cache geometry
  (`Tl`, `C`) and a chat session's window are kept, so the streams are the
  JAX package's.  A teacher-forced append feeds only its real tokens (the
  JAX package's padded steps write nothing).
- The head runs on each sample's last prompt token only, where the JAX
  prefill computes every position's logits and keeps one.
- `use_flash` runs K2 on the card and its plain version on the CPU, as
  every K2 caller does (the JAX `SPGenerator` drops it off a TPU);
  `"force"` is accepted as a synonym of True.
- Sampling draws once per step from the first rank's device generator
  for the whole batch.

Across processes (`mesh` from `make_mesh({"sp": P}, [device], process_id,
num_processes)`, the sample CLI's `--coordinator`), a process holds a
contiguous range of the sp ranks: their chunks of the prompt and their
cache shards (the lists of per-rank state hold None at the other
processes' ranks).  Each layer's K/V chunks reach the other processes
before the ring runs (`ring_attention(group=...)`, one all-gather);
each decode step's K/V is written by the process that owns its slot
only, and `ring_decode` merges over the processes in two all-reduces.
The hidden row of each sample's last prompt token comes from the
process that holds it (one all-reduce of the rows, zero elsewhere), so
every process runs the head on the same rows and, its generator seeded
alike, draws the same tokens.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdi_llm_tpu_torch.config import TEMPERATURE, TOP_K, Config
from mdi_llm_tpu_torch.generation import (
    GenerationStats,
    _bucket,
    accept_draft,
    detect_stop_tokens,
    find_eot,
    ngram_draft,
    pad_draft,
    resolve_device,
    stop_filtered_stream,
)
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.ops.flash import KERNEL_HEAD_SIZES
from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params
from mdi_llm_tpu_torch.ops.ring_attention import ring_attention, ring_decode
from mdi_llm_tpu_torch.ops.sampling import sample
from mdi_llm_tpu_torch.parallel.collectives import CommGroup
from mdi_llm_tpu_torch.parallel.mesh import Mesh, make_mesh
from mdi_llm_tpu_torch.utils.context_managers import catch_loop_errors

__all__ = ["SPGenerator", "SPChatSession", "POS_SENTINEL"]

POS_SENTINEL = 1 << 30  # an empty cache slot: never <= a real position


class SPGenerator:
    """Sequence-parallel generation over P sp ranks: the weights on every
    rank's device, the KV cache (and so the context) split over the
    ranks.  A rank's cache holds `ceil(prompt / P) + ceil(max_new / P)`
    slots against `prompt + max_new` for one device.

    `devices` (default: the CUDA devices; one entry puts every rank on it)
    and `n_devices` (default: one rank per device) build the mesh
    `make_mesh({"sp": n_devices}, devices)`; or pass `mesh`, whose axes
    other than sp have size 1, over the processes of a job or in this
    one."""

    def __init__(
        self,
        cfg: Config,
        params,
        n_devices: Optional[int] = None,
        devices: Optional[Sequence] = None,
        mesh: Optional[Mesh] = None,
        max_seq_length: Optional[int] = None,
        cache_dtype: Optional[torch.dtype] = None,  # None → the weights' dtype
        rng_seed: int = 1337,
        decode_chunk: int = 32,
        use_flash=False,  # True or "force": the prefill ring through K2
        flash_min_len: int = 2048,  # engage K2 when the LOCAL chunk reaches this
        quantize: Optional[str] = None,  # None | "none" | "int8" | "w8a8" | "int4"
    ):
        if quantize not in (None, "none") and quantize not in FLAG_TO_MODE:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if mesh is None:
            if devices is None:
                resolve_device(None)  # raises without a GPU
                devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            mesh = make_mesh({"sp": n_devices or len(devices)}, devices)
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh={mesh!r}: pass a parallel.mesh.make_mesh Mesh")
        extra = {a: n for a, n in mesh.shape.items() if a != "sp" and n > 1}
        if extra:
            raise ValueError(f"mesh {mesh.shape}: an sp mesh has no other axis above "
                             "size 1")
        self.mesh = mesh
        self.P = int(mesh.size)
        self.cfg = cfg
        transformer.check_supported(cfg)
        # this process's ranks (all of them in one process), and the
        # processes' group across a job
        self.local = list(mesh.owned())
        self._group = CommGroup(range(mesh.num_processes)) if mesh.num_processes > 1 else None
        self.devices = [resolve_device(mesh.device_list()[r]) for r in self.local]
        self.device = self.devices[0]
        self.max_seq_length = int(min(max_seq_length or cfg.block_size, cfg.block_size))
        trees: Dict[torch.device, dict] = {}
        for d in self.devices:
            if d not in trees:
                tree = transformer.tree_map(lambda x, d=d: x.to(d), params)
                if quantize in FLAG_TO_MODE:
                    tree = quantize_params(tree, mode=FLAG_TO_MODE[quantize])
                trees[d] = tree
        self.params = trees[self.device]
        self.ranks = transformer.SPRanks(cfg, [trees[d] for d in self.devices])
        if cache_dtype is None:
            cache_dtype = transformer.param_dtype(self.params)
        self.cache_dtype = cache_dtype
        self.decode_chunk = int(decode_chunk)
        self.use_flash = bool(use_flash)  # "force" is True
        self.flash_min_len = int(flash_min_len)
        if (self.use_flash and self.device.type == "cuda"
                and cfg.head_size not in KERNEL_HEAD_SIZES):
            raise ValueError(f"{cfg.name}: head size {cfg.head_size} is not one kernel K2 "
                             f"is built for {KERNEL_HEAD_SIZES}; pass use_flash=False")
        self.rng = torch.Generator(device=self.device).manual_seed(int(rng_seed))
        self.ropes = self.ranks.rep(
            lambda r: transformer.get_rope_cache(cfg, device=self.devices[r]))
        self._last_kp: Optional[np.ndarray] = None

    def slot_owner_map(self) -> Optional[np.ndarray]:
        """The slot -> absolute position map after the last `generate`,
        shaped (B, P, C): entry [b, d, j] is the position whose K/V lives
        in rank d's local slot j for sample b (`POS_SENTINEL`: empty).
        Slots j < Tl hold rank d's prompt chunk; slot j >= Tl holds decode
        step s = (j - Tl) * P + d."""
        if self._last_kp is None:
            return None
        B = self._last_kp.shape[0]
        return self._last_kp.reshape(B, self.P, -1)

    def _whole_kp(self, kp) -> np.ndarray:
        """Every rank's kp joined on the host, (B, P * C): across processes
        gathered from the processes that hold them (one call)."""
        mine = torch.cat([kp[r] for r in self.local], dim=1)
        if self._group is not None:
            mine = self._group.all_gather(mine, dim=1)
        return mine.cpu().numpy()

    def kv_bytes(self, B: int, C: int) -> int:
        """One rank's cache bytes for B rows of C slots."""
        cfg = self.cfg
        return (2 * cfg.n_layer * B * cfg.n_query_groups * C * cfg.head_size
                * torch.empty((), dtype=self.cache_dtype).element_size())

    # -- the steps -----------------------------------------------------------

    def _init_kv(self, B: int, C: int) -> List[Optional[Dict[str, torch.Tensor]]]:
        """Each rank's cache shard {"k", "v"} (L, B, G, C, hs) on its device
        (None at another process's rank)."""
        kv: List[Optional[Dict[str, torch.Tensor]]] = [None] * self.P
        for r, d in zip(self.local, self.devices):
            kv[r] = transformer.init_kv_cache(self.cfg, B, C, dtype=self.cache_dtype, device=d)
        return kv

    def _prefill(self, toks: np.ndarray, lens: Sequence[int], kv, Tl: int, C: int):
        """The ring prefill of the (B, Tl * P) prompt bucket: each rank's
        chunk into its shard at local offset 0.  Returns (each rank's kp
        (B, C), None at another process's rank; the float32 logits (B, V)
        at each sample's last prompt token, on the first rank's device)."""
        B, P, ranks = toks.shape[0], self.P, self.ranks
        tokens, pos, kp = [], [], [None] * P
        for d, dev in zip(self.local, self.devices):
            tokens.append(torch.as_tensor(toks[:, d * Tl:(d + 1) * Tl], device=dev).long())
            gpos = torch.arange(d * Tl, (d + 1) * Tl, device=dev)
            pos.append(gpos.expand(B, Tl))
            lens_d = torch.as_tensor(np.asarray(lens), device=dev)[:, None]
            kp[d] = torch.cat([
                torch.where(gpos[None] < lens_d, gpos[None], POS_SENTINEL),
                torch.full((B, C - Tl), POS_SENTINEL, dtype=torch.long, device=dev)], dim=1)
        use_flash = self.use_flash and Tl >= self.flash_min_len
        cos, sin = ranks.positions(pos, self.ropes)
        k_pos = pos  # the ring's key positions: every rank's
        if self._group is not None:
            k_pos = [torch.arange(d * Tl, (d + 1) * Tl, device=self.device).expand(B, Tl)
                     for d in range(P)]

        def attend(i, qs, ks, vs):
            for j, r in enumerate(self.local):
                kv[r]["k"][i][:, :, :Tl] = ks[j].to(self.cache_dtype)
                kv[r]["v"][i][:, :, :Tl] = vs[j].to(self.cache_dtype)
            # q_pos == k_pos == the rank's contiguous chunk; padded bucket
            # positions sit after the prompt, so the causal mask hides them
            return ring_attention(qs, ks, vs, pos, k_pos, use_flash=use_flash,
                                  group=self._group)

        x = ranks.blocks(ranks.embed(tokens, pos), cos, sin, attend)
        rows = []
        for b, n in enumerate(lens):
            d = (n - 1) // Tl
            if d in self.local:
                rows.append(x[self.local.index(d)][b, n - 1 - d * Tl].to(self.device))
            else:
                rows.append(torch.zeros_like(x[0][b, 0]).to(self.device))
        rows = torch.stack(rows)
        if self._group is not None:
            # each row from the process that holds it: a sum with zeros
            self._group.all_reduce_(rows)
        last = ranks.head(rows[:, None])[:, 0].float()
        return kp, last

    def _step(self, kv, kp, tok: torch.Tensor, pos: torch.Tensor, owner: int, loc: int,
              write: bool = True) -> torch.Tensor:
        """One decode step of the tokens `tok` (B,) at positions `pos` (B,):
        rank `owner` writes their K/V at its local slot `loc` (with
        `write`, on its process); every rank's shard is read through `kp`.
        Returns the logits (B, V) on the first rank's device."""
        ranks = self.ranks
        toks = ranks.rep(lambda r: tok.to(self.devices[r])[:, None])
        p = ranks.rep(lambda r: pos.to(self.devices[r])[:, None])
        cos, sin = ranks.positions(p, self.ropes, replicated=True)

        def attend(i, qs, ks, vs):
            if write and kv[owner] is not None:
                j = self.local.index(owner)
                kv[owner]["k"][i][:, :, loc] = ks[j][:, :, 0].to(self.cache_dtype)
                kv[owner]["v"][i][:, :, loc] = vs[j][:, :, 0].to(self.cache_dtype)
            return ring_decode(qs, [kv[r]["k"][i] for r in self.local],
                               [kv[r]["v"][i] for r in self.local],
                               [kp[r] for r in self.local], p, group=self._group)

        x = ranks.blocks(ranks.embed(toks, p, replicated=True), cos, sin, attend,
                         replicated=True)
        return ranks.head(x[0])[:, -1]

    def _stamp(self, kp, step: int, Tl: int, pos: torch.Tensor) -> Tuple[int, int]:
        """Stamp decode step `step`'s slot with `pos` (on the owner's
        process): (owner, local slot)."""
        owner, loc = step % self.P, Tl + step // self.P
        if kp[owner] is not None:
            kp[owner][:, loc] = pos.to(kp[owner].device)
        return owner, loc

    def _decode(self, kv, kp, tok, pos, step0: int, n_steps: int, Tl: int, sampling):
        """`n_steps` round-robin decode steps from the sampled tokens `tok`
        (B,) at `pos` (B,), device tensors.  Returns (tok, pos, the
        (n_steps, B) tokens on the host)."""
        toks = []
        for i in range(n_steps):
            owner, loc = self._stamp(kp, step0 + i, Tl, pos)
            logits = self._step(kv, kp, tok, pos, owner, loc)
            tok = sample(logits, self.rng, **sampling)
            toks.append(tok)
            pos = pos + 1
        return tok, pos, torch.stack(toks).cpu().numpy()

    def _append(self, kv, kp, feed: Sequence[int], pos: int, step0: int, Tl: int):
        """Teacher-forced append for `SPChatSession`: feed the tokens `feed`
        one decode step each at positions pos, pos + 1, ..., each to its
        round-robin slot.  Returns (the float32 logits (1, V) at the last
        token, the greedy successor of each step): also the speculative
        verify pass (feed [tok] + draft, compare the successors)."""
        greedy, last = [], None
        for i, t in enumerate(feed):
            p = torch.tensor([pos + i], device=self.device)
            owner, loc = self._stamp(kp, step0 + i, Tl, p)
            logits = self._step(kv, kp, torch.tensor([t], device=self.device), p, owner, loc)
            greedy.append(torch.argmax(logits, dim=-1))
            last = logits.float()
        return last, torch.cat(greedy).cpu().numpy()

    def _geometry(self, longest: int, max_new: int) -> Tuple[int, int]:
        """(Tl, C): the local prompt chunk of the pow2 prompt bucket and the
        local cache budget."""
        Tl = -(-_bucket(longest) // self.P)
        return Tl, Tl + -(-max_new // self.P)

    def _start(self, prompts, max_new: int, temperature, top_k, top_p):
        """Checks, the caches and the ring prefill of `prompts`: (kv, kp,
        the first sampled tokens (B,), Tl, C)."""
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        if max(lens) + max_new > self.max_seq_length:
            raise ValueError(
                f"prompt+generation length {max(lens) + max_new} exceeds "
                f"max_seq_length {self.max_seq_length}"
            )
        Tl, C = self._geometry(max(lens), max_new)
        toks = np.zeros((len(prompts), Tl * self.P), np.int64)
        for b, p in enumerate(prompts):
            toks[b, : lens[b]] = np.asarray(p, np.int64)
        kv = self._init_kv(len(prompts), C)
        with torch.no_grad():
            kp, last = self._prefill(toks, lens, kv, Tl, C)
        tok = sample(last, self.rng, temperature=temperature, top_k=top_k, top_p=top_p)
        return kv, kp, tok, Tl, C

    # -- public API ----------------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
        temperature: float = TEMPERATURE,
        top_k: Optional[int] = TOP_K,
        top_p: Optional[float] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
    ) -> Tuple[List[List[int]], GenerationStats]:
        """Continuations of a batch of token-id prompts: (full token lists
        with the prompt, cut at stop sequences; timing stats)."""
        stats = GenerationStats()
        B = len(prompts)
        lens = [len(p) for p in prompts]
        sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        t0 = time.perf_counter()
        kv, kp, tok, Tl, C = self._start(prompts, max_new_tokens, **sampling)
        tok_np = tok.cpu().numpy()
        stats.prefill_s = time.perf_counter() - t0

        out = [list(p) for p in prompts]
        done = [False] * B
        for b in range(B):
            out[b].append(int(tok_np[b]))
            if detect_stop_tokens(out[b][lens[b]:], stop_sequences):
                done[b] = True
        n = 1
        # the decode step feeds `tok` at its own position: the prompt length
        pos = torch.as_tensor(lens, device=self.device)
        step0 = 0
        with catch_loop_errors() as guard:
            while n < max_new_tokens and not all(done):
                c = min(self.decode_chunk, max_new_tokens - n)
                tok, pos, toks_np = self._decode(kv, kp, tok, pos, step0, c, Tl, sampling)
                step0 += c
                for i in range(c):
                    n += 1
                    for b in range(B):
                        if not done[b]:
                            out[b].append(int(toks_np[i, b]))
                            if detect_stop_tokens(out[b][lens[b]:], stop_sequences):
                                done[b] = True
                    stats.tok_time.append(
                        (sum(len(o) - l for o, l in zip(out, lens)), time.perf_counter() - t0))
        stats.interrupted = guard.interrupted
        self._last_kp = self._whole_kp(kp)
        stats.decode_s = time.perf_counter() - t0 - stats.prefill_s
        trimmed = []
        for o, l in zip(out, lens):
            trimmed.append(o[: l + find_eot(o[l:], stop_sequences)])
        stats.tokens_generated = sum(len(o) - l for o, l in zip(out, lens))
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
        """Stream one sample's tokens as they are sampled (the contract of
        `Generator.generate_chat`: stop-marker prefixes held back so a
        partial marker never prints); tokens surface per decode chunk."""
        return stop_filtered_stream(
            self._generate_stream(prompt, max_new_tokens, temperature, top_k, top_p,
                                  stop_sequences),
            stop_sequences,
        )

    def _generate_stream(self, prompt, max_new_tokens, temperature, top_k, top_p,
                         stop_sequences):
        sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        with torch.no_grad():
            kv, kp, tok, Tl, C = self._start([list(prompt)], max_new_tokens, **sampling)
        history = [int(tok[0])]
        yield history[0]
        if detect_stop_tokens(history, stop_sequences):
            return
        n, step0 = 1, 0
        pos = torch.tensor([len(prompt)], device=self.device)
        while n < max_new_tokens:
            c = min(self.decode_chunk, max_new_tokens - n)
            with torch.no_grad():
                tok, pos, chunk = self._decode(kv, kp, tok, pos, step0, c, Tl, sampling)
            step0 += c
            for i in range(c):
                n += 1
                history.append(int(chunk[i, 0]))
                yield history[-1]
                if detect_stop_tokens(history, stop_sequences):
                    return

    def chat_session(self) -> "SPChatSession":
        """A stateful long-context conversation with cross-turn reuse of the
        sequence-split cache."""
        return SPChatSession(self)


class SPChatSession:
    """Cross-turn KV reuse over the sp ranks: the long-context variant of
    `generation.ChatSession`.  The first turn (and a window rebuild) runs
    the ring prefill; every later turn APPENDS its tokens through the
    round-robin decode path (`SPGenerator._append`), so a turn costs its
    own length, not the conversation's.

    Between sends (one sample): `history` is the logical conversation; the
    cache holds slots for all of it except the trailing `_pending` tokens.
    Reply tokens that were fed and then trimmed by a stop marker are rolled
    back by CLEARING their kp stamps (attention masks by kp, so a stale
    stamped slot would be attendable) and rewinding the step counter; the
    next turn's appends rewrite those slots."""

    def __init__(self, gen: SPGenerator):
        self.gen = gen
        self.reset()

    def reset(self) -> None:
        self.history: List[int] = []
        self._kv = None
        self._kp: Optional[List[torch.Tensor]] = None
        self._Tl = 0
        self._C = 0
        self._pos = 0  # logical tokens with live cache slots
        self._steps = 0  # round-robin decode/append steps consumed
        self._pending: List[int] = []

    def rollback(self, history: Sequence[int]) -> None:
        """Restore a logical conversation (the Ctrl-C contract): one ring
        prefill rebuilds the cache on the next send."""
        self.reset()
        self.history = list(history)
        self._pending = list(history)

    @property
    def capacity(self) -> int:
        return self.gen.max_seq_length

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
        """Stream the stop-filtered reply to `turn`; the session's state
        updates as the iterator is consumed (exhaust it before the next
        send).  `speculative=K` (greedy): K-token n-gram drafts verified by
        one append each, token-identical to the plain stream."""
        turn = list(turn)
        max_new = int(max_new_tokens)
        if speculative and temperature != 0.0:
            raise ValueError("speculative chat requires temperature=0")
        if not turn:
            raise ValueError("empty turn")
        if max_new + 1 >= self.gen.max_seq_length:
            raise ValueError("max_new_tokens too large for max_seq_length")
        return self._send(turn, max_new, temperature, top_k, top_p, stop_sequences,
                          speculative=int(speculative) if speculative else None)

    def _clear_steps(self, first_step: int, n: int) -> None:
        """Mark the slots of steps [first_step, first_step + n) empty again
        (a rejected draft, a stop-trimmed reply)."""
        P = self.gen.P
        for s in range(first_step, first_step + n):
            if self._kp[s % P] is not None:  # the owner's process clears it
                self._kp[s % P][0, self._Tl + s // P] = POS_SENTINEL

    def _send(self, turn, max_new, temperature, top_k, top_p, stop_sequences,
              speculative=None):
        gen = self.gen
        cap, P = gen.max_seq_length, gen.P
        self.history.extend(turn)
        feed = self._pending + turn
        fresh = self._kv is None
        if not fresh:
            logical_ok = self._pos + len(feed) + max_new + 1 <= cap
            slots_ok = self._steps + _bucket(len(feed)) + max_new <= P * (self._C - self._Tl)
            fresh = not (logical_ok and slots_ok)
        sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        with torch.no_grad():
            if fresh:
                window = self.history[-(cap - max_new - 1):]
                self.history = list(window)
                n = len(window)
                # the append region is sized for the session's maximum (cap),
                # so the geometry stays within few shapes across rebuilds
                Tl = -(-min(_bucket(n), cap) // P)
                C = Tl + -(-cap // P)
                toks = np.zeros((1, Tl * P), np.int64)
                toks[0, :n] = np.asarray(window, np.int64)
                self._kv = gen._init_kv(1, C)
                self._kp, last = gen._prefill(toks, [n], self._kv, Tl, C)
                self._Tl, self._C = Tl, C
                self._pos, self._steps = n, 0
            else:
                last, _ = gen._append(self._kv, self._kp, feed, self._pos, self._steps,
                                      self._Tl)
                self._pos += len(feed)
                self._steps += len(feed)
            tok = sample(last, gen.rng, **sampling)
        first = int(tok[0])
        self._pending = []
        prompt_end, step_base = self._pos, self._steps
        emitted: List[int] = [first]
        fed = [0]  # reply tokens fed through the model

        def spec_stream():
            """Greedy speculative stream: the append doubles as the verify
            pass.  A rejected draft's slots are cleared at once and the
            counters rewind to the accepted prefix, so the slots stay
            contiguous for the reconcile below."""
            K = speculative
            pos, last_tok = prompt_end, first
            yield first
            miss_skip = 0
            while len(emitted) < max_new:
                if detect_stop_tokens(emitted, stop_sequences):
                    return
                # slots were budgeted for len(feed) + max_new; a draft also
                # needs its K + 1 wide append to fit
                slots_left = P * (self._C - self._Tl) - (step_base + fed[0]) - 1
                draft = []
                if miss_skip == 0 and slots_left >= K + 1:
                    draft = ngram_draft(self.history + emitted, K)
                    if not draft:
                        miss_skip = 4
                if draft:
                    draft = pad_draft(draft, K)
                    L = K + 1
                    with torch.no_grad():
                        _, g = gen._append(self._kv, self._kp, [last_tok] + draft, pos,
                                           step_base + fed[0], self._Tl)
                    burst = accept_draft(draft, g[:L], K)
                    accepted = len(burst)  # last_tok and len(burst) - 1 drafts
                    if L > accepted:
                        self._clear_steps(step_base + fed[0] + accepted, L - accepted)
                    fed[0] += accepted
                    pos += accepted
                    stopped = False
                    for t in burst[: max_new - len(emitted)]:
                        emitted.append(t)
                        yield t
                        if detect_stop_tokens(emitted, stop_sequences):
                            stopped = True
                            break
                    last_tok = emitted[-1]
                    if stopped:
                        return
                else:
                    miss_skip = max(0, miss_skip - 1)
                    with torch.no_grad():
                        _, _, chunk = gen._decode(
                            self._kv, self._kp, torch.tensor([last_tok], device=gen.device),
                            torch.tensor([pos], device=gen.device), step_base + fed[0], 1,
                            self._Tl, sampling)
                    fed[0] += 1
                    pos += 1
                    last_tok = int(chunk[0, 0])
                    emitted.append(last_tok)
                    yield last_tok

        def raw_stream():
            nonlocal tok
            pos = torch.tensor([prompt_end], device=gen.device)
            yield first
            if detect_stop_tokens(emitted, stop_sequences):
                return
            n, step0 = 1, step_base
            while n < max_new:
                c = min(gen.decode_chunk, max_new - n)
                with torch.no_grad():
                    tok, pos, chunk = gen._decode(self._kv, self._kp, tok, pos, step0, c,
                                                  self._Tl, sampling)
                step0 += c
                fed[0] += c
                for i in range(c):
                    n += 1
                    emitted.append(int(chunk[i, 0]))
                    yield emitted[-1]
                    if detect_stop_tokens(emitted, stop_sequences):
                        return

        reply: List[int] = []
        stream = spec_stream() if speculative else raw_stream()
        for t in stop_filtered_stream(stream, stop_sequences):
            reply.append(t)
            yield t
        # reconcile: fed reply tokens past the trimmed reply get their kp
        # stamps cleared; the last sampled, never fed token (or the trimmed
        # tail) carries over as pending
        self.history.extend(reply)
        keep = min(len(reply), fed[0])
        if fed[0] > keep:
            self._clear_steps(step_base + keep, fed[0] - keep)
        self._pos = prompt_end + keep
        self._steps = step_base + keep
        self._pending = reply[keep:]
