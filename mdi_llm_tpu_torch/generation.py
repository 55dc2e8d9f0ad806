"""Generation on one device: sequential generation and the serving engine's
model handle.

Port of `mdi_llm_tpu/generation.py` for one device:

- `Generator.generate`: pow2 prompt buckets, a dense KV cache sized to
  the run, one prefill (a shared-prompt batch prefills one lane and
  broadcasts it), decode in chunks of `chunk_size` steps with one host
  read per chunk, batch compaction of early-stopped lanes (floor of 4
  lanes), and greedy n-gram speculative decoding for one prompt.
- `generate_chat` and `ChatSession`: single-sample token streams with
  stop-prefix hold-back; the session keeps its cache across turns and
  prefills only each new turn at its offset.
- `Generator.serve`: the paged-KV serving engine (`serving/engine.py`).

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
from mdi_llm_tpu_torch.ops.sampling import (
    operand_values,
    sample,
    sample_mode,
    sample_traced,
    sampling_operands,
)
from mdi_llm_tpu_torch.utils.context_managers import catch_loop_errors
from mdi_llm_tpu_torch.utils.step_graph import StepGraph, summarize


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
        quantize: Optional[str] = None,
        mesh: Any = None,
        scan_unroll: int = 1,
        abstract: bool = False,
        _graphs: Optional[bool] = None,  # None → CUDA graphs on the card;
        # False launches the step bodies eagerly (comparisons on the card)
    ):
        if quantize not in (None, "none"):
            _refuse(f"quantize={quantize!r}: weight quantization, item 10")
        if mesh is not None:
            _refuse("mesh=...: tp/dp/ep meshes, items 14-16")
        if scan_unroll != 1:
            _refuse(f"scan_unroll={scan_unroll}: the layers run as a Python loop")
        if abstract:
            _refuse("abstract=True: trace-only analysis, item 18")
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = transformer.tree_map(lambda x: x.to(self.device), params)
        if cache_dtype is None:
            cache_dtype = transformer.param_dtype(self.params)
        self.cache_dtype = cache_dtype
        self.max_seq_length = int(
            min(max_seq_length or cfg.block_size, cfg.block_size)
        )
        self.rope = transformer.get_rope_cache(cfg, device=self.device)
        self.rng_seed = int(rng_seed)
        self.rng = torch.Generator(device=self.device).manual_seed(self.rng_seed)
        self.use_flash = self.device.type == "cuda" if use_flash is None else bool(use_flash)
        # the crossover on the card is measured by chip_smoke.py (PERF.md)
        self.flash_min_len = int(flash_min_len)
        self.flash_kernel = flash_kernel
        kernel_route = self.device.type == "cuda" and flash_kernel is not False
        if self.use_flash and kernel_route and cfg.head_size not in KERNEL_HEAD_SIZES:
            raise ValueError(
                f"{cfg.name}: head size {cfg.head_size} is not one kernel K2 "
                f"is built for {KERNEL_HEAD_SIZES}; pass use_flash=False"
            )
        self._graphs = self.device.type == "cuda" if _graphs is None else bool(_graphs)
        # generate's dense caches per (B, cache_len) and decode-chunk steps
        # per (B, cache_len, n_steps, mode, top_k), one cache length at a time
        self._caches: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._steps: Dict[tuple, StepGraph] = {}

    # -- model steps ---------------------------------------------------------

    def _forward(self, tokens, input_pos, kv, **kw) -> torch.Tensor:
        with torch.no_grad():
            return transformer.forward(
                self.cfg, self.params, tokens, input_pos, kv, rope=self.rope, **kw
            )

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    def _init_kv(self, B: int, cache_len: int):
        return transformer.init_kv_cache(
            self.cfg, B, cache_len, dtype=self.cache_dtype, device=self.device
        )

    def _last_logits(self, logits, true_len) -> torch.Tensor:
        rows = torch.arange(logits.shape[0], device=self.device)
        return logits[rows, self._tensor(true_len) - 1]

    def _prefill(self, batch: np.ndarray, kv, true_len) -> torch.Tensor:
        """A fresh prefill of the (B, Tb) bucket at offset 0 into the empty
        cache; returns the logits at each row's last real token."""
        B, T = batch.shape
        logits = self._forward(
            self._tensor(batch), torch.zeros(B, dtype=torch.long, device=self.device),
            kv, fresh_prefill=True,
            # flash pays off on big tiles; small buckets stay dense
            use_flash=self.use_flash and T >= self.flash_min_len,
            flash_kernel=self.flash_kernel,
        )
        return self._last_logits(logits, true_len)

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

    def graph_stats(self) -> Dict[str, Any]:
        """generate's decode-chunk steps held now: built, captured,
        replayed, capture seconds."""
        return summarize(self._steps.values())

    def _verify(self, tokens: np.ndarray, kv, positions) -> np.ndarray:
        """Greedy verification forward for speculative decoding: the greedy
        successor of every position of `tokens` (1, T).  Exact because
        attention masks strictly by absolute position: stale cache entries
        past a rejected draft stay invisible until overwritten."""
        logits = self._forward(self._tensor(tokens), self._tensor(positions), kv)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _grow_kv(self, old, new_len: int):
        """A longer session cache with the old entries in its leading
        corner."""
        fresh = self._init_kv(1, new_len)
        for name, x in old.items():
            fresh[name][..., : x.shape[3], :] = x
        return fresh

    def _sampling(self, temperature, top_k, top_p):
        t_op, p_op = sampling_operands(temperature, top_p, device=self.device)
        return t_op, p_op, sample_mode(temperature, top_k, top_p)

    def _first_token(self, logits, temperature, top_k, top_p) -> np.ndarray:
        tok = sample(logits, self.rng, temperature=temperature, top_k=top_k, top_p=top_p)
        return tok.to(torch.int32).cpu().numpy()

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
        cache_len = _run_cache_len(self.max_seq_length, total_max, Tb)

        stats = GenerationStats()
        t0 = time.perf_counter()
        self._keep_cache_len(cache_len)
        graphs0 = self.graph_stats()
        p0 = list(prompts[0])
        if shared_prefill is None:  # greedy only (see the docstring)
            shared_prefill = temperature == 0.0
        shared = shared_prefill and B > 1 and all(list(p) == p0 for p in prompts[1:])
        if shared:
            kv1 = self._run_cache(1, cache_len)
            for x in kv1.values():
                x.zero_()
            last1 = self._prefill(batch[:1], kv1, lens[:1])
            last_logits = last1.expand(B, -1)
            kv = self._run_cache(B, cache_len)
            for n, x in kv1.items():
                kv[n].copy_(x.expand(-1, B, -1, -1, -1))
        else:
            kv = self._run_cache(B, cache_len)
            for x in kv.values():
                x.zero_()
            last_logits = self._prefill(batch, kv, lens)
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
                if compact:
                    compact_lanes()
                room = cache_len - int(positions.max()) - 1
                k = min(chunk_size, max_new_tokens - n, room)
                if k < 1:
                    break
                step = self._decode_step(len(lanes), cache_len, k, mode, top_k)
                # a copy: the step's outputs are overwritten by its next run
                toks_np = np.array(step.run(
                    tok=tok, pos=positions, t_op=t_val, p_op=p_val
                ).cpu())
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

    def serve(self, serving=None, policy=None, draft_gen=None, **knobs):
        """A paged-KV continuous-batching engine over this model
        (`serving/engine.py`).  Pass a `ServingConfig`, or its fields as
        keywords::

            engine = gen.serve(block_size=16, max_batch=8)
            engine.add_request("r0", prompt_tokens, max_new_tokens=128)
            results, stats = engine.run()

        `draft_gen` takes a Generator for `ServingConfig.draft_model`'s
        weights (same vocabulary as this model); None lets the engine
        initialise the named config with random weights.
        """
        from mdi_llm_tpu_torch.config import ServingConfig
        from mdi_llm_tpu_torch.serving.engine import ServingEngine

        if serving is None:
            serving = ServingConfig(**knobs)
        elif knobs:
            raise ValueError("pass a ServingConfig or keywords, not both")
        return ServingEngine(self, serving, policy=policy, draft_gen=draft_gen)


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
