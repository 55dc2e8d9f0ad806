#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`mdi_llm_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py [--only PHASE,PHASE,...]

runs every phase below in order (`--only` runs the named ones, for
iterating on one of them).  Each prints its lines; any failure exits
non-zero.

1. device  — torch.cuda must be available; prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds every kernel of the serving, generation and training
   paths from `csrc/` (one nvcc each, started together) and prints the
   build seconds.
3. kernel  — kernel K1 (ragged paged attention) against its plain PyTorch
   version on the card, at tiny-llama-1.1b geometry (32 heads, 4 KV
   groups, head size 64, 16-token blocks, 2048-token tables), in float32
   and bfloat16: pure decode of 8 slots at depths up to 2000; a mixed step
   (decode lanes, a 128-token prefill chunk, an absent slot, padding
   rows); verify-width spans of 5; the split-KV edges (a slot at depth
   2047 whose walk spans every chunk, walks ending exactly on a chunk
   boundary, one inside the first chunk); decode at head sizes 32 and
   128.  Owned rows are compared, rows no slot owns must be zero.  Tolerance: float32 max |err| <= 1e-4; bfloat16 max
   |err| <= 1.5e-2 against the plain version run in float32 on the same
   bfloat16 inputs (one bfloat16 rounding of outputs of size ~1 is ~4e-3).
   Prints the kernel's time, the plain version's, scaled_dot_product_
   attention's on the gathered dense view (a yardstick the port never
   calls), the least time the card could take and how many times the
   call launched K1's merge kernel.
4. serve   — the serve CLI's path, `--model tiny-llama-1.1b` at full width
   and all 22 layers, bf16, random weights from --seed, 16 synthetic
   requests, 8 slots, 2048-token window, 64 new tokens, chunked decode
   (8 steps) with double buffering.  Every request must finish with its
   token budget, every token must be in the vocabulary, K1 must have been
   launched 22 times per model forward and the plain route never; prints
   the merge kernel's launches beside K1's.  Here and in every serving and
   generation phase below the engine's steps and generate's decode chunks
   run as CUDA graphs (phase 15), so launches are counted at replay.
5. serve parity — float32, 4 layers at full width, 4 requests of 16 new
   tokens, served through the kernel route and through the plain route on
   the card: the greedy streams must be identical but for a genuine
   near-tie (see the parity phases below).
5a. kernel-q8 — K1 over int8 pools (random payloads, random positive
   scales per (block, group)) and over float8 pools (e4m3, e5m2) against
   its plain version on the card, at the `kernel` phase's span cases, q
   in float32 and bfloat16; reference and tolerance as for
   `kernel`, the plain version run in float32 on the same stored pool.
   Prints the same times; the library yardstick is scaled_dot_product_
   attention over the already dequantized gathered view (the dequant is
   not timed), and the bound counts K/V at one byte per element plus the
   int8 scales.
5b. serve-q8 — the serve phase's CLI run with `--kv-dtype int8`, then
   with `--kv-dtype float8` (e4m3): every request finishes with its
   budget in the vocabulary, K1 is launched 22 times per forward and the
   plain route never; prints the pool's bytes beside a bf16 pool's.
5c. serve-q8-parity — the serve-parity phase over an int8 pool, then an
   e4m3 pool: greedy streams through K1 and through the plain route.
5d. spec — speculative serving at full size, bf16 pool, `--spec-k 4
   --draft-model NanoLlama`, greedy: every request finishes in the
   vocabulary, the draft model and the lookup drafted, and K1 launches
   are exactly 22 per target forward + 12 per draft forward, the plain
   route never.  Then `--spec-k 4 --kv-dtype int8 --temperature 0.8`
   with the same draft model (random weights at temperature 0.8 make the
   n-gram lookup miss, so the draft model is what drafts): the
   rejection-sampled verify over the quantized pool.
5e. spec-parity — float32, 4 layers at full width, a 2-layer NanoLlama
   draft passed as `draft_gen`: greedy streams with `spec_k=4` and the
   draft equal the same engine's streams without `spec_k`, all on K1.
   Parity phases (serve-parity, serve-q8-parity, spec-parity): where two streams
   diverge, the phase prints the first divergent position and the top-2
   logit gap of the float32 model there (a dense forward over the common
   prefix), and passes only if that gap is below 1e-4, a genuine near-tie
   that a different summation order may flip.
6. flash   — kernel K2 (flash self-attention) against its plain PyTorch
   version on the card, 32 heads, 4 KV groups, head size 64, in float32
   and bfloat16: causal B=4 T=2048 (the generate phase's prefill shape),
   causal T=1000 with the LSE (T not a multiple of the tile), non-causal
   T=512 with the LSE; in bfloat16 also head sizes 32 and 128 at B=1,
   T in {1, 7, 100} (chunks shorter than one tile) and non-causal T=512
   at head size 128.  Tolerances as for K1, the LSE's too.  Prints the
   kernel's time, the plain version's, scaled_dot_product_attention's (a
   yardstick the port never calls) and the least time the card could
   take; then K2 against the dense torch route the model takes without
   flash, at T=256 to 2048 (the crossover for `flash_min_len`).
7. generate — `Generator.generate` on tiny-llama-1.1b at full width and
   all 22 layers, bf16, random weights from seed 10137, 2048-token window:
   4 greedy prompts of 1100-1900 tokens (one 2048 bucket), 64 new tokens
   in decode chunks of 16.  Every sample must get its 64 tokens in the
   vocabulary; K2 must be launched once per layer (22) and its plain
   version never.  Then the sample CLI (`--n-samples 4 --n-tokens 32
   --greedy`, 8-token prompts below `flash_min_len`) must finish without
   launching K2.
8. generate parity — float32, 4 layers at full width, 2 prompts of ~1100
   tokens, 16 greedy tokens, through K2 and through K2's plain version on
   the card: the streams must be identical.
9. flash-bwd — kernels K3 (dQ) and K4 (dK/dV, summed over each KV group)
   against their plain PyTorch versions on the same inputs (K2's output and
   LSE), 32 heads, 4 KV groups, head size 64, float32 and bfloat16: causal
   B=4 T=2048 (the training shape), causal T=1000 (a ragged tile),
   non-causal T=512 with an LSE cotangent; in bfloat16 also head sizes 32
   and 128 at B=1 T=1000, non-causal T=300 at head size 128 with an LSE
   cotangent and causal T=7 (shorter than a tile).  float32 inputs (the
   CUDA-core kernels): every output within 1e-4 x max(1, max |plain|).
   bfloat16 inputs (the tensor-core kernels): every element within the
   rounding-error bound of `flash_bwd_bf16_limits` against the plain
   version run in float32 on the same inputs; err/limit is printed.
   Prints each kernel's time, the plain version's, the backward of
   scaled_dot_product_attention (dQ, dK and dV together; a yardstick the
   port never calls) and the least time the card could take.
10. train  — `Trainer.train_step` on tiny-llama-1.1b at full width and all
   22 layers, bf16, B=4, T=2048, 2 micro-batches per step, remat on, the
   flash route on, random weights from seed 10137, tokens drawn from 512
   ids: every optimizer step launches exactly 88 K2 (forward and remat
   recompute), 44 K3 and 44 K4 and no plain version, an eval batch 22 K2;
   the step losses are finite and a fixed batch's loss falls by at least
   `TRAIN_MARGIN` over three steps.  Prints step seconds, tokens/s, the
   Trainer's TFLOP/s estimate and peak memory.  Then the train CLI on
   synthetic `train.bin`/`val.bin` in a temporary directory: 2 steps and a
   checkpoint, then `--init resume` for a third.
11. train parity — float32, 4 layers at full width, B=2, T=2048: two
   optimizer steps through K2-K4 and through their plain versions from
   the same params and batches; the first step's gradients and the losses
   must agree (tolerances in `phase_train_parity`).
12. train parity bf16 — the same set-up in bfloat16, where K2-K4 run on
   tensor cores: one gradient through them and one through their plain
   versions from the same params and batch, with exact launch counts; per
   leaf ||g_kernel - g_plain||_2 <= 2^-5 ||g_plain||_2 and the losses
   within 2^-8 (relative).
13. ckpt   — a real checkpoint through the normal entry points: the serve
   phase's weights (tiny-llama-1.1b, bf16, seed 10137) written by the
   port's reverse map as a HF snapshot of three safetensors shards with
   its index and config.json, converted by `cli.prepare_model`, every
   loaded leaf bit-identical to the written one; `cli.serve --ckpt` must
   give the 16 greedy streams of `cli.serve --model` with K1 at 22
   launches per forward and the plain route never; `Generator.generate`
   on the loaded weights over the generate phase's prompts must launch
   K2 exactly 22 times and give the original weights' tokens.  Prints
   the seconds to write, convert, load and serve beside the card.
14. chat   — a 32000-word word-level tokenizer.json in that checkpoint,
   then `cli.chat --ckpt` through stdin for two turns: a pasted
   1500-word first turn (bucket 2048) prefills the empty cache through K2
   (exactly 22 launches), a 12-word second turn takes the dense route;
   the conversation must equal a direct `ChatSession` run's.  Where the
   `tokenizers` library is missing it says so and stops there.
15. graphs — the engine's and the Generator's steps as CUDA graphs
   (the default everywhere above) against eager launches of the same step
   bodies (the private `_graphs=False` switch), in turns eager, graph,
   graph, eager, at full tiny-llama-1.1b width and depth in bf16: the
   serve phase's trace through `cli.build` + `engine.run()` over bf16,
   int8 and e4m3 pools, and the generate phase's run (each Generator
   called once first, so the timed calls are the second with their
   shapes).  Fails unless greedy streams are identical between the routes
   (the near-tie rule of the parity phases applies), host_syncs are equal,
   K1 launches are 22 per forward on both routes, no serve run captures a
   graph inside its steps and a second generate call captures none.  The
   sampled check: a temperature-0.8 serve and generate from the same
   generator state on both routes, printed as the number of streams
   identical draw for draw, and the frequency test of
   `sampled_frequencies_ok` on the graph route's mixed and decode steps.
   Prints tokens/s, decode_s, prefill_s, captures, capture seconds and
   peak memory per run, and the device time of 22 layers' paged writes
   (one decode forward of 8 lanes) over an int8 pool against a bf16 one,
   timed as graph replays.

The line before the last is the JSON `kernels` record (K1, K1 over int8
pools, K2-K4, each with `paths`: its launches in every phase that drives
it); the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per input type
TOL = {"float32": 1e-4, "bfloat16": 1.5e-2}
TINY_LLAMA = "tiny-llama-1.1b"


def fail(phase: str, msg: str) -> None:
    print(f"FAIL [{phase}] {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    # the host queues every launch while the card sleeps, so the events
    # time the launches back to back on the device, not the host's pace
    torch.cuda._sleep(100_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def make_case(spans, T, dtype, seed, H=32, G=4, hs=64, BS=16, MB=128):
    """A packed ragged batch over a random pool with shuffled blocks.
    spans: one (first position, n_tokens) per slot, n_tokens 0 = absent;
    rows past the spans are padding at a position past every table."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    S = len(spans)
    NB = 1 + S * MB
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = randn(1, H, T, hs), randn(NB, BS, G, hs), randn(NB, BS, G, hs)
    tables = rng.permutation(np.arange(1, NB))[: S * MB].reshape(S, MB)
    q_start, q_len = np.zeros(S, np.int32), np.zeros(S, np.int32)
    q_pos = np.full(T, MB * BS, np.int32)
    off = 0
    for s, (p0, n) in enumerate(spans):
        q_start[s], q_len[s] = off, n
        q_pos[off:off + n] = np.arange(p0, p0 + n)
        off += n
    lens = q_pos[np.clip(q_start, 0, T - 1)] + q_len
    dev = lambda a: torch.tensor(np.asarray(a, np.int32), device="cuda")
    return (q, k, v, dev(tables), dev(q_start), dev(q_len), dev(lens), dev(q_pos)), off


def bound(args, n_owned) -> tuple:
    """(least ms, what bounds it): each input byte read once (only the K/V
    rows below each present slot's lens, at the pool's element size, and
    an int8 pool's scales of the blocks under lens), each output byte
    written once, against the flops of QK and PV over the keys each owned
    row sees."""
    q, k, _, tables, _, q_len, lens, q_pos = args
    _, H, T, hs = q.shape
    payload = k["q"] if isinstance(k, dict) else k
    G, BS, item = payload.shape[2], payload.shape[1], q.element_size()
    live = lens[q_len > 0].long()
    nbytes = 2 * q.numel() * item + 2 * int(live.sum()) * G * hs * payload.element_size()
    if isinstance(k, dict):
        nbytes += 2 * 4 * G * int(((live + BS - 1) // BS).sum())
    nbytes += 4 * (tables.numel() + 3 * q_len.numel() + T)
    flops = 4 * H * hs * int((q_pos[:n_owned].long() + 1).sum())
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(args, scale):
    """scaled_dot_product_attention on the gathered dense view of the same
    batch: per slot, its padded query rows against its contiguous K/V.  A
    narrow pool's view is dequantized (and cast to q's dtype) here, outside
    what is timed."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import gather_paged_kv

    q, k, v, tables, q_start, q_len, _, q_pos = args
    kd, vd = (gather_paged_kv(x, tables).to(q.dtype) for x in (k, v))  # (S, G, W, hs)
    S, W = tables.shape[0], kd.shape[2]
    L = max(1, int(q_len.max()))
    rows = (q_start.long()[:, None] + torch.arange(L, device="cuda")[None]).clamp(max=q.shape[2] - 1)
    qd = q[0][:, rows].permute(1, 0, 2, 3).contiguous()  # (S, H, L, hs)
    live = torch.arange(L, device="cuda")[None] < q_len[:, None]
    pos = torch.where(live, q_pos.long()[rows], 0)
    mask = (torch.arange(W, device="cuda")[None, None] <= pos[..., None])[:, None]
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)


DECODE_DEPTHS = (37, 250, 511, 800, 1203, 1500, 1777, 2000)
K1_CASES = {  # label: (one (first position, n_tokens) per slot, T, head size)
    "decode": ([(d, 1) for d in DECODE_DEPTHS], 8, 64),
    "mixed": ([(d, 1) for d in (64, 700, 1400, 1999, 333, 1024)]
              + [(300, 128), (0, 0)], 136, 64),
    "verify": ([(d, 5) for d in (10, 400, 900, 1300, 1700, 2040, 555)] + [(0, 0)], 40, 64),
    # the split's edges: a slot at depth 2047 spans every chunk of the
    # 2048-key table; walks of 1024 and 128 keys end exactly on a chunk
    # boundary (a decode step's chunks are 64 keys, others' 128); a
    # shallow one fits the first chunk
    "split-edges": ([(2047, 1), (1023, 1), (127, 1), (5, 1)], 4, 64),
    "decode-hs32": ([(d, 1) for d in DECODE_DEPTHS], 8, 32),
    "decode-hs128": ([(d, 1) for d in DECODE_DEPTHS], 8, 128),
}


def phase_kernel(record):
    import torch

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for label, (spans, T, hs) in K1_CASES.items():
            scale = hs ** -0.5
            args, owned = make_case(spans, T, dtype, seed=len(spans) + T, hs=hs)
            merges = ragged_paged_attention.merge_launches
            out = ragged_paged_attention(*args, scale=scale)
            torch.cuda.synchronize()
            merged = ragged_paged_attention.merge_launches - merges
            ref_args = [a.float() if a.is_floating_point() else a for a in args]
            ref = ragged_paged_attention_plain(*ref_args, scale=scale)
            err = (out.float()[:, :, :owned] - ref[:, :, :owned]).abs().max().item()
            pad = out[:, :, owned:].abs().max().item() if owned < T else 0.0
            if not err <= TOL[name] or pad != 0.0:
                fail("kernel", f"{name} {label}: max|err| {err} (tol {TOL[name]}), "
                     f"padding rows max {pad}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: ragged_paged_attention(*args, scale=scale), 50)
            plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args, scale=scale), 5)
            lib_ms = cuda_ms(library_call(args, scale), 20)
            b_ms, b_by = bound(args, owned)
            print(f"kernel: K1 {name} {label} T={T} hs={hs} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by}) merge_launches={merged}", flush=True)
            if name == "bfloat16" and label == "decode":  # the main path's decode shape
                record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
    record["max_abs_err"] = worst


SERVE_BASE = ["--model", TINY_LLAMA, "--dtype", "bfloat16", "--seed", "10137",
              "--max-batch", "8", "--block-size", "16", "--sequence-length", "2048"]


def serve_checked(phase, argv, draft_layers=0):
    """The serve CLI on `argv`, with K1's and the plain route's counts set
    to 0 just before and read just after.  Fails unless every request
    finished with its budget in the vocabulary, K1 ran exactly once per
    layer of every target and draft forward, and the plain route never."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    args = cli.build_parser().parse_args(argv)
    ragged_paged_attention.launches = ragged_paged_attention.merge_launches = 0
    pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
    trace, results, stats, engine, _tokenizer = cli.serve(args)
    torch.cuda.synchronize()
    launches = ragged_paged_attention.launches
    engine.k1_merge_launches = ragged_paged_attention.merge_launches
    plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
    n_layer = engine.gen.cfg.n_layer
    vocab = engine.gen.cfg.padded_vocab_size
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new:
            fail(phase, f"{rid} did not finish with its {new} tokens")
        if not all(0 <= t < vocab for t in out[len(prompt):]):
            fail(phase, f"{rid} produced a token outside the vocabulary")
    want = n_layer * engine.forward_calls + draft_layers * engine.draft_forward_calls
    if n_layer != 22 or launches <= 0 or launches != want:
        fail(phase, f"K1 launches {launches} != {n_layer} x {engine.forward_calls} "
             f"target + {draft_layers} x {engine.draft_forward_calls} draft forwards")
    if plain:
        fail(phase, f"the plain attention route ran {plain} times on the card")
    line = cli.stats_line(stats, engine)
    return line, launches, engine, results


def phase_serve(record):
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli

    # warm-up (CUDA context, cuBLAS handles), not counted
    cli.serve(cli.build_parser().parse_args(SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8"]))
    torch.cuda.synchronize()
    line, launches, engine, _results = serve_checked(
        "serve", SERVE_BASE + ["--synthetic", "16", "--n-tokens", "64"])
    print("serve: " + json.dumps({k: line[k] for k in (
        "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s",
        "prefill_s", "mixed_steps", "decode_steps", "host_syncs",
        "kv_block_utilization_mean", "kv_block_utilization_peak", "forward_calls",
        "graph_captures", "graph_replays", "capture_s")}),
        flush=True)
    print(f"serve: K1 launches {launches} = {engine.gen.cfg.n_layer} per forward x "
          f"{engine.forward_calls} forwards, its merge kernel "
          f"{engine.k1_merge_launches} ({line['mixed_steps']} mixed steps, "
          f"{line['decode_steps']} decode steps in chunks of {engine.cfg.decode_chunk}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    record["launches"] = launches
    record.setdefault("paths", {})["serve"] = launches


def phase_serve_parity():
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device="cuda")
    gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
    trace = synthetic_trace(4, cfg.vocab_size, 2048, 16)
    streams = {}
    for route, use_kernel in (("kernel", None), ("plain", False)):
        ragged_paged_attention.launches = 0
        pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
        engine = gen.serve(block_size=16, max_batch=8, use_kernel=use_kernel)
        for rid, prompt, new in trace:
            engine.add_request(rid, prompt, new)
        streams[route], _ = engine.run()
        launched = ragged_paged_attention.launches
        plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
        if (launched > 0, plain > 0) != (route == "kernel", route == "plain"):
            fail("serve-parity", f"the {route} run launched K1 {launched} times "
                 f"and took the plain route {plain} times")
    divergence_ok("serve-parity", gen, streams["kernel"], streams["plain"], "K1 vs plain")
    n = sum(len(v) for v in streams["kernel"].values())
    same = sum(streams["kernel"][r] == streams["plain"][r] for r in streams["plain"])
    print(f"serve-parity: float32, {cfg.n_layer} layers x {cfg.n_embd}: "
          f"{same} of {len(trace)} greedy streams ({n} tokens) identical through K1 "
          "and the plain route", flush=True)


def narrow_pools(k, v, kind, seed):
    """The case's pools stored as `kind`: an int8 pool gets payloads drawn
    from [-127, 127] and scales drawn from [0.5, 2.5] / 127 per (block,
    group); a float8 pool is the case's draws cast."""
    import torch

    if kind != "int8":
        return k.float().to(getattr(torch, kind)), v.float().to(getattr(torch, kind))
    g = torch.Generator(device="cuda").manual_seed(seed)

    def one(x):
        NB, _, G, _ = x.shape
        payload = torch.randint(-127, 128, x.shape, generator=g, device="cuda").to(torch.int8)
        return {"q": payload,
                "scale": (0.5 + 2 * torch.rand((NB, G), generator=g, device="cuda")) / 127}

    return one(k), one(v)


def phase_kernel_q8(record):
    """K1 over int8 and float8 pools against its plain version in float32
    on the same stored pool (tolerances as in `phase_kernel`)."""
    import torch

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    worst = 0.0
    for kind in ("int8", "float8_e4m3fn", "float8_e5m2"):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            for label, (spans, T, hs) in K1_CASES.items():
                scale = hs ** -0.5
                args, owned = make_case(spans, T, dtype, seed=len(spans) + T, hs=hs)
                kp, vp = narrow_pools(args[1], args[2], kind, seed=T)
                args = (args[0], kp, vp) + args[3:]
                out = ragged_paged_attention(*args, scale=scale)
                torch.cuda.synchronize()
                ref = ragged_paged_attention_plain(args[0].float(), *args[1:], scale=scale)
                err = (out.float()[:, :, :owned] - ref[:, :, :owned]).abs().max().item()
                pad = out[:, :, owned:].abs().max().item() if owned < T else 0.0
                if not err <= TOL[name] or pad != 0.0:
                    fail("kernel-q8", f"{kind} pool, q {name} {label}: max|err| {err} "
                         f"(tol {TOL[name]}), padding rows max {pad}")
                ms = cuda_ms(lambda: ragged_paged_attention(*args, scale=scale), 50)
                plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args, scale=scale), 5)
                lib_ms = cuda_ms(library_call(args, scale), 20)
                b_ms, b_by = bound(args, owned)
                print(f"kernel-q8: K1 {kind} pool, q {name} {label} T={T} hs={hs} "
                      f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"library_ms={lib_ms:.4f} (SDPA on the dequantized view, dequant "
                      f"untimed) bound_ms={b_ms:.5f} ({b_by})", flush=True)
                if kind == "int8":
                    worst = max(worst, err)
                    if name == "bfloat16" and label == "decode":  # the main path's shape
                        record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=b_ms, bound_by=b_by)
                del args, kp, vp, out, ref
            torch.cuda.empty_cache()
    record["max_abs_err"] = worst


def phase_serve_q8(record):
    import torch

    from mdi_llm_tpu_torch.serving.engine import pool_bytes

    run = SERVE_BASE + ["--synthetic", "16", "--n-tokens", "64"]
    serve_checked("serve-q8", SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8",
                                            "--kv-dtype", "int8"])  # warm-up
    for kv in ("int8", "float8"):
        line, launches, engine, _results = serve_checked("serve-q8", run + ["--kv-dtype", kv])
        cfg, nb = engine.gen.cfg, engine.pool.num_blocks
        bf16 = 2 * cfg.n_layer * nb * engine.cfg.block_size * cfg.n_query_groups * cfg.head_size * 2
        scales = sum(x["scale"].numel() * 4 for x in engine._kv.values()) if kv == "int8" else 0
        print(f"serve-q8: --kv-dtype {kv} ({line['kv_dtype']}): " + json.dumps({k: line[k] for k in (
            "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s", "prefill_s",
            "mixed_steps", "decode_steps", "host_syncs", "forward_calls", "graph_captures",
            "capture_s")}), flush=True)
        print(f"serve-q8: --kv-dtype {kv}: K1 launches {launches} = {cfg.n_layer} per "
              f"forward x {engine.forward_calls} forwards, its merge kernel "
              f"{engine.k1_merge_launches}; pool {nb} blocks = "
              f"{pool_bytes(engine._kv) / 1e6:.2f} MB ({scales / 1e6:.3f} MB of scales) "
              f"against {bf16 / 1e6:.2f} MB as bf16", flush=True)
        if kv == "int8":
            record["launches"] = launches
            record.setdefault("paths", {})["serve-q8"] = launches
        del engine
        torch.cuda.empty_cache()


def divergence_ok(phase, gen, got, want, label) -> None:
    """Compare two dicts of greedy streams; where a stream diverges, print
    the first divergent position and the float32 model's top-2 logit gap
    there (a dense forward over the common prefix), and fail unless that
    gap is below 1e-4."""
    import torch

    from mdi_llm_tpu_torch.models import transformer

    for rid, w in want.items():
        g = got.get(rid)
        if g == w:
            continue
        if g is None:
            fail(phase, f"{label}: {rid} did not finish")
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        toks = torch.tensor([w[:i]], device="cuda")
        with torch.no_grad():
            logits = transformer.forward(gen.cfg, gen.params, toks,
                                         torch.zeros(1, dtype=torch.long, device="cuda"))
        top = torch.topk(logits[0, -1].float(), 2).values
        gap = (top[0] - top[1]).item()
        print(f"{phase}: {label}: {rid} diverges at position {i} (tokens "
              f"{g[i] if i < len(g) else None} vs {w[i] if i < len(w) else None}); "
              f"top-2 logit gap there {gap:.3e}", flush=True)
        if not gap < 1e-4:
            fail(phase, f"{label}: {rid} diverges at position {i} with a top-2 gap of {gap}")


def phase_serve_q8_parity():
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    gen = tiny_llama_generator(4, torch.float32)
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    for kv in ("int8", "float8_e4m3fn"):
        streams = {}
        for route, use_kernel in (("kernel", None), ("plain", False)):
            ragged_paged_attention.launches = 0
            pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
            engine = gen.serve(block_size=16, max_batch=8, use_kernel=use_kernel, kv_dtype=kv)
            for rid, prompt, new in trace:
                engine.add_request(rid, prompt, new)
            streams[route], _ = engine.run()
            launched = ragged_paged_attention.launches
            plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
            if launched != (4 * engine.forward_calls if route == "kernel" else 0) or \
                    (plain > 0) != (route == "plain"):
                fail("serve-q8-parity", f"{kv}: the {route} run launched K1 {launched} "
                     f"times and took the plain route {plain} times")
            del engine
        divergence_ok("serve-q8-parity", gen, streams["kernel"], streams["plain"], kv)
        n = sum(len(v) for v in streams["kernel"].values())
        same = sum(streams["kernel"][r] == streams["plain"][r] for r in streams["plain"])
        print(f"serve-q8-parity: float32, {kv} pool, 4 layers x {gen.cfg.n_embd}: "
              f"{same} of {len(trace)} greedy streams ({n} tokens) identical through K1 "
              "and the plain route", flush=True)
    del gen
    torch.cuda.empty_cache()


def phase_spec():
    import torch

    draft = ["--spec-k", "4", "--draft-model", "NanoLlama"]
    run = SERVE_BASE + ["--synthetic", "16", "--n-tokens", "64"] + draft
    for label, extra in (("greedy, bf16 pool", []),
                         ("temperature 0.8, int8 pool", ["--kv-dtype", "int8",
                                                         "--temperature", "0.8"])):
        line, launches, engine, _results = serve_checked("spec", run + extra, draft_layers=12)
        if engine.draft_gen.cfg.n_layer != 12 or not line["spec_drafted"] > 0:
            fail("spec", f"{label}: spec_drafted {line['spec_drafted']}, draft layers "
                 f"{engine.draft_gen.cfg.n_layer}")
        if not extra and not line["spec_drafted_model"] > 0:
            fail("spec", f"{label}: the draft model never drafted")
        print(f"spec: {label}: " + json.dumps({k: line[k] for k in (
            "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_steps",
            "mixed_steps", "host_syncs", "spec_drafted", "spec_accepted",
            "spec_drafted_ngram", "spec_drafted_model", "spec_accepted_model",
            "forward_calls", "draft_forward_calls", "kv_dtype")}), flush=True)
        print(f"spec: {label}: K1 launches {launches} = 22 x {engine.forward_calls} "
              f"target + 12 x {engine.draft_forward_calls} draft forwards, its merge "
              f"kernel {engine.k1_merge_launches}", flush=True)
        del engine
        torch.cuda.empty_cache()


def phase_spec_parity():
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    gen = tiny_llama_generator(4, torch.float32)
    dcfg = Config.from_name("NanoLlama", n_layer=2)
    dgen = Generator(dcfg, transformer.init_params(dcfg, 0, device="cuda"),
                     max_seq_length=2048, device="cuda")
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    streams = {}
    for label, knobs in (("plain decode", {}),
                         ("spec_k=4 + draft", dict(spec_k=4, draft_model="NanoLlama"))):
        ragged_paged_attention.launches = 0
        pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
        engine = gen.serve(block_size=16, max_batch=8, draft_gen=dgen if knobs else None,
                           **knobs)
        for rid, prompt, new in trace:
            engine.add_request(rid, prompt, new)
        streams[label], stats = engine.run()
        want = 4 * engine.forward_calls + 2 * engine.draft_forward_calls
        plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
        if ragged_paged_attention.launches != want or plain:
            fail("spec-parity", f"{label}: K1 launches {ragged_paged_attention.launches} "
                 f"(want {want}), plain route {plain}")
        if knobs and not stats.spec_drafted_model > 0:
            fail("spec-parity", "the draft model never drafted")
        del engine
    divergence_ok("spec-parity", gen, streams["spec_k=4 + draft"], streams["plain decode"],
                  "spec vs plain decode")
    print(f"spec-parity: float32, 4 layers x {gen.cfg.n_embd}, 2-layer NanoLlama draft: "
          f"spec_k=4 streams ({stats.spec_drafted} drafted, {stats.spec_accepted} "
          f"accepted, {stats.spec_drafted_model} by the model) against plain decode, "
          "all on K1", flush=True)
    del gen, dgen
    torch.cuda.empty_cache()


FLASH_SHAPES = {  # label: (B, T, causal, with_lse, head size)
    "main": (4, 2048, True, False, 64),
    "ragged": (2, 1000, True, True, 64),
    "noncausal": (2, 512, False, True, 64),
}
# bfloat16 only (the tensor-core kernel's edges): other head sizes, chunks
# shorter than one 128-row tile or 64-key tile, non-causal at hs 128
FLASH_BF16_SHAPES = {
    **{f"hs{hs}-T{T}": (1, T, True, True, hs) for hs in (32, 128) for T in (1, 7, 100)},
    "hs128-noncausal": (2, 512, False, True, 128),
}


def flash_bound(B, H, G, T, hs, dtype, causal, with_lse) -> tuple:
    """(least ms, what bounds it) for K2: q, k, v read once, the output
    (and LSE) written once, against 4 * hs flops per (head, query, key)
    pair the mask lets through."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * H + 2 * B * G) * T * hs * item + (4 * B * H * T if with_lse else 0)
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4 * B * H * hs * pairs
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_inputs(B, T, dtype, seed, H=32, G=4, hs=64):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, H, T, hs), (B, G, T, hs), (B, G, T, hs))]


def phase_flash(record):
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.attention import multihead_attention
    from mdi_llm_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_lse,
        flash_attention_plain,
    )

    worst = 0.0
    cases = [(torch.float32, label, shape) for label, shape in FLASH_SHAPES.items()]
    cases += [(torch.bfloat16, label, shape) for label, shape in
              {**FLASH_SHAPES, **FLASH_BF16_SHAPES}.items()]
    for dtype, label, (B, T, causal, with_lse, hs) in cases:
        name = str(dtype).replace("torch.", "")
        q, k, v = flash_inputs(B, T, dtype, seed=T + B, hs=hs)
        if with_lse:
            run = lambda: flash_attention_lse(q, k, v, causal=causal)  # noqa: E731
        else:
            run = lambda: (flash_attention(q, k, v), None)  # noqa: E731
        out, lse = run()
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal)
        err = (out.float() - ref).abs().max().item()
        if with_lse:
            err = max(err, (lse - ref_lse).abs().max().item())
        del ref, ref_lse
        if not err <= TOL[name]:
            fail("flash", f"{name} {label}: max|err| {err} (tol {TOL[name]})")
        worst = max(worst, err)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20)
        b_ms, b_by = flash_bound(B, 32, 4, T, hs, dtype, causal, with_lse)
        print(f"flash: K2 {name} {label} B={B} T={T} hs={hs} causal={causal} "
              f"lse={with_lse} max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        if name == "bfloat16" and label == "main":  # the generate phase's shape
            record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        torch.cuda.empty_cache()
    record["max_abs_err"] = worst
    # the crossover: K2 against the dense route a prefill takes without flash
    for T in (256, 512, 1024, 2048):
        q, k, v = flash_inputs(4, T, torch.bfloat16, seed=T)
        pos = torch.arange(T, device="cuda").expand(4, T)
        ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        dense_ms = cuda_ms(lambda: multihead_attention(q, k, v, pos, k_pos=pos), 10)
        print(f"flash: crossover bfloat16 B=4 T={T}: K2 ms={ms:.4f} dense-route "
              f"ms={dense_ms:.4f} (dense/K2 {dense_ms / ms:.3f})", flush=True)
        torch.cuda.empty_cache()


BWD_F32_TOL = 1e-4  # a float32 output: x max(1, max |plain|)
FLASH_BWD_SHAPES = {  # label: (B, T, causal, with an LSE cotangent, head size)
    "main": (4, 2048, True, False, 64),
    "ragged": (2, 1000, True, False, 64),
    "noncausal": (2, 512, False, True, 64),
}
# bfloat16 only (every instance of the tensor-core kernels, and their
# edges): head sizes 32 and 128 at a ragged T, non-causal with an LSE
# cotangent at a T that is no multiple of 64, a chunk shorter than a tile
FLASH_BWD_BF16_SHAPES = {
    "hs32": (1, 1000, True, False, 32),
    "hs128": (1, 1000, True, False, 128),
    "hs128-noncausal": (1, 300, False, True, 128),
    "T7": (1, 7, True, False, 64),
}


def flash_bwd_bound(B, H, G, T, hs, dtype, causal, which) -> tuple:
    """(least ms, what bounds it) for K3 or K4: q, k, v, dO, the LSE and D
    read once, dQ (q's dtype) or the per-group float32 dK, dV written once,
    against 6 * hs (K3) or 8 * hs (K4) flops per (head, query, key) pair
    the mask lets through."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * H + 2 * B * G) * T * hs * item + 2 * 4 * B * H * T
    nbytes += B * H * T * hs * item if which == "dq" else 2 * B * G * T * hs * 4
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = (6 if which == "dq" else 8) * B * H * hs * pairs
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bwd_bf16_limits(q, k, v, do, lse, dsum, scale, causal, ref) -> tuple:
    """Element-wise limits (dQ, dK, dV) on K3/K4 over bfloat16 inputs,
    against `ref` = (dQ, dK, dV) of the plain versions run in float32 on
    the same bfloat16 inputs.  They bound the roundings the tensor-core
    kernels add, at u = 2^-8 (bfloat16's unit roundoff), with a factor 2 of
    headroom for the float32 summation order:

      dQ  2^-8 |ref| + 2^-7 scale (|dS| |K|)   dS rounded, dQ rounded once
      dK  2^-7 scale (|dS|^T |Q|)              dS rounded
      dV  2^-7 (P^T |dO|)                      P rounded

    each plus 1e-4 max(1, max |ref|); the products are group-summed and
    take the plain math's own P and |dS|.  Any device; nothing here needs
    a GPU."""
    import torch

    from mdi_llm_tpu_torch.ops.flash import _bwd_terms

    f32 = [x.float() for x in (q, k, v, do)]
    qg, dog, p, ds = _bwd_terms(*f32, lse, dsum, scale, causal)
    ads = ds.abs_()
    del ds
    kf = f32[1].abs()

    def shared(r):
        return 1e-4 * max(1.0, r.abs().max().item())

    dq, dk, dv = ref
    lim_dq = 2.0 ** -7 * scale * torch.einsum("bgrts,bgsh->bgrth", ads, kf).reshape(q.shape)
    lim_dq += 2.0 ** -8 * dq.abs() + shared(dq)
    lim_dk = 2.0 ** -7 * scale * torch.einsum("bgrts,bgrth->bgsh", ads, qg.abs()) + shared(dk)
    del ads
    lim_dv = 2.0 ** -7 * torch.einsum("bgrts,bgrth->bgsh", p, dog.abs()) + shared(dv)
    return lim_dq, lim_dk, lim_dv


def err_ratio(got, ref, limit) -> tuple:
    """(max |got - ref|, max over elements of |got - ref| / limit): a
    ratio above 1 fails."""
    diff = (got.float() - ref).abs()
    return diff.max().item(), (diff / limit).max().item()


def phase_flash_bwd(k3, k4):
    """K3 and K4 against their plain versions on the same inputs (the
    forward's output and LSE from K2), the plain versions run in float32 on
    the same (bfloat16) inputs.  float32 inputs run the CUDA-core kernels,
    which compute as the plain versions do: every output is held to
    max |err| <= BWD_F32_TOL * max(1, max |plain|).  bfloat16 inputs run
    the tensor-core kernels, held element by element to
    `flash_bwd_bf16_limits`."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.flash import (
        flash_attention_lse,
        flash_dkv,
        flash_dkv_plain,
        flash_dq,
        flash_dq_plain,
    )

    worst = {"dq": 0.0, "dkv": 0.0}
    cases = [(torch.float32, label, shape) for label, shape in FLASH_BWD_SHAPES.items()]
    cases += [(torch.bfloat16, label, shape) for label, shape in
              {**FLASH_BWD_SHAPES, **FLASH_BWD_BF16_SHAPES}.items()]
    for dtype, label, (B, T, causal, with_dlse, hs) in cases:
        name = str(dtype).replace("torch.", "")
        q, k, v = flash_inputs(B, T, dtype, seed=3 * T + B, hs=hs)
        scale = hs ** -0.5
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        g = torch.Generator(device="cuda").manual_seed(T)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        dsum = (do.float() * out.float()).sum(-1)
        if with_dlse:
            dsum = dsum - torch.randn(lse.shape, generator=g, device="cuda")
        args = (q, k, v, do, lse, dsum, scale, causal)
        got = (flash_dq(*args),) + flash_dkv(*args)
        torch.cuda.synchronize()
        f32 = [x.float() for x in (q, k, v, do)]
        ref = (flash_dq_plain(*f32, lse, dsum, scale, causal),) + \
            flash_dkv_plain(*f32, lse, dsum, scale, causal)
        del f32
        if dtype == torch.bfloat16:
            limits = flash_bwd_bf16_limits(q, k, v, do, lse, dsum, scale, causal, ref)
        else:
            limits = [BWD_F32_TOL * max(1.0, r.abs().max().item()) for r in ref]
        for which, a, r, lim in zip(("dq", "dk", "dv"), got, ref, limits):
            err, ratio = err_ratio(a, r, lim)
            print(f"flash-bwd: {which} {name} {label}: max|err| {err:.3e} "
                  f"max|plain| {r.abs().max().item():.3e} err/limit {ratio:.3e}", flush=True)
            if not ratio <= 1.0:
                fail("flash-bwd", f"{name} {label} {which}: max|err| {err}, "
                     f"{ratio:.3f} x its limit")
            kernel = "dq" if which == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], err)
        del got, ref, limits
        torch.cuda.empty_cache()
        # the yardstick: the backward alone of one SDPA call (dQ, dK and
        # dV together), at the same shape
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                                 enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), do, retain_graph=True), 10)
        del lib_out, qq, kk, vv
        for which, rec, kern, plain in (("dq", k3, flash_dq, flash_dq_plain),
                                        ("dkv", k4, flash_dkv, flash_dkv_plain)):
            ms = cuda_ms(lambda: kern(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 2)
            torch.cuda.empty_cache()
            b_ms, b_by = flash_bwd_bound(B, 32, 4, T, hs, dtype, causal, which)
            print(f"flash-bwd: {'K3' if which == 'dq' else 'K4'} {name} {label} "
                  f"B={B} T={T} hs={hs} causal={causal} dlse={with_dlse} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA "
                  f"backward, dQ+dK+dV) bound_ms={b_ms:.5f} ({b_by})", flush=True)
            if name == "bfloat16" and label == "main":  # the training shape
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, lse, do, dsum, args
        torch.cuda.empty_cache()
    k3["max_abs_err"], k4["max_abs_err"] = worst["dq"], worst["dkv"]
    print(f"flash-bwd: K3 max|err| {worst['dq']:.3e}, K4 max|err| {worst['dkv']:.3e} "
          "over both dtypes and every shape", flush=True)


def tiny_llama_generator(n_layer, dtype, **kw):
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer

    cfg = Config.from_name(TINY_LLAMA, n_layer=n_layer)
    params = transformer.init_params(cfg, 10137, dtype=dtype, device="cuda")
    return Generator(cfg, params, max_seq_length=2048, device="cuda", **kw)


def long_prompts(lens, vocab, seed=10137):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def phase_generate(record):
    import torch

    from mdi_llm_tpu_torch.cli import sample as sample_cli
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    gen = tiny_llama_generator(22, torch.bfloat16)
    cfg = gen.cfg
    # warm-up (cuBLAS handles, allocator), short prompts: not counted
    gen.generate([[1, 2, 3]] * 4, 4, temperature=0.0)
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_plain.calls = 0
    outs, stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
    torch.cuda.synchronize()
    launches, plain = flash_attention.launches, flash_attention_plain.calls
    for i, (p, o) in enumerate(zip(prompts, outs)):
        new = o[len(p):]
        if len(new) != 64 or not all(0 <= t < cfg.padded_vocab_size for t in new):
            fail("generate", f"sample {i} did not get 64 tokens in the vocabulary")
    if cfg.n_layer != 22 or launches != cfg.n_layer or plain:
        fail("generate", f"K2 launches {launches} (want {cfg.n_layer}), plain "
             f"version calls {plain} (want 0)")
    print("generate: " + json.dumps({
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
        "prefill_s": round(stats.prefill_s, 4), "decode_s": round(stats.decode_s, 4),
        "tokens_generated": stats.tokens_generated,
        "tokens_per_s": round(stats.tokens_per_s, 2),
        "graph_captures": stats.captures, "capture_s": round(stats.capture_s, 4),
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "k2_launches": launches, "k2_plain_calls": plain}), flush=True)
    record["launches"] = launches
    record.setdefault("paths", {})["generate"] = launches
    del gen
    torch.cuda.empty_cache()

    args = sample_cli.build_parser().parse_args(
        ["--model", TINY_LLAMA, "--n-samples", "4", "--n-tokens", "32", "--greedy"])
    flash_attention.launches = flash_attention_plain.calls = 0
    prompt_ids, outs, stats, gen, _tokenizer, seconds = sample_cli.run(args)
    torch.cuda.synchronize()
    if flash_attention.launches or flash_attention_plain.calls:
        fail("generate", f"the sample CLI's 8-token prompts launched K2 "
             f"{flash_attention.launches} times (plain {flash_attention_plain.calls})")
    if [len(o) - len(p) for o, p in zip(outs, prompt_ids)] != [32] * 4:
        fail("generate", "the sample CLI did not generate 32 tokens per sample")
    print(f"generate: sample CLI --n-samples 4 --n-tokens 32 --greedy: "
          f"{stats.tokens_generated} tokens, {stats.tokens_per_s:.2f} tokens/s "
          f"decode, 0 K2 launches (prompt bucket 16 < flash_min_len "
          f"{gen.flash_min_len})", flush=True)
    del gen
    torch.cuda.empty_cache()


def phase_generate_parity():
    import torch

    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    streams = {}
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        gen = tiny_llama_generator(4, torch.float32, use_flash=True,
                                   flash_kernel=flash_kernel)
        prompts = long_prompts((1100, 1093), gen.cfg.vocab_size, seed=7)
        flash_attention.launches = flash_attention_plain.calls = 0
        streams[route], _ = gen.generate(prompts, 16, temperature=0.0)
        launched, plain = flash_attention.launches, flash_attention_plain.calls
        if (launched, plain) != ((4, 0) if route == "kernel" else (0, 4)):
            fail("generate-parity", f"the {route} run launched K2 {launched} "
                 f"times and its plain version {plain} times")
        del gen
        torch.cuda.empty_cache()
    if streams["kernel"] != streams["plain"]:
        fail("generate-parity", "greedy streams differ between K2 and its plain version")
    print("generate-parity: float32, 4 layers x 2048: 2 greedy streams of 16 "
          "tokens identical through K2 and its plain version", flush=True)


DEVICE = "cuda"
TRAIN = dict(batch_size=4, block_size=2048, grad_acc_steps=2, learning_rate=1e-3,
             warmup_iters=0, lr_decay_iters=100, min_lr=1e-4, eval_iters=1,
             dtype="bfloat16", remat=True)
TRAIN_VOCAB = 512  # synthetic tokens are drawn from this many ids
# the fixed batch's loss must fall by this much over three steps; the first
# run on the card saw 10.8486 -> 6.5078 (a fall of 4.34), so 1.0 leaves room
TRAIN_MARGIN = 1.0


def reset_flash_counts():
    from mdi_llm_tpu_torch.ops import flash

    flash.flash_attention.launches = flash.flash_dq.launches = flash.flash_dkv.launches = 0
    flash.flash_attention_plain.calls = flash.flash_dq_plain.calls = 0
    flash.flash_dkv_plain.calls = 0


def flash_counts() -> dict:
    from mdi_llm_tpu_torch.ops import flash

    return {"K2": flash.flash_attention.launches, "K3": flash.flash_dq.launches,
            "K4": flash.flash_dkv.launches,
            "plain": flash.flash_attention_plain.calls + flash.flash_dq_plain.calls
            + flash.flash_dkv_plain.calls}


def synthetic_tokens(n, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(0, TRAIN_VOCAB, n).astype(np.uint16)


def phase_train(k3, k4):
    """Trainer.train_step on tiny-llama-1.1b at full width and depth, then
    the train CLI with a checkpoint and `--init resume`."""
    import math

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.cli import train as train_cli
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.training import (
        Trainer,
        TrainingConfig,
        estimate_flops_per_token,
    )
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = Config.from_name(TINY_LLAMA)
    tc = TrainingConfig(**TRAIN)
    L, a, B, T = cfg.n_layer, tc.grad_acc_steps, tc.batch_size, tc.block_size
    tr = Trainer(cfg, tc, device=DEVICE)
    if L != 22 or not tr.use_flash:
        fail("train", f"{L} layers, use_flash {tr.use_flash}: want 22 layers on the flash route")
    data = synthetic_tokens(1 << 22, seed=10137)
    rng = np.random.default_rng(10138)
    fixed = data_loader.get_batch(data, B, T, rng)

    def batches():
        xs = np.empty((a, B, T), np.int32)
        ys = np.empty_like(xs)
        for m in range(a):
            xs[m], ys[m] = data_loader.get_batch(data, B, T, rng)
        return xs, ys

    def evaluate(label):
        reset_flash_counts()
        loss = tr.eval_loss(*fixed)
        got = flash_counts()
        if got != {"K2": L, "K3": 0, "K4": 0, "plain": 0}:
            fail("train", f"eval batch ({label}) launched {got}; want K2 = {L} only")
        return loss

    tr.train_step(*batches())  # warm-up (cuBLAS handles, allocator): not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss0 = evaluate("before")
    want = {"K2": 2 * L * a, "K3": L * a, "K4": L * a, "plain": 0}
    steps, total = [], {"K3": 0, "K4": 0}
    for _ in range(3):
        xs, ys = batches()
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        loss = tr.train_step(xs, ys)  # returns a host float: synchronized
        dt = time.perf_counter() - t0
        got = flash_counts()
        if got != want:
            fail("train", f"one optimizer step launched {got}; want {want}")
        total["K3"] += got["K3"]
        total["K4"] += got["K4"]
        if not math.isfinite(loss):
            fail("train", f"step loss {loss}")
        steps.append((dt, loss))
    loss1 = evaluate("after")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (math.isfinite(loss0) and math.isfinite(loss1)) or loss0 - loss1 < TRAIN_MARGIN:
        fail("train", f"fixed-batch loss {loss0} -> {loss1}: want a fall of at "
             f"least {TRAIN_MARGIN}")
    dt = float(np.median([d for d, _ in steps]))
    tokens = a * B * T
    tflops = estimate_flops_per_token(cfg, T) * tokens / dt / 1e12
    print("train: " + json.dumps({
        "model": TINY_LLAMA, "layers": L, "batch": B, "block": T, "grad_acc": a,
        "dtype": tc.dtype, "remat": tc.remat, "use_flash": tr.use_flash,
        "step_s": [round(d, 4) for d, _ in steps], "step_s_median": round(dt, 4),
        "tokens_per_s": round(tokens / dt, 1), "tflops": round(tflops, 2),
        "step_losses": [round(x, 4) for _, x in steps],
        "fixed_batch_loss": [round(loss0, 4), round(loss1, 4)],
        "peak_memory_gib": round(peak, 3),
        "launches_per_step": want}), flush=True)
    k3["launches"], k4["launches"] = total["K3"], total["K4"]
    k3["paths"], k4["paths"] = {"train": total["K3"]}, {"train": total["K4"]}
    del tr
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ds, ck = Path(tmp) / "data", Path(tmp) / "ckpt"
        ds.mkdir()
        synthetic_tokens(1 << 21, seed=1).tofile(ds / "train.bin")
        synthetic_tokens(1 << 18, seed=2).tofile(ds / "val.bin")
        argv = ["--model", TINY_LLAMA, "--ckpt", str(ck), "--dataset", str(ds),
                "--batch-size", str(B), "--block-size", str(T), "--learning-rate",
                str(tc.learning_rate), "--warmup-iters", "0", "--lr-decay-iters", "100",
                "--log-interval", "1", "--ckpt-interval", "1000", "--eval-iters", "1",
                "--device", DEVICE]
        reset_flash_counts()
        t0 = time.perf_counter()
        result, trainer = train_cli.main(argv + ["--max-iters", "2"])
        run_s = time.perf_counter() - t0
        got = flash_counts()
        want = {"K2": 2 * 2 * L, "K3": 2 * L, "K4": 2 * L, "plain": 0}
        losses = [h["loss"] for h in result["history"] if "loss" in h]
        if got != want or len(losses) != 2 or not all(map(math.isfinite, losses)):
            fail("train", f"CLI run: launches {got} (want {want}), losses {losses}")
        del trainer
        torch.cuda.empty_cache()
        saved = sorted(p.name for p in ck.iterdir())
        if saved != ["model_config.yaml", "opt_state.pt", "params.pt", "train_state.json"]:
            fail("train", f"CLI checkpoint holds {saved}")
        size = sum(p.stat().st_size for p in ck.iterdir()) / 2**30
        t1 = time.perf_counter()
        result, trainer = train_cli.main(argv + ["--init", "resume", "--max-iters", "3"])
        resume_s = time.perf_counter() - t1
        hist = [h for h in result["history"] if "loss" in h]
        if (result["iter_num"] != 3 or trainer.optimizer.count != 3 or [h["iter"] for h in hist]
                != [3] or not math.isfinite(hist[0]["loss"])):
            fail("train", f"--init resume did not continue at iter 3: {result}")
        print(f"train: CLI 2 steps + checkpoint ({size:.2f} GiB) in {run_s:.1f} s, "
              f"losses {[round(x, 4) for x in losses]}; --init resume continued at "
              f"iter 3 (loss {hist[0]['loss']:.4f}) in {resume_s:.1f} s", flush=True)
        del trainer
        torch.cuda.empty_cache()



def phase_train_parity():
    """float32, 4 layers at full width, B=2, T=2048: two optimizer steps
    through K2-K4 and through their plain versions from the same params and
    batches.  The kernels sum in another order than the plain einsums, so
    the first step's gradients agree within 1e-4 of the largest gradient
    and the losses within 1e-5 (relative)."""
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.training import Trainer, TrainingConfig, cross_entropy_loss
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    tc = TrainingConfig(**{**TRAIN, "batch_size": 2, "grad_acc_steps": 1,
                           "dtype": "float32", "use_flash": True})
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device=DEVICE)
    data = synthetic_tokens(1 << 20, seed=3)
    rng = np.random.default_rng(4)
    batches = [data_loader.get_batch(data, 2, tc.block_size, rng) for _ in range(2)]
    grads, losses = {}, {}
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        tr = Trainer(cfg, tc, params=params, device=DEVICE, flash_kernel=flash_kernel)
        reset_flash_counts()
        x, y = (torch.as_tensor(b, device=DEVICE).long() for b in batches[0])
        loss = cross_entropy_loss(cfg, tr.params, x, y, remat=True, use_flash=True,
                                  flash_kernel=flash_kernel)
        grads[route] = torch.autograd.grad(loss, transformer.tree_leaves(tr.params))
        losses[route] = [tr.train_step(bx[None], by[None]) for bx, by in batches]
        got = flash_counts()
        # one gradient and two steps of one micro-batch: per layer each ran
        # K2 twice (remat) and K3 and K4 once, or their plain versions
        n = 3 * cfg.n_layer
        want = ({"K2": 2 * n, "K3": n, "K4": n, "plain": 0} if route == "kernel"
                else {"K2": 0, "K3": 0, "K4": 0, "plain": 4 * n})
        if got != want:
            fail("train-parity", f"the {route} run launched {got}; want {want}")
        del tr
        torch.cuda.empty_cache()
    size = max(g.abs().max().item() for g in grads["plain"])
    err = max((a - b).abs().max().item() for a, b in zip(grads["kernel"], grads["plain"]))
    lk, lp = losses["kernel"], losses["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    if not err <= 1e-4 * size or not rel <= 1e-5:
        fail("train-parity", f"grads max|err| {err} (largest grad {size}), losses "
             f"{lk} vs {lp} (rel {rel})")
    print(f"train-parity: float32, {cfg.n_layer} layers x {cfg.n_embd}, B=2 "
          f"T={tc.block_size}: "
          f"first-step grads max|err| {err:.3e} (largest {size:.3e}), losses "
          f"{[round(x, 6) for x in lk]} vs {[round(x, 6) for x in lp]} (rel {rel:.2e}) "
          "through K2-K4 and their plain versions", flush=True)


TRAIN_BF16_GRAD_REL = 2.0 ** -5  # per leaf, ||g_kernel - g_plain|| / ||g_plain||
TRAIN_BF16_LOSS_REL = 2.0 ** -8


def phase_train_parity_bf16():
    """bfloat16, 4 layers at full width, B=2, T=2048: one gradient through
    K2-K4 (the tensor-core kernels) and one through their plain versions
    (`flash_kernel=False`, float32 math on bfloat16 inputs) from the same
    params and batch.  Per leaf, ||g_kernel - g_plain||_2 <=
    TRAIN_BF16_GRAD_REL ||g_plain||_2, and the losses agree within
    TRAIN_BF16_LOSS_REL (relative)."""
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.training import cross_entropy_loss
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device=DEVICE)
    transformer.tree_map(lambda x: x.requires_grad_(True), params)
    leaves = transformer.tree_leaves(params)
    data = synthetic_tokens(1 << 20, seed=5)
    x, y = (torch.as_tensor(b, device=DEVICE).long() for b in
            data_loader.get_batch(data, 2, TRAIN["block_size"], np.random.default_rng(6)))
    grads, losses = {}, {}
    n = cfg.n_layer
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        reset_flash_counts()
        loss = cross_entropy_loss(cfg, params, x, y, remat=True, use_flash=True,
                                  flash_kernel=flash_kernel)
        grads[route] = [g.float() for g in torch.autograd.grad(loss, leaves)]
        losses[route] = loss.item()
        got = flash_counts()
        # one gradient with remat: per layer K2 twice, K3 and K4 once, or
        # their plain versions
        want = ({"K2": 2 * n, "K3": n, "K4": n, "plain": 0} if route == "kernel"
                else {"K2": 0, "K3": 0, "K4": 0, "plain": 4 * n})
        if got != want:
            fail("train-parity-bf16", f"the {route} run launched {got}; want {want}")
        torch.cuda.empty_cache()
    ratios = []
    for i, (a, b) in enumerate(zip(grads["kernel"], grads["plain"])):
        norm = b.norm().item()
        ratios.append(((a - b).norm().item() / norm if norm > 0 else (a - b).norm().item(), i))
    worst, leaf = max(ratios)
    lk, lp = losses["kernel"], losses["plain"]
    rel = abs(lk - lp) / abs(lp)
    print(f"train-parity-bf16: bfloat16, {n} layers x {cfg.n_embd}, B=2 "
          f"T={TRAIN['block_size']}: worst leaf ||g_kernel - g_plain|| / ||g_plain|| "
          f"{worst:.3e} (leaf {leaf} of {len(leaves)}; limit {TRAIN_BF16_GRAD_REL:.3e}), "
          f"loss {lk:.6f} vs {lp:.6f} (rel {rel:.2e}, limit {TRAIN_BF16_LOSS_REL:.2e}) "
          "through K2-K4 and their plain versions", flush=True)
    if not worst <= TRAIN_BF16_GRAD_REL or not rel <= TRAIN_BF16_LOSS_REL:
        fail("train-parity-bf16", f"gradient ratio {worst} (leaf {leaf}), loss rel {rel}")
    del grads, params, leaves
    torch.cuda.empty_cache()


# the HF config.json of tiny-llama-1.1b that `Config.from_hf_config` maps
# back onto the registry entry (TinyLlama-1.1B's published config)
TINY_LLAMA_HF = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "_name_or_path": TINY_LLAMA, "vocab_size": 32000, "hidden_size": 2048,
    "intermediate_size": 5632, "num_hidden_layers": 22, "num_attention_heads": 32,
    "num_key_value_heads": 4, "max_position_embeddings": 2048, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": False, "hidden_act": "silu",
    "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16",
}
SHARD_BYTES = 1 << 30  # three safetensors shards for tiny-llama-1.1b in bf16


def write_snapshot(ckpt_dir):
    """The serve phase's weights (tiny-llama-1.1b, bf16, --seed 10137) as a
    HF snapshot in `ckpt_dir`: the port's reverse map into sharded
    safetensors, the index and config.json.  Returns (cfg, params, the
    shard paths, seconds)."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.utils import checkpoint as ck

    cfg = Config.from_name(TINY_LLAMA)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards = ck.write_hf_shards(ck.convert_to_hf_state_dict(cfg, params), ckpt_dir,
                                shard_bytes=SHARD_BYTES)
    (Path(ckpt_dir) / "config.json").write_text(json.dumps(TINY_LLAMA_HF, indent=1))
    return cfg, params, shards, time.perf_counter() - t0


def phase_ckpt(k1, k2, card, ckpt_dir):
    """A real checkpoint through the normal entry points, at full width and
    depth: the serve phase's weights written as a sharded HF snapshot,
    `cli.prepare_model` on it, every loaded leaf bit-identical to the
    original; `cli.serve --ckpt` token-identical to `cli.serve --model` at
    the same seed with K1 at 22 launches per forward; `Generator.generate`
    on the loaded weights over the generate phase's prompts with exactly 22
    K2 launches and the original weights' tokens."""
    import torch

    from mdi_llm_tpu_torch.cli import prepare_model
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.utils import checkpoint as ck

    cfg, params, shards, write_s = write_snapshot(ckpt_dir)
    size = sum(p.stat().st_size for p in shards)
    t0 = time.perf_counter()
    prepare_model.main([str(ckpt_dir)])
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lcfg, loaded = ck.load_checkpoint(ckpt_dir, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    skip = {"hf_config", "padding_multiple"}  # registry-only fields
    if {k: v for k, v in lcfg.asdict().items() if k not in skip} != {
            k: v for k, v in cfg.asdict().items() if k not in skip}:
        fail("ckpt", f"the converted config differs from {TINY_LLAMA}'s")
    want, got = transformer.tree_leaves(params), transformer.tree_leaves(loaded)
    if len(want) != len(got) or not all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(want, got)):
        fail("ckpt", "a loaded leaf is not bit-identical to the written one")

    ckpt_base = ["--ckpt", str(ckpt_dir)] + SERVE_BASE[2:]
    runs = {}
    for label, base in (("--model", SERVE_BASE), ("--ckpt", ckpt_base)):
        t0 = time.perf_counter()
        line, launches, engine, results = serve_checked(
            "ckpt", base + ["--synthetic", "16", "--n-tokens", "64"])
        runs[label] = (line, launches, engine.forward_calls, results,
                       time.perf_counter() - t0)
        del engine
        torch.cuda.empty_cache()
    if runs["--ckpt"][3] != runs["--model"][3]:
        fail("ckpt", "cli.serve --ckpt streams differ from cli.serve --model's")
    line, launches, forwards, results, serve_s = runs["--ckpt"]

    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    outs = {}
    for label, p in (("original", params), ("loaded", loaded)):
        gen = Generator(lcfg, p, max_seq_length=2048, device=DEVICE)
        flash_attention.launches = flash_attention_plain.calls = 0
        t0 = time.perf_counter()
        outs[label], stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        k2_launches, plain = flash_attention.launches, flash_attention_plain.calls
        if k2_launches != 22 or plain:
            fail("ckpt", f"{label} weights: K2 launches {k2_launches} (want 22), "
                 f"plain version calls {plain} (want 0)")
        del gen
    if outs["loaded"] != outs["original"]:
        fail("ckpt", "Generator.generate on the loaded weights differs from the original's")
    print("ckpt: " + json.dumps({
        "shards": len(shards), "snapshot_gib": round(size / 2**30, 3),
        "write_s": round(write_s, 2), "convert_s": round(convert_s, 2),
        "load_s": round(load_s, 2), "serve_s": round(serve_s, 2),
        "serve_tokens_per_s": line["tokens_per_s"], "k1_launches": launches,
        "forwards": forwards, "serve_model_s": round(runs["--model"][4], 2),
        "generate_s": round(gen_s, 2),
        "generate_prefill_s": round(stats.prefill_s, 4), "k2_launches": k2_launches}),
        flush=True)
    print(f"ckpt: {len(shards)} safetensors shards ({size / 2**30:.2f} GiB) written in "
          f"{write_s:.1f} s, converted by cli.prepare_model in {convert_s:.1f} s, "
          f"loaded to the card in {load_s:.1f} s, every leaf bit-identical; cli.serve "
          f"--ckpt (load included) {serve_s:.1f} s against --model's "
          f"{runs['--model'][4]:.1f} s, 16 streams identical, K1 "
          f"{launches} = 22 x {forwards} forwards; generate on the loaded weights: 22 K2 "
          f"launches, the original weights' tokens; on {card}", flush=True)
    k1.setdefault("paths", {})["ckpt"] = launches
    k2.setdefault("paths", {})["ckpt"] = k2_launches
    del params, loaded
    torch.cuda.empty_cache()


CHAT_VOCAB = 32000
CHAT_WORDS = 1500  # the pasted first turn: its prompt bucket is 2048


def write_word_tokenizer(ckpt_dir):
    """A 32000-entry word-level tokenizer.json ("<unk>", "<s>", "</s>",
    then "w3" ... "w31999", split on whitespace), written as the JSON the
    `tokenizers` library saves for one, and its tokenizer_config.json."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"w{i}": i for i in range(3, CHAT_VOCAB)}}
    tok = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
           "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
           "post_processor": None, "decoder": None,
           "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    (Path(ckpt_dir) / "tokenizer.json").write_text(json.dumps(tok))
    (Path(ckpt_dir) / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))


def phase_chat(k2, card, ckpt_dir):
    """`cli.chat --ckpt` through stdin for two turns on the ckpt phase's
    checkpoint with a word-level tokenizer: a pasted 1500-word first turn
    prefills the empty cache through K2 (22 launches), a short second turn
    takes the dense route; the replies equal a direct ChatSession run."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.cli import chat as chat_cli
    from mdi_llm_tpu_torch.cli import prepare_model
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.utils import checkpoint as ck
    from mdi_llm_tpu_torch.utils.prompts import style_for_model
    from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

    if importlib.util.find_spec("tokenizers") is None:
        print("chat: tokenizers is not installed on this machine; the text path is "
              "held on the CPU only", flush=True)
        return
    if not ck.has_checkpoint(ckpt_dir):  # run without the ckpt phase
        write_snapshot(ckpt_dir)
        prepare_model.main([str(ckpt_dir)])
    write_word_tokenizer(ckpt_dir)
    rng = np.random.default_rng(10137)
    turns = [" ".join(f"w{i}" for i in rng.integers(3, CHAT_VOCAB, n)) for n in (CHAT_WORDS, 12)]
    argv = ["--ckpt", str(ckpt_dir), "--device", DEVICE, "--temperature", "0",
            "--n-tokens", "32"]
    old_stdin, sys.stdin = sys.stdin, io.StringIO("\n".join(turns) + "\n")
    printed = io.StringIO()
    flash_attention.launches = flash_attention_plain.calls = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            session = chat_cli.main(argv)
        torch.cuda.synchronize()
        chat_s = time.perf_counter() - t0
    finally:
        sys.stdin = old_stdin
    launches, plain = flash_attention.launches, flash_attention_plain.calls
    if launches != 22 or plain:
        fail("chat", f"K2 launches {launches} (want 22, the first turn's prefill), "
             f"plain version calls {plain} (want 0)")

    tok = Tokenizer(ckpt_dir)
    cfg, params = ck.load_checkpoint(ckpt_dir, dtype=torch.bfloat16, device=DEVICE)
    style = style_for_model(cfg.name)
    direct = Generator(cfg, params, max_seq_length=2048, device=DEVICE).chat_session()
    turn_ids, replies = [], []
    for t in turns:
        turn_ids.append(tok.encode(style.apply(t)).tolist())
        replies.append(list(direct.send(turn_ids[-1], 32, temperature=0.0,
                                        stop_sequences=style.stop_tokens(tok))))
    if session.history != direct.history or not all(replies):
        fail("chat", "cli.chat's conversation differs from a direct ChatSession run")
    text = printed.getvalue()
    if not all(tok.decode(np.asarray(r)) in text for r in replies):
        fail("chat", "cli.chat did not print the decoded replies")
    print("chat: " + json.dumps({
        "turn_tokens": [len(t) for t in turn_ids], "reply_tokens": [len(r) for r in replies],
        "chat_s": round(chat_s, 2), "k2_launches": launches}), flush=True)
    print(f"chat: cli.chat --ckpt, 2 turns through stdin ({len(turn_ids[0])}-token pasted "
          f"prompt into the empty cache: 22 K2 launches; {len(turn_ids[1])}-token second "
          f"turn on the dense route) in {chat_s:.1f} s (load included), replies identical "
          f"to a direct ChatSession; on {card}", flush=True)
    k2.setdefault("paths", {})["chat"] = launches
    del direct, params
    torch.cuda.empty_cache()


GRAPH_ROUTES = (("eager", False), ("graphs", True), ("graphs", True), ("eager", False))
GRAPH_POOLS = (("bf16", []), ("int8", ["--kv-dtype", "int8"]), ("e4m3", ["--kv-dtype", "float8"]))


def graph_serve_run(phase, argv, graphs):
    """The serve CLI's engine (`cli.build`) on one route, its `run()` with
    every count set to 0 just before and read just after.  Fails unless K1
    ran 22 times per forward and the plain route never, and a graph engine
    captured every step when it was built (none inside the run) and
    replayed them; an eager one captures and replays nothing.  Returns
    (results, summary, engine)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    args = cli.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _trace, engine, _tokenizer = cli.build(args, _graphs=graphs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = engine.graph_stats()
    ragged_paged_attention.launches = ragged_paged_attention.merge_launches = 0
    pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
    results, stats = engine.run()
    torch.cuda.synchronize()
    launches = ragged_paged_attention.launches
    plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
    after = engine.graph_stats()
    n_layer = engine.gen.cfg.n_layer
    if n_layer != 22 or launches <= 0 or launches != n_layer * engine.forward_calls or plain:
        fail(phase, f"_graphs={graphs}: K1 launches {launches} != {n_layer} x "
             f"{engine.forward_calls} forwards, plain route {plain}")
    if graphs and (built["captures"] != built["steps"] or after["captures"] != built["captures"]
                   or after["replays"] <= 0):
        fail(phase, f"graph engine: {built} when built, {after} after the run")
    if not graphs and (after["captures"] or after["replays"]):
        fail(phase, f"eager engine captured or replayed: {after}")
    summary = {"route": "graphs" if graphs else "eager",
               "tokens_per_s": round(stats.tokens_per_s, 2), "wall_s": round(stats.wall_s, 4),
               "decode_s": round(stats.decode_s, 4), "prefill_s": round(stats.prefill_s, 4),
               "host_syncs": stats.host_syncs, "forward_calls": engine.forward_calls,
               "k1_launches": launches, "graph_captures": built["captures"],
               "graph_replays": after["replays"], "capture_s": round(built["capture_s"], 4),
               "build_s": round(build_s, 3),
               "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
    return results, summary, engine


def sampled_frequencies_ok(phase, gen, n_requests=512, top_k=4, temperature=0.8):
    """The distribution test of the port's CPU suite, on the card:
    `n_requests` requests of one prompt, 2 new tokens each, at
    `temperature` and `top_k`.  The first token (the mixed step's draw)
    must follow the filtered softmax of the prompt's last logits, and the
    second (the decode step's) the filtered softmax after each first token
    that came up at least 64 times: |freq - p| < 5 sigma + 1e-3 per token,
    p from a dense forward of the same model."""
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.sampling import filtered_logits, sampling_operands

    prompt = long_prompts((24,), gen.cfg.vocab_size, seed=3)[0]
    engine = gen.serve(block_size=16, max_batch=8, temperature=temperature, top_k=top_k)
    for i in range(n_requests):
        engine.add_request(f"s{i}", prompt, 2)
    results, _ = engine.run()
    draws = np.array([results[f"s{i}"][len(prompt):] for i in range(n_requests)])
    t_op, p_op = sampling_operands(temperature, None, device="cuda")

    def probs(ctx):
        with torch.no_grad():
            logits = transformer.forward(gen.cfg, gen.params, torch.tensor([ctx], device="cuda"),
                                         torch.zeros(1, dtype=torch.long, device="cuda"))
        f = filtered_logits(logits[0, -1:], t_op, p_op, mode="top_k", top_k=top_k)
        return torch.softmax(f, dim=-1)[0].cpu().numpy()

    firsts, counts = np.unique(draws[:, 0], return_counts=True)
    cases = [(prompt, draws[:, 0])] + [(prompt + [int(t)], draws[draws[:, 0] == t, 1])
                                       for t, c in zip(firsts, counts) if c >= 64]
    worst = 0.0
    for ctx, got in cases:
        p = probs(ctx)
        freq = np.bincount(got, minlength=len(p)) / len(got)
        ratio = float(np.max(np.abs(freq - p) / (5.0 * np.sqrt(p * (1.0 - p) / len(got)) + 1e-3)))
        worst = max(worst, ratio)
        if not ratio < 1.0 or np.any(freq[p == 0.0] > 0):
            fail(phase, f"sampled draws after {len(ctx)} tokens: frequencies {freq[p > 0]} "
                 f"against {p[p > 0]} over {len(got)} draws")
    print(f"{phase}: sampled distribution test: {len(cases)} positions, worst "
          f"|freq - p| / (5 sigma + 1e-3) {worst:.3f} over {n_requests} requests", flush=True)
    del engine
    torch.cuda.empty_cache()


def paged_write_ms(kv_dtype, lanes=8, n_layer=22):
    """Device ms of one decode forward's paged K/V writes (`paged_update`
    of `lanes` tokens into each of `n_layer` layers of a tiny-llama pool
    stored as `kv_dtype`), timed as replays of one CUDA graph that holds
    all of them."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.paged_attention import paged_update

    cfg = Config.from_name(TINY_LLAMA)
    nb = 1 + lanes * 128
    kv = transformer.init_paged_kv_cache(cfg, nb, 16, dtype=kv_dtype, device="cuda",
                                         n_layer=n_layer)
    g = torch.Generator(device="cuda").manual_seed(5)
    new = torch.randn((n_layer, 2, lanes, 1, cfg.n_query_groups, cfg.head_size),
                      generator=g, device="cuda").to(torch.bfloat16)
    tables = torch.arange(1, nb, device="cuda", dtype=torch.int32).reshape(lanes, 128)
    pos = torch.tensor([[37 + 211 * i] for i in range(lanes)], device="cuda")

    def writes():
        for layer in range(n_layer):
            kl, vl = (transformer._layer_pool(kv[side], layer) for side in ("k", "v"))
            paged_update(kl, vl, new[layer, 0], new[layer, 1], tables, pos)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        writes()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        writes()
    return cuda_ms(graph.replay, 50)


def phase_graphs(k1, k2, card):
    """CUDA graphs against eager launches of the same steps, in turns
    eager, graph, graph, eager (the module docstring, phase 15)."""
    import statistics

    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    def medians(runs):
        return {route: statistics.median(s["tokens_per_s"] for _, s in runs if s["route"] == route)
                for route in ("eager", "graphs")}

    base = SERVE_BASE + ["--synthetic", "16", "--n-tokens", "64"]
    graph_serve_run("graphs", SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8"], True)
    for pool, extra in GRAPH_POOLS:
        runs = []
        for route, graphs in GRAPH_ROUTES:
            results, summary, engine = graph_serve_run("graphs", base + extra, graphs)
            runs.append((results, summary))
            print(f"graphs: serve {pool} pool: " + json.dumps(summary), flush=True)
            if pool == "bf16" and graphs:
                k1.setdefault("paths", {})["graphs"] = summary["k1_launches"]
            gen = engine.gen
            del engine
            torch.cuda.empty_cache()
        syncs = {s["host_syncs"] for _, s in runs}
        if len(syncs) != 1:
            fail("graphs", f"{pool} pool: host_syncs differ between runs: {syncs}")
        for a, b in ((1, 0), (2, 3)):
            divergence_ok("graphs", gen, runs[a][0], runs[b][0], f"{pool} pool, graphs vs eager")
        same = sum(runs[1][0][r] == runs[0][0][r] for r in runs[0][0])
        med = medians(runs)
        print(f"graphs: serve {pool} pool: {same} of {len(runs[0][0])} greedy streams identical "
              f"between eager and graph runs, host_syncs {syncs.pop()} on every run; median "
              f"tokens/s eager {med['eager']} graphs {med['graphs']} "
              f"(x{med['graphs'] / med['eager']:.3f}); on {card}", flush=True)
        del gen
        torch.cuda.empty_cache()

    cfg = Config.from_name(TINY_LLAMA)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device="cuda")
    gens = {graphs: Generator(cfg, params, max_seq_length=2048, device="cuda", _graphs=graphs)
            for graphs in (False, True)}
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    first = {}
    for graphs, gen in gens.items():  # first calls: the graph route captures here
        outs, stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
        first[graphs] = (outs, stats.captures, stats.capture_s)
    if not first[True][1] > 0 or first[False][1]:
        fail("graphs", f"generate's first calls captured {first[True][1]} (graphs) and "
             f"{first[False][1]} (eager) decode-chunk graphs")
    runs = []
    for route, graphs in GRAPH_ROUTES:
        gen = gens[graphs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention_plain.calls = 0
        outs, stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
        torch.cuda.synchronize()
        launches, plain = flash_attention.launches, flash_attention_plain.calls
        if launches != 22 or plain or stats.captures:
            fail("graphs", f"generate ({route}): K2 launches {launches}, plain {plain}, "
                 f"captures {stats.captures} (want 22, 0, 0)")
        summary = {"route": route, "tokens_per_s": round(stats.tokens_per_s, 2),
                   "decode_s": round(stats.decode_s, 4), "prefill_s": round(stats.prefill_s, 4),
                   "graph_captures": stats.captures, "graph_steps": gen.graph_stats()["steps"],
                   "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
        print("graphs: generate: " + json.dumps(summary), flush=True)
        runs.append((outs, summary))
        if graphs:
            k2.setdefault("paths", {})["graphs"] = launches
    if any(outs != first[False][0] for outs, _ in runs) or first[True][0] != first[False][0]:
        fail("graphs", "generate's greedy tokens differ between eager and graph runs")
    med = medians(runs)
    kept = sum(x.numel() * x.element_size() for kv in gens[True]._caches.values()
               for x in kv.values())
    # the graphs' private pools: what the card gets back when they go
    n_steps = gens[True].graph_stats()["steps"]
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    gens[True]._steps.clear()
    torch.cuda.empty_cache()
    pools = (reserved - torch.cuda.memory_reserved()) / 2**20
    print(f"graphs: generate: tokens identical on every run; the first graph call captured "
          f"{first[True][1]} decode chunks in {first[True][2]:.3f} s, the later ones none; "
          f"median decode tokens/s eager {med['eager']} graphs {med['graphs']} "
          f"(x{med['graphs'] / med['eager']:.3f}); between calls the Generator keeps "
          f"{len(gens[True]._caches)} dense caches ({kept / 2**20:.1f} MiB) and {n_steps} "
          f"step graphs whose private pools hold {pools:.1f} MiB; on {card}", flush=True)
    del gens
    torch.cuda.empty_cache()

    # the sampled check: the same generator state on both routes
    serve_draws = {}
    for route, graphs in GRAPH_ROUTES[:2]:
        serve_draws[route], _summary, engine = graph_serve_run(
            "graphs", base + ["--temperature", "0.8"], graphs)
        del engine
        torch.cuda.empty_cache()
    gen_draws = {graphs: Generator(cfg, params, max_seq_length=2048, device="cuda",
                                   _graphs=graphs).generate(prompts, 32, temperature=0.8,
                                                            top_k=None)[0]
                 for graphs in (False, True)}
    same = sum(serve_draws["graphs"][r] == serve_draws["eager"][r] for r in serve_draws["eager"])
    print(f"graphs: temperature 0.8 from the same generator state: {same} of "
          f"{len(serve_draws['eager'])} serve streams and "
          f"{sum(a == b for a, b in zip(gen_draws[True], gen_draws[False]))} of "
          f"{len(prompts)} generate samples identical draw for draw between eager and "
          "graph runs", flush=True)
    # the distribution test holds the graph route's draws either way; it is
    # the whole check where the draws differ from eager's.  float32, so the
    # dense reference's top-k set is the engine's (in bf16 the two routes'
    # roundings can swap a near-tie at the top-k boundary)
    del params
    torch.cuda.empty_cache()
    sampled_frequencies_ok("graphs", tiny_llama_generator(4, torch.float32))
    torch.cuda.empty_cache()

    ms = {kind: paged_write_ms(kind) for kind in ("int8", torch.bfloat16)}
    print(f"graphs: paged K/V writes of one decode forward (8 lanes x 22 layers), device "
          f"time as graph replays: int8 pool {ms['int8']:.4f} ms, bf16 pool "
          f"{ms[torch.bfloat16]:.4f} ms; on {card}", flush=True)


PHASES = ("kernel", "serve", "serve-parity", "kernel-q8", "serve-q8", "serve-q8-parity",
          "spec", "spec-parity", "flash", "generate", "generate-parity", "flash-bwd",
          "train", "train-parity", "train-parity-bf16", "ckpt", "chat", "graphs")


def main(argv=None) -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="bring-up check of the port on one GPU")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    only = set(ap.parse_args(argv).only.split(","))
    if not only <= set(PHASES):
        fail("args", f"unknown phases {sorted(only - set(PHASES))}")
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is False: this check needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from mdi_llm_tpu_torch import kernels

    t0 = time.perf_counter()
    seconds = kernels.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"({time.perf_counter() - t0:.2f} s wall)", flush=True)
    for name in kernels.SOURCES:
        regs = [ln.strip() for ln in (kernels.BUILD_DIR / f"{name}.log")
                .read_text().splitlines() if "registers" in ln]
        print(f"build: {name} ptxas: {regs[:12]}", flush=True)

    k1 = {
        "name": "K1 ragged_paged_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "mdi_llm_tpu/ops/ragged_paged_attention.py:123",
    }
    k1q8 = {
        "name": "K1 ragged_paged_attention over int8 pools",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "mdi_llm_tpu/ops/ragged_paged_attention.py:171",
    }
    k2 = {
        "name": "K2 flash_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:40",
    }
    k3 = {
        "name": "K3 flash_dq",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:181",
    }
    k4 = {
        "name": "K4 flash_dkv",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:229",
    }
    runs = {
        "kernel": lambda: phase_kernel(k1),
        "serve": lambda: phase_serve(k1),
        "serve-parity": phase_serve_parity,
        "kernel-q8": lambda: phase_kernel_q8(k1q8),
        "serve-q8": lambda: phase_serve_q8(k1q8),
        "serve-q8-parity": phase_serve_q8_parity,
        "spec": phase_spec,
        "spec-parity": phase_spec_parity,
        "flash": lambda: phase_flash(k2),
        "generate": lambda: phase_generate(k2),
        "generate-parity": phase_generate_parity,
        "flash-bwd": lambda: phase_flash_bwd(k3, k4),
        "train": lambda: phase_train(k3, k4),
        "train-parity": phase_train_parity,
        "train-parity-bf16": phase_train_parity_bf16,
        "ckpt": lambda: phase_ckpt(k1, k2, card, ckpt_dir),
        "chat": lambda: phase_chat(k2, card, ckpt_dir),
        "graphs": lambda: phase_graphs(k1, k2, card),
    }
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = Path(tmp) / TINY_LLAMA
        for phase in PHASES:
            if phase in only:
                t = time.perf_counter()
                runs[phase]()
                print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "paths")
    records = (k1, k1q8, k2, k3, k4)
    missing = [(r["name"], k) for r in records for k in keys if k not in r]
    k2_paths = {"generate", "ckpt", "graphs"} | (
        {"chat"} if importlib.util.find_spec("tokenizers") else set())
    if only == set(PHASES) and (set(k1["paths"]) != {"serve", "ckpt", "graphs"}
                                or set(k2["paths"]) != k2_paths):
        fail("record", f"K1 paths {k1['paths']}, K2 paths {k2['paths']}")
    if only == set(PHASES) and missing:
        fail("record", f"kernels line lacks {missing}")
    print(card)
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
