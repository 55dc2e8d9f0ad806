#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`mdi_llm_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device  — torch.cuda must be available; prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds every kernel of the serving and generation paths from
   `csrc/` (one nvcc each, started together) and prints the build seconds.
3. kernel  — kernel K1 (ragged paged attention) against its plain PyTorch
   version on the card, at tiny-llama-1.1b geometry (32 heads, 4 KV
   groups, head size 64, 16-token blocks, 2048-token tables), in float32
   and bfloat16: pure decode of 8 slots at depths up to 2000; a mixed step
   (decode lanes, a 128-token prefill chunk, an absent slot, padding
   rows); verify-width spans of 5.  Owned rows are compared, rows no slot
   owns must be zero.  Tolerance: float32 max |err| <= 1e-4; bfloat16 max
   |err| <= 1.5e-2 against the plain version run in float32 on the same
   bfloat16 inputs (one bfloat16 rounding of outputs of size ~1 is ~4e-3).
   Prints the kernel's time, the plain version's, scaled_dot_product_
   attention's on the gathered dense view (a yardstick the port never
   calls) and the least time the card could take.
4. serve   — the serve CLI's path, `--model tiny-llama-1.1b` at full width
   and all 22 layers, bf16, random weights from --seed, 16 synthetic
   requests, 8 slots, 2048-token window, 64 new tokens, chunked decode
   (8 steps) with double buffering.  Every request must finish with its
   token budget, every token must be in the vocabulary, K1 must have been
   launched 22 times per model forward and the plain route never.
5. serve parity — float32, 4 layers at full width, 4 requests of 16 new
   tokens, served through the kernel route and through the plain route on
   the card: the greedy streams must be identical.
6. flash   — kernel K2 (flash self-attention) against its plain PyTorch
   version on the card, 32 heads, 4 KV groups, head size 64, in float32
   and bfloat16: causal B=4 T=2048 (the generate phase's prefill shape),
   causal T=1000 with the LSE (T not a multiple of the tile), non-causal
   T=512 with the LSE.  Tolerances as for K1, the LSE's too.  Prints the
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

The line before the last is the JSON `kernels` record (K1, K2); the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    rows below each present slot's lens), each output byte written once,
    against the flops of QK and PV over the keys each owned row sees."""
    q, k, _, tables, _, q_len, lens, q_pos = args
    _, H, T, hs = q.shape
    G, item = k.shape[2], q.element_size()
    kv_rows = int(lens[q_len > 0].long().sum())
    nbytes = 2 * q.numel() * item + 2 * kv_rows * G * hs * item
    nbytes += 4 * (tables.numel() + 3 * q_len.numel() + T)
    flops = 4 * H * hs * int((q_pos[:n_owned].long() + 1).sum())
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(args, scale):
    """scaled_dot_product_attention on the gathered dense view of the same
    batch: per slot, its padded query rows against its contiguous K/V."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import gather_paged_kv

    q, k, v, tables, q_start, q_len, _, q_pos = args
    kd, vd = gather_paged_kv(k, tables), gather_paged_kv(v, tables)  # (S, G, W, hs)
    S, W = tables.shape[0], kd.shape[2]
    L = max(1, int(q_len.max()))
    rows = (q_start.long()[:, None] + torch.arange(L, device="cuda")[None]).clamp(max=q.shape[2] - 1)
    qd = q[0][:, rows].permute(1, 0, 2, 3).contiguous()  # (S, H, L, hs)
    live = torch.arange(L, device="cuda")[None] < q_len[:, None]
    pos = torch.where(live, q_pos.long()[rows], 0)
    mask = (torch.arange(W, device="cuda")[None, None] <= pos[..., None])[:, None]
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)


def phase_kernel(record):
    import torch

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    cases = {
        "decode": ([(d, 1) for d in (37, 250, 511, 800, 1203, 1500, 1777, 2000)], 8),
        "mixed": ([(d, 1) for d in (64, 700, 1400, 1999, 333, 1024)]
                  + [(300, 128), (0, 0)], 136),
        "verify": ([(d, 5) for d in (10, 400, 900, 1300, 1700, 2040, 555)] + [(0, 0)], 40),
    }
    scale = 64 ** -0.5
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for label, (spans, T) in cases.items():
            args, owned = make_case(spans, T, dtype, seed=len(spans) + T)
            out = ragged_paged_attention(*args, scale=scale)
            torch.cuda.synchronize()
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
            print(f"kernel: K1 {name} {label} T={T} max_abs_err={err:.3e} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
            if name == "bfloat16" and label == "decode":  # the main path's decode shape
                record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
    record["max_abs_err"] = worst


def phase_serve(record):
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    base = ["--model", TINY_LLAMA, "--dtype", "bfloat16", "--seed", "10137",
            "--max-batch", "8", "--block-size", "16", "--sequence-length", "2048"]
    # warm-up (CUDA context, cuBLAS handles), not counted
    cli.serve(cli.build_parser().parse_args(base + ["--synthetic", "2", "--n-tokens", "8"]))
    torch.cuda.synchronize()
    args = cli.build_parser().parse_args(base + ["--synthetic", "16", "--n-tokens", "64"])
    ragged_paged_attention.launches = 0
    pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
    trace, results, stats, engine = cli.serve(args)
    torch.cuda.synchronize()
    launches = ragged_paged_attention.launches
    plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
    n_layer = engine.gen.cfg.n_layer
    vocab = engine.gen.cfg.padded_vocab_size
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new:
            fail("serve", f"{rid} did not finish with its {new} tokens")
        if not all(0 <= t < vocab for t in out[len(prompt):]):
            fail("serve", f"{rid} produced a token outside the vocabulary")
    if n_layer != 22 or launches <= 0 or launches != n_layer * engine.forward_calls:
        fail("serve", f"K1 launches {launches} != {n_layer} layers x "
             f"{engine.forward_calls} forwards")
    if plain:
        fail("serve", f"the plain attention route ran {plain} times on the card")
    line = cli.stats_line(stats, engine)
    print("serve: " + json.dumps({k: line[k] for k in (
        "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s",
        "prefill_s", "mixed_steps", "decode_steps", "host_syncs",
        "kv_block_utilization_mean", "kv_block_utilization_peak", "forward_calls")}),
        flush=True)
    print(f"serve: K1 launches {launches} = {n_layer} per forward x "
          f"{engine.forward_calls} forwards ({stats.mixed_steps} mixed steps, "
          f"{stats.decode_steps} decode steps in chunks of {args.decode_chunk}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    record["launches"] = launches


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
    if streams["kernel"] != streams["plain"]:
        bad = [r for r in streams["kernel"] if streams["kernel"][r] != streams["plain"].get(r)]
        fail("serve-parity", f"greedy streams differ for {bad}")
    n = sum(len(v) for v in streams["kernel"].values())
    print(f"serve-parity: float32, {cfg.n_layer} layers x {cfg.n_embd}: "
          f"{len(trace)} greedy streams ({n} tokens) identical through K1 and "
          "the plain route", flush=True)

FLASH_SHAPES = {  # label: (B, T, causal, with_lse)
    "main": (4, 2048, True, False),
    "ragged": (2, 1000, True, True),
    "noncausal": (2, 512, False, True),
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
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for label, (B, T, causal, with_lse) in FLASH_SHAPES.items():
            q, k, v = flash_inputs(B, T, dtype, seed=T + B)
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
            b_ms, b_by = flash_bound(B, 32, 4, T, 64, dtype, causal, with_lse)
            print(f"flash: K2 {name} {label} B={B} T={T} causal={causal} "
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
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "k2_launches": launches, "k2_plain_calls": plain}), flush=True)
    record["launches"] = launches
    del gen
    torch.cuda.empty_cache()

    args = sample_cli.build_parser().parse_args(
        ["--model", TINY_LLAMA, "--n-samples", "4", "--n-tokens", "32", "--greedy"])
    flash_attention.launches = flash_attention_plain.calls = 0
    prompt_ids, outs, stats, gen, seconds = sample_cli.run(args)
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


def main() -> None:
    import torch

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
        print(f"build: {name} ptxas: {regs[:6]}", flush=True)

    k1 = {
        "name": "K1 ragged_paged_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "mdi_llm_tpu/ops/ragged_paged_attention.py:123",
    }
    k2 = {
        "name": "K2 flash_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:40",
    }
    phase_kernel(k1)
    phase_serve(k1)
    phase_serve_parity()
    phase_flash(k2)
    phase_generate(k2)
    phase_generate_parity()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
