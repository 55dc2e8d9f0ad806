#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`mdi_llm_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device  — torch.cuda must be available; prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds every kernel of the serving path from `csrc/` (one
   nvcc each, started together) and prints the build seconds.
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

The line before the last is the JSON `kernels` record; the last line is
`{"ok": true, "device": {...}}`.
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
    regs = [ln.strip() for ln in (kernels.BUILD_DIR / "ragged_paged_attention.log")
            .read_text().splitlines() if "registers" in ln]
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"({time.perf_counter() - t0:.2f} s wall); K1 ptxas: {regs[:6]}", flush=True)

    record = {
        "name": "K1 ragged_paged_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "mdi_llm_tpu/ops/ragged_paged_attention.py:123",
    }
    phase_kernel(record)
    phase_serve(record)
    phase_serve_parity()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
