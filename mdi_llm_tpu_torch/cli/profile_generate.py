"""Where a `Generator.generate` run's time goes on the GPU, with the
decode chunks as CUDA graphs and as eager launches, in one call.

Builds a registry model in bfloat16 with random weights from seed 10137
and, for each route (the graphs the port runs, then eager launches of the
same step bodies, for comparison), generates once to warm up (the graphs
of these shapes are captured there) and once under `torch.profiler` —
greedy, one random prompt per `--prompt-lens` entry, `--n-tokens` new
tokens in decode chunks of 16, over the model's full window — and prints
one JSON line: the prefill and decode seconds, the device time summed
over all kernels (the profiler sees each kernel of a replayed graph), the
device's idle share of the wall time, and the kernels that took the most
device time.  The profiler's own cost is inside the profiled wall time, so
the idle share is an upper bound.  `--flash-min-len 4096` keeps a
2048-token prefill on the dense route.

    python -m mdi_llm_tpu_torch.cli.profile_generate --model tiny-llama-1.1b \\
        --prompt-lens 1100 1370 1650 1900 --n-tokens 64
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mdi_llm_tpu_torch.cli._common import load_model
from mdi_llm_tpu_torch.cli.profile_serve import device_summary
from mdi_llm_tpu_torch.generation import Generator


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True)
    ap.add_argument("--prompt-lens", type=int, nargs="+", default=[1100, 1370, 1650, 1900])
    ap.add_argument("--n-tokens", type=int, default=64)
    ap.add_argument("--flash-min-len", type=int, default=2048,
                    help="prompt bucket from which prefill runs on K2")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate measures the GPU: it needs a CUDA device")
    args.device, args.dtype, args.seed, args.ckpt, args.quantize = (
        "cuda", "bfloat16", 10137, None, "none")
    cfg, params, _tokenizer, _style = load_model(args)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in args.prompt_lens]
    lines = []
    for route, graphs in (("graphs", True), ("eager", False)):
        gen = Generator(cfg, params, rng_seed=args.seed, flash_min_len=args.flash_min_len,
                        _graphs=graphs)

        def run():
            return gen.generate(prompts, args.n_tokens, temperature=0.0)

        run()  # warm-up: CUDA context, cuBLAS handles, kernel build, captures
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _outs, stats = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        line = {"route": route, **device_summary(prof, wall_s, top=12)}
        line.update(prompt_lens=args.prompt_lens, n_tokens=args.n_tokens,
                    prefill_s=round(stats.prefill_s, 4), decode_s=round(stats.decode_s, 4),
                    tokens_generated=stats.tokens_generated,
                    tokens_per_s=round(stats.tokens_per_s, 2),
                    graph_captures=stats.captures, graph_steps=gen.graph_stats()["steps"])
        print(json.dumps(line), flush=True)
        lines.append(line)
        del gen
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
