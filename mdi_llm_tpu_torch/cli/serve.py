"""Offline serving driver of the port: a request trace through the
paged-KV continuous-batching engine (`serving/engine.py`).

Port of `mdi_llm_tpu/cli/serve.py` on one device: the weights of
`--ckpt DIR` (HF weights in it are converted in place first) or random
weights of `--model NAME` from `--seed`; the trace is text prompts
(`--prompt-file`, one per line, or `--prompt` repeated `--n-requests`
times) tokenized by the checkpoint's tokenizer, with the outputs printed
decoded, or a mixed-length synthetic trace (`--synthetic N`, no
tokenizer needed); the same one-line JSON stats summary goes to stderr.
`--kv-dtype int8` serves over the quantized pool and `--kv-dtype float8`
over an e4m3 pool;
`--spec-k K` turns on speculative serving (n-gram drafts, and with
`--draft-model NAME` a randomly initialised draft model where the lookup
misses).  Runs on the GPU unless `--device cpu` is given; without a GPU
and without that flag it raises.  Flags of features the port does not
carry yet are refused.

    python -m mdi_llm_tpu_torch.cli.serve --ckpt checkpoints/tiny-llama --prompt-file prompts.txt
    python -m mdi_llm_tpu_torch.cli.serve --model tiny-llama-1.1b --synthetic 16
    python -m mdi_llm_tpu_torch.cli.serve --device cpu --model pythia-14m \\
        --synthetic 3 --max-batch 2 --n-tokens 8 --sequence-length 128 --block-size 8
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from mdi_llm_tpu_torch.cli._common import (
    DTYPES,
    add_common_args,
    load_model,
    refuse,
    resolve_kv_dtype,
)
from mdi_llm_tpu_torch.generation import resolve_device

# flags of the JAX CLI whose features are not ported: refused when set
_UNPORTED = {
    "host_pool_mib": 0, "tp": 1, "pp": 1,
    "metrics_out": None, "prom_out": None, "trace_out": None,
    "xprof_steps": None, "sample_rss": None,
}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap, serving_kv=True)
    ap.add_argument("--n-tokens", type=int, default=128,
                    help="max new tokens per request")
    ap.add_argument("--prompt", default="Once upon a time,",
                    help="prompt text used when no --prompt-file/--synthetic")
    ap.add_argument("--prompt-file", type=Path, default=None,
                    help="file with one prompt per line")
    ap.add_argument("--n-requests", type=int, default=8,
                    help="requests queued when using --prompt")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="queue N synthetic requests with mixed prompt/"
                    "output lengths instead of text prompts")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV pool block width (tokens)")
    ap.add_argument("--max-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: full coverage)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="concurrent decode slots")
    ap.add_argument("--prefill-chunk", type=int, default=128,
                    help="max prompt tokens one sequence feeds per step")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="unified-step token budget (default max_batch + "
                    "prefill-chunk)")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="device decode steps per host read (1 = per step)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative serving: draft K tokens per request "
                    "(n-gram prompt lookup, or --draft-model where the "
                    "lookup misses) and verify them in one ragged forward "
                    "over the paged pool, emitting up to K+1 tokens per "
                    "host read; exact-match verify at temperature 0, "
                    "rejection-sampled verify above it (0 disables)")
    ap.add_argument("--draft-model", default=None, metavar="NAME",
                    help="registry name of a small draft model for "
                    "speculative serving (needs --spec-k > 0), in a second "
                    "paged pool; its weights are random (seed 0), so it "
                    "proves the path, not an accept rate")
    ap.add_argument("--no-double-buffer", action="store_true",
                    help="do not launch the next decode chunk before "
                    "reading the current one")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable hash-based prefix block reuse")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="engine-wide sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "priority", "fair", "deadline"),
                    help="scheduling policy (serving/policy.py)")
    unported = ap.add_argument_group("not ported yet (refused when set)")
    unported.add_argument("--host-pool-mib", type=int, default=0)
    unported.add_argument("--tp", type=int, default=1)
    unported.add_argument("--pp", type=int, default=1)
    for flag in ("--metrics-out", "--prom-out", "--trace-out", "--xprof-steps",
                 "--sample-rss"):
        unported.add_argument(flag, default=None)
    return ap


def synthetic_trace(n: int, vocab: int, max_seq: int, max_new: int, seed=10137):
    """Mixed-length request trace (the JAX CLI's, draw for draw): prompt
    lengths spread over the first quarter of the window, output budgets
    over [8, max_new]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, max(5, max_seq // 4)))
        new = int(rng.integers(8, max(9, max_new + 1)))
        new = max(1, min(new, max_seq - plen - 1))
        prompt = rng.integers(1, vocab, plen).tolist()
        reqs.append((f"syn{i}", prompt, new))
    return reqs


def make_serving_config(args):
    """The ServingConfig the flags describe: --kv-dtype int8 selects the
    quantized pool; the float names reach the pool through the
    Generator's cache dtype (`build_generator`)."""
    from mdi_llm_tpu_torch.config import ServingConfig

    return ServingConfig(
        block_size=args.block_size,
        max_blocks=args.max_blocks,
        max_batch=args.max_batch,
        prefill_chunk=args.prefill_chunk,
        token_budget=args.token_budget,
        decode_chunk=args.decode_chunk,
        spec_k=args.spec_k,
        double_buffer=not args.no_double_buffer,
        prefix_caching=not args.no_prefix_cache,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        draft_model=args.draft_model,
        kv_dtype="int8" if args.kv_dtype == "int8" else None,
    )


def build_generator(args, cfg, params, _graphs=None):
    from mdi_llm_tpu_torch.generation import Generator

    dtype = DTYPES[args.dtype]
    return Generator(
        cfg, params,
        max_seq_length=args.sequence_length,
        cache_dtype=(
            dtype if args.kv_dtype == "int8"
            else resolve_kv_dtype(args.kv_dtype) or dtype
        ),
        rng_seed=args.seed,
        device=args.device,
        _graphs=_graphs,
    )


def build(args, _graphs=None):
    """Build the model and engine the flags describe and queue the trace;
    returns (trace, engine, tokenizer).  On the card the engine's steps are
    CUDA graphs captured here; `_graphs=False` (comparisons only) launches
    them eagerly."""
    from mdi_llm_tpu_torch.serving.policy import make_policy

    for name, default in _UNPORTED.items():
        if getattr(args, name) != default:
            refuse("--" + name.replace("_", "-"))
    resolve_device(args.device)  # raises before any work without the device
    serving_cfg = make_serving_config(args)
    cfg, params, tokenizer, _style = load_model(args, need_tokenizer=not args.synthetic)
    gen = build_generator(args, cfg, params, _graphs=_graphs)
    engine = gen.serve(serving=serving_cfg, policy=make_policy(args.policy))
    if args.synthetic:
        trace = synthetic_trace(
            args.synthetic, cfg.vocab_size, gen.max_seq_length, args.n_tokens
        )
    else:
        if tokenizer is None:
            raise SystemExit(
                "text prompts need a tokenizer (--ckpt); use --synthetic "
                "with --model for tokenizer-free runs"
            )
        if args.prompt_file:
            texts = [ln for ln in args.prompt_file.read_text().splitlines() if ln.strip()]
        else:
            texts = [args.prompt] * args.n_requests
        trace = [(f"req{i}", tokenizer.encode(t).tolist(), args.n_tokens)
                 for i, t in enumerate(texts)]
    for rid, prompt, new in trace:
        engine.add_request(rid, prompt, new)
    return trace, engine, tokenizer


def serve(args, _graphs=None):
    """`build`, then run the trace; returns (trace, results, stats, engine,
    tokenizer)."""
    trace, engine, tokenizer = build(args, _graphs=_graphs)
    results, stats = engine.run()
    return trace, results, stats, engine, tokenizer


def stats_line(stats, engine) -> dict:
    """The JSON stats line: the engine's stats plus device, route and the
    step graphs (captured when the engine was built, outside wall_s)."""
    line = stats.to_dict()
    graphs = engine.graph_stats()
    dev = engine.device
    line.update({
        "kv_dtype": engine.kv_dtype_name,
        "tp": 1,
        "pp": 1,
        "devices": 1,
        "tokens_per_s_per_chip": round(stats.tokens_per_s, 2),
        "forward_calls": engine.forward_calls,
        "draft_forward_calls": engine.draft_forward_calls,
        "graph_captures": graphs["captures"],
        "graph_replays": graphs["replays"],
        "capture_s": round(graphs["capture_s"], 3),
        "device": {
            "type": dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
    })
    return line


def main(argv=None):
    args = build_parser().parse_args(argv)
    trace, results, stats, engine, tokenizer = serve(args)
    for rid, prompt, _new in trace:
        out = results.get(rid, [])
        gen_tokens = out[len(prompt):]
        print(f"--- {rid} ({len(gen_tokens)} new tokens) " + "-" * 30)
        print(tokenizer.decode(np.asarray(out)) if tokenizer is not None else gen_tokens)
    line = stats_line(stats, engine)
    print(json.dumps(line), file=sys.stderr)
    return line


if __name__ == "__main__":
    main()
