"""Text generation CLI of the port, one device.

Port of the single-device branch of `mdi_llm_tpu/cli/sample.py`:
`Generator.generate` over `--n-samples` prompts.  With `--ckpt DIR` the
prompts (`--prompt TEXT` or `FILE:<path>`, one per blank-line-separated
paragraph) go through the checkpoint's prompt style and tokenizer,
generation stops at the style's stop sequences, and the samples print
decoded.  With `--model NAME` (random weights from `--seed`, no
tokenizer) every prompt is 8 random token ids drawn from `--seed` and the
samples print as token ids.  Runs on the GPU unless `--device cpu` is
given; without a GPU and without that flag it raises.  Flags of features
the port does not carry yet are refused.

    python -m mdi_llm_tpu_torch.cli.sample --ckpt checkpoints/tiny-llama --prompt "Once upon a time,"
    python -m mdi_llm_tpu_torch.cli.sample --model tiny-llama-1.1b --n-samples 4 --greedy
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from mdi_llm_tpu_torch.cli._common import (
    add_common_args,
    add_run_args,
    load_model,
    refuse,
    report_run,
    resolve_kv_dtype,
)
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.utils.prompts import get_user_prompt

# flags of the JAX CLI whose features are not ported: refused when set
_UNPORTED = {
    "pipeline_stages": 0, "sp_devices": 0, "tp_devices": 0, "ep_devices": 0,
    "coordinator": None, "profile_dir": None,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    add_run_args(ap)
    ap.add_argument("--chunk", type=int, default=16, help="decode steps per host read")
    ap.add_argument(
        "--speculative", type=int, default=0, metavar="K",
        help="greedy speculative decoding with K-token n-gram drafts "
        "(single sample, temperature 0; exact)",
    )
    unported = ap.add_argument_group("not ported yet (refused when set)")
    for flag in ("--pipeline-stages", "--sp-devices", "--tp-devices", "--ep-devices"):
        unported.add_argument(flag, type=int, default=0)
    unported.add_argument("--coordinator", default=None)
    unported.add_argument("--profile-dir", default=None)
    return ap


def run(args):
    """Build the model the flags describe and generate; returns
    (prompt_ids, outs, stats, gen, tokenizer, seconds)."""
    from mdi_llm_tpu_torch.generation import Generator

    for name, default in _UNPORTED.items():
        if getattr(args, name) != default:
            refuse("--" + name.replace("_", "-"))
    temperature = 0.0 if args.greedy else args.temperature
    if args.speculative and (temperature != 0.0 or args.n_samples != 1):
        raise SystemExit(
            "--speculative requires --greedy (or --temperature 0) and --n-samples 1"
        )
    resolve_device(args.device)  # raises before any work without the device
    cfg, params, tokenizer, prompt_style = load_model(args)
    raw_prompts = get_user_prompt(args.prompt, args.n_samples)
    if tokenizer is not None:
        prompt_ids = [tokenizer.encode(prompt_style.apply(p)).tolist() for p in raw_prompts]
        stop_seqs = prompt_style.stop_tokens(tokenizer)
    else:
        rng = np.random.default_rng(args.seed)
        prompt_ids = [rng.integers(1, cfg.vocab_size, 8).tolist() for _ in raw_prompts]
        stop_seqs = ()
    t0 = time.perf_counter()
    gen = Generator(
        cfg, params, max_seq_length=args.sequence_length, rng_seed=args.seed,
        cache_dtype=resolve_kv_dtype(args.kv_dtype),
        device=args.device,
    )
    outs, stats = gen.generate(
        prompt_ids, args.n_tokens, temperature=temperature, top_k=args.top_k,
        top_p=args.top_p, stop_sequences=stop_seqs, chunk_size=args.chunk,
        speculative=args.speculative or None,
    )
    return prompt_ids, outs, stats, gen, tokenizer, time.perf_counter() - t0


def main(argv=None):
    args = build_parser().parse_args(argv)
    prompt_ids, outs, stats, gen, tokenizer, seconds = run(args)
    report_run(args, gen.cfg, tokenizer, prompt_ids, outs, stats, seconds)
    if stats.interrupted:
        raise SystemExit(130)  # conventional SIGINT exit code
    return outs


if __name__ == "__main__":
    main()
