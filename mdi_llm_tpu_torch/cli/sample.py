"""Text generation CLI of the port: one device, a tensor-parallel mesh, or
the recurrent pipeline.

Port of `mdi_llm_tpu/cli/sample.py`: `Generator.generate` over
`--n-samples` prompts (with `--tp-devices N` over N tensor-parallel
ranks, every rank on `--device`: `cli._common.make_tp_mesh`), or with
`--pipeline-stages S` the recurrent
pipeline (`parallel/pipeline.PipelineEngine`: S stages in one process on
the device, `--samples-per-slot` samples per ring slot, `--chunk` ring
rotations per steady call, `--overlap-chunks`).  With `--ckpt DIR` the
prompts (`--prompt TEXT` or `FILE:<path>`, one per blank-line-separated
paragraph) go through the checkpoint's prompt style and tokenizer,
generation stops at the style's stop sequences, and the samples print
decoded.  With `--model NAME` (random weights from `--seed`, no
tokenizer) every prompt is 8 random token ids drawn from `--seed` and the
samples print as token ids.  `--profile-dir DIR` writes a torch.profiler
trace of the run (`utils/profiling.profile`), `--debug` a cProfile dump
into `--logs-dir`.  Runs on the GPU unless `--device cpu` is given;
without a GPU and without that flag it raises.  Flags of features the
port does not carry yet are refused, naming their ROADMAP item
(`--tp-devices` with `--pipeline-stages`, a pipe x tp mesh: item 14,
second half); the JAX CLI's exclusions between the parallelism flags hold.

    python -m mdi_llm_tpu_torch.cli.sample --ckpt checkpoints/tiny-llama --prompt "Once upon a time,"
    python -m mdi_llm_tpu_torch.cli.sample --model tiny-llama-1.1b --n-samples 4 --greedy
    python -m mdi_llm_tpu_torch.cli.sample --model tiny-llama-1.1b --n-samples 4 --pipeline-stages 2 --samples-per-slot 2
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8 --tp-devices 2
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from mdi_llm_tpu_torch.cli._common import (
    add_common_args,
    add_log_args,
    add_run_args,
    load_model,
    make_tp_mesh,
    refuse,
    report_run,
    resolve_kv_dtype,
    setup_logging,
)
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.utils.prompts import get_user_prompt

# flags of the JAX CLI whose features are not ported: flag -> (default, item)
_UNPORTED = {"sp_devices": (0, "item 16"), "ep_devices": (0, "item 16"),
             "coordinator": (None, "item 14, second half")}


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
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="recurrent pipeline over S stages (one process, one device)")
    ap.add_argument("--samples-per-slot", type=int, default=1,
                    help="pipeline mode: samples batched per ring slot (M)")
    ap.add_argument("--overlap-chunks", action="store_true",
                    help="pipeline mode: run the next steady chunk before reading "
                    "the previous one's tokens")
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="write a torch.profiler trace of the run here")
    ap.add_argument("--tp-devices", type=int, default=0,
                    help="tensor-parallel generation over N ranks, all on "
                    "--device (0 = off)")
    add_log_args(ap)
    unported = ap.add_argument_group("not ported yet (refused when set)")
    for flag in ("--sp-devices", "--ep-devices"):
        unported.add_argument(flag, type=int, default=0)
    unported.add_argument("--coordinator", default=None)
    return ap


def run(args):
    """Build the model the flags describe and generate; returns
    (prompt_ids, outs, stats, engine, tokenizer, seconds)."""
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.utils.profiling import profile

    if args.tp_devices and args.sp_devices:
        raise SystemExit("--tp-devices is exclusive with --sp-devices")
    if args.tp_devices < 0:
        raise SystemExit("--tp-devices must be a positive device count")
    if args.ep_devices and (args.tp_devices or args.sp_devices or args.pipeline_stages):
        raise SystemExit(
            "--ep-devices is a standalone expert-parallel mesh; drop the "
            "other parallelism flags"
        )
    for name, (default, item) in _UNPORTED.items():
        if getattr(args, name) != default:
            refuse(f"--{name.replace('_', '-')} ({item})")
    if args.tp_devices and args.pipeline_stages:
        refuse("--tp-devices with --pipeline-stages (a pipe x tp mesh, "
               "item 14, second half)")
    temperature = 0.0 if args.greedy else args.temperature
    if args.speculative:
        if args.pipeline_stages:
            raise SystemExit("--speculative applies to single-device decode only "
                             "(drop --pipeline-stages)")
        if temperature != 0.0 or args.n_samples != 1:
            raise SystemExit(
                "--speculative requires --greedy (or --temperature 0) and --n-samples 1"
            )
    setup_logging(args)
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
    sampling = dict(temperature=temperature, top_k=args.top_k, top_p=args.top_p,
                    stop_sequences=stop_seqs)
    host_prof = args.logs_dir / "sample_profile.prof" if args.debug else None
    t0 = time.perf_counter()
    with profile(logdir=args.profile_dir, host_profile_path=host_prof):
        if args.pipeline_stages:
            from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

            gen = PipelineEngine(
                cfg, params, n_stages=args.pipeline_stages,
                max_seq_length=args.sequence_length, rng_seed=args.seed,
                quantize=args.quantize, cache_dtype=resolve_kv_dtype(args.kv_dtype),
                samples_per_slot=args.samples_per_slot, rotations_per_call=args.chunk,
                overlap_chunks=args.overlap_chunks, device=args.device,
            )
            outs, stats = gen.generate(prompt_ids, args.n_tokens, **sampling)
        else:
            gen = Generator(
                cfg, params, max_seq_length=args.sequence_length, rng_seed=args.seed,
                cache_dtype=resolve_kv_dtype(args.kv_dtype),
                device=args.device, quantize=args.quantize,
                mesh=(make_tp_mesh(args.tp_devices, args.quantize, args.device)
                      if args.tp_devices else None),
            )
            outs, stats = gen.generate(
                prompt_ids, args.n_tokens, chunk_size=args.chunk,
                speculative=args.speculative or None, **sampling,
            )
    return prompt_ids, outs, stats, gen, tokenizer, time.perf_counter() - t0


def main(argv=None):
    args = build_parser().parse_args(argv)
    prompt_ids, outs, stats, gen, tokenizer, seconds = run(args)
    n_nodes = args.pipeline_stages or args.tp_devices or 1
    report_run(args, gen.cfg, tokenizer, prompt_ids, outs, stats, seconds, n_nodes,
               f"{n_nodes} node(s)" + (f", {stats.rotations} rotations"
                                       if args.pipeline_stages else ""))
    if stats.interrupted:
        raise SystemExit(130)  # conventional SIGINT exit code
    return outs


if __name__ == "__main__":
    main()
