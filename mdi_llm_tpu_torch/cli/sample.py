"""Text generation CLI of the port: one device, a tensor-parallel mesh, or
the recurrent pipeline, in one process or over several.

Port of `mdi_llm_tpu/cli/sample.py`: `Generator.generate` over
`--n-samples` prompts (with `--tp-devices N` over N tensor-parallel
ranks, every rank on `--device`: `cli._common.make_tp_mesh`), or with
`--pipeline-stages S` the recurrent pipeline
(`parallel/pipeline.PipelineEngine`: S stages on the device,
`--samples-per-slot` samples per ring slot, `--chunk` ring rotations per
steady call, `--overlap-chunks`; with `--tp-devices N` too, N
tensor-parallel ranks inside each stage).  `--coordinator host:port
--process-id I --num-processes P` first joins a job of P processes
(`parallel/nodes.init_distributed`, as `cli/train.py` does; the JAX CLI's
`jax.distributed.initialize`): `--tp-devices N` then splits the tp ranks
over the processes (each process's share on its own device, the partial
sums meeting in `torch.distributed` collectives, every process sampling
the same tokens from the same seed), `--pipeline-stages S` splits the
stages (each process a contiguous group, with its tp ranks), the hop
between processes a send/recv.  `--sp-devices N` generates over N
sequence-parallel ranks on `--device` (`parallel/sp_inference.
SPGenerator`: ring-attention prefill, the KV cache split over the ranks;
`--sp-flash` sends the prefill ring through K2); `--ep-devices N` splits
an MoE config's experts over N ranks on `--device` (`parallel/expert.py`:
token dispatch by all_to_all, at `--moe-capacity-factor`, exact by
default).  With `--coordinator` both split their ranks over the
processes, a contiguous range each: the ring's K/V chunks, its decode
merge, the expert dispatch and return cross processes in
`torch.distributed` collectives.  As in the JAX CLI every process prints
the samples and the throughput line.  With `--ckpt DIR` the prompts
(`--prompt TEXT` or `FILE:<path>`, one per blank-line-separated
paragraph) go through the checkpoint's prompt style and tokenizer,
generation stops at the style's stop sequences, and the samples print
decoded.  With `--model NAME` (random weights from `--seed`, no
tokenizer) every prompt is 8 random token ids drawn from `--seed` and the
samples print as token ids.  `--profile-dir DIR` writes a torch.profiler
trace of the run (`utils/profiling.profile`), `--debug` a cProfile dump
into `--logs-dir`.  Runs on the GPU unless `--device cpu` is given;
without a GPU and without that flag it raises.  The JAX CLI's
exclusions between the parallelism flags hold.

    python -m mdi_llm_tpu_torch.cli.sample --ckpt checkpoints/tiny-llama --prompt "Once upon a time,"
    python -m mdi_llm_tpu_torch.cli.sample --model tiny-llama-1.1b --n-samples 4 --greedy
    python -m mdi_llm_tpu_torch.cli.sample --model tiny-llama-1.1b --n-samples 4 --pipeline-stages 2 --samples-per-slot 2 --tp-devices 2
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8 --tp-devices 2
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8 --sp-devices 2 --sp-flash
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model Mixtral-8x7B-v0.1 --override n_layer=2 \
        --override n_embd=64 --override n_head=4 --override n_query_groups=2 \
        --override intermediate_size=128 --greedy --n-tokens 8 --ep-devices 2
    # two processes, one tp rank each (start process 1 the same way):
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8 \\
        --tp-devices 2 --coordinator 127.0.0.1:29511 --num-processes 2 --process-id 0
    # the same with one sp rank (or, on an MoE config, one ep rank) each:
    python -m mdi_llm_tpu_torch.cli.sample --device cpu --model pythia-14m --greedy --n-tokens 8 \\
        --sp-devices 2 --sp-flash --coordinator 127.0.0.1:29511 --num-processes 2 --process-id 0
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
    make_ep_mesh,
    make_tp_mesh,
    report_run,
    resolve_config,
    resolve_kv_dtype,
    setup_logging,
)
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.parallel import nodes
from mdi_llm_tpu_torch.utils.prompts import get_user_prompt

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
                    help="recurrent pipeline over S stages (on the device, or split "
                    "over the processes of --coordinator)")
    ap.add_argument("--samples-per-slot", type=int, default=1,
                    help="pipeline mode: samples batched per ring slot (M)")
    ap.add_argument("--overlap-chunks", action="store_true",
                    help="pipeline mode: run the next steady chunk before reading "
                    "the previous one's tokens")
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="write a torch.profiler trace of the run here")
    ap.add_argument("--tp-devices", type=int, default=0,
                    help="tensor-parallel generation over N ranks, all on --device "
                    "(split over the processes of --coordinator); with "
                    "--pipeline-stages, N ranks inside each stage (0 = off)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's TCP store: join a job of "
                    "--num-processes processes (each given its --process-id)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--sp-devices", type=int, default=0,
                    help="sequence-parallel inference over N ranks, all on --device "
                    "(split over the processes of --coordinator): ring-attention "
                    "prefill and a sequence-split KV cache (the context grows with "
                    "N; 0 = off)")
    ap.add_argument("--sp-flash", action="store_true",
                    help="run the sp prefill ring through kernel K2 (engages when "
                    "the local chunk is >= 2048)")
    ap.add_argument("--ep-devices", type=int, default=0,
                    help="MoE configs: expert parallelism over N ranks, all on --device "
                    "(split over the processes of --coordinator; token dispatch by "
                    "all_to_all; 0 = off)")
    ap.add_argument("--moe-capacity-factor", type=float, default=None,
                    help="ep dispatch capacity factor (bounds the per-rank buffers, "
                    "Switch-style drops past capacity); default exact, no drops")
    add_log_args(ap)
    return ap


def prompt_ids_for(args, cfg, tokenizer, prompt_style):
    """(the prompts' token ids, the stop sequences): `--prompt` through the
    prompt style and the tokenizer, or without a tokenizer 8 random ids
    per sample from `--seed`."""
    raw_prompts = get_user_prompt(args.prompt, args.n_samples)
    if tokenizer is not None:
        prompt_ids = [tokenizer.encode(prompt_style.apply(p)).tolist() for p in raw_prompts]
        return prompt_ids, prompt_style.stop_tokens(tokenizer)
    rng = np.random.default_rng(args.seed)
    return [rng.integers(1, cfg.vocab_size, 8).tolist() for _ in raw_prompts], ()


def run(args):
    """Build the model the flags describe and generate; returns
    (prompt_ids, outs, stats, engine, tokenizer, seconds)."""
    if args.tp_devices and args.sp_devices:
        raise SystemExit("--tp-devices is exclusive with --sp-devices")
    if args.tp_devices < 0:
        raise SystemExit("--tp-devices must be a positive device count")
    if args.ep_devices and (args.tp_devices or args.sp_devices or args.pipeline_stages):
        raise SystemExit(
            "--ep-devices is a standalone expert-parallel mesh; drop the "
            "other parallelism flags"
        )
    job = (args.coordinator, args.process_id, args.num_processes)
    if any(v is not None for v in job) and any(v is None for v in job):
        raise SystemExit("--coordinator, --process-id and --num-processes go together")
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
    ring = None
    if args.coordinator:
        ring = nodes.init_distributed(
            nodes.coordinator_config(args.coordinator, args.num_processes),
            args.process_id, device=args.device)
        if ring is not None:
            args.device = str(ring.device)
    try:
        return _generate(args, temperature, ring)
    finally:
        if ring is not None:
            nodes.shutdown_distributed()


def _generate(args, temperature, ring):
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.utils.profiling import profile

    mesh = experts = None
    if args.ep_devices and ring is not None:
        # over processes: each draws or loads only its ranks' experts
        from mdi_llm_tpu_torch.parallel.expert import owned_experts

        cfg = resolve_config(args)
        mesh = make_ep_mesh(args.ep_devices, cfg, args.device, ring.rank, ring.world)
        experts = owned_experts(mesh, cfg.n_expert)
    cfg, params, tokenizer, prompt_style = load_model(args, experts=experts)
    if experts is not None:
        from mdi_llm_tpu_torch.parallel.expert import replicated

        # the same weights on every process, its own experts aside
        nodes.check_params_consistency(replicated(params), ring)
    else:
        nodes.check_params_consistency(params, ring)  # every process, the same weights
    prompt_ids, stop_seqs = prompt_ids_for(args, cfg, tokenizer, prompt_style)
    sampling = dict(temperature=temperature, top_k=args.top_k, top_p=args.top_p,
                    stop_sequences=stop_seqs)
    host_prof = args.logs_dir / "sample_profile.prof" if args.debug else None
    t0 = time.perf_counter()
    with profile(logdir=args.profile_dir, host_profile_path=host_prof):
        if args.sp_devices:
            if args.pipeline_stages:
                raise SystemExit("--sp-devices and --pipeline-stages are exclusive")
            if args.speculative:
                raise SystemExit("--speculative applies to single-device decode only")
            from mdi_llm_tpu_torch.parallel.mesh import make_mesh
            from mdi_llm_tpu_torch.parallel.sp_inference import SPGenerator

            gen = SPGenerator(
                cfg, params, mesh=make_mesh(
                    {"sp": args.sp_devices}, [resolve_device(args.device)],
                    0 if ring is None else ring.rank, 1 if ring is None else ring.world),
                max_seq_length=args.sequence_length, rng_seed=args.seed,
                cache_dtype=resolve_kv_dtype(args.kv_dtype), use_flash=args.sp_flash,
                quantize=args.quantize,
            )
            outs, stats = gen.generate(prompt_ids, args.n_tokens, **sampling)
        elif args.pipeline_stages:
            from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

            gen = PipelineEngine(
                cfg, params, n_stages=args.pipeline_stages,
                max_seq_length=args.sequence_length, rng_seed=args.seed,
                quantize=args.quantize, cache_dtype=resolve_kv_dtype(args.kv_dtype),
                samples_per_slot=args.samples_per_slot, rotations_per_call=args.chunk,
                tp=max(1, args.tp_devices), overlap_chunks=args.overlap_chunks,
                device=args.device, ring=ring,
            )
            outs, stats = gen.generate(prompt_ids, args.n_tokens, **sampling)
        else:
            if args.tp_devices:
                mesh = make_tp_mesh(args.tp_devices, args.quantize, args.device,
                                    0 if ring is None else ring.rank,
                                    1 if ring is None else ring.world)
            elif args.ep_devices and mesh is None:
                mesh = make_ep_mesh(args.ep_devices, cfg, args.device)
            gen = Generator(
                cfg, params, max_seq_length=args.sequence_length, rng_seed=args.seed,
                cache_dtype=resolve_kv_dtype(args.kv_dtype),
                device=args.device, quantize=args.quantize, mesh=mesh,
                moe_capacity_factor=args.moe_capacity_factor,
            )
            outs, stats = gen.generate(
                prompt_ids, args.n_tokens, chunk_size=args.chunk,
                speculative=args.speculative or None, **sampling,
            )
    return prompt_ids, outs, stats, gen, tokenizer, time.perf_counter() - t0


def main(argv=None):
    args = build_parser().parse_args(argv)
    prompt_ids, outs, stats, gen, tokenizer, seconds = run(args)
    n_nodes = (args.pipeline_stages * max(1, args.tp_devices) if args.pipeline_stages
               else args.tp_devices or args.sp_devices or args.ep_devices or 1)
    report_run(args, gen.cfg, tokenizer, prompt_ids, outs, stats, seconds, n_nodes,
               f"{n_nodes} node(s)" + (f", {stats.rotations} rotations"
                                       if args.pipeline_stages else ""))
    if stats.interrupted:
        raise SystemExit(130)  # conventional SIGINT exit code
    return outs


if __name__ == "__main__":
    main()
