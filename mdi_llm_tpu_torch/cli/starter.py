"""Starter-node entry point of the port's multi-process recurrent pipeline.

Port of `mdi_llm_tpu/cli/starter.py`: reads a nodes-config topology file
(`parallel/nodes.parse_nodes_config`), brings the node group up as
process 0 of a `torch.distributed` job (`init_distributed`: NCCL when
every process has a card of its own, else gloo with the stage hop staged
through pinned host buffers), loads the model, ships the run spec to the
secondaries (`cli/secondary.py`), runs the ring (`PipelineEngine`; each
process owns a contiguous group of the S stages, by default one stage per
node) and prints the samples, the throughput line (with the backend) and
the tokens/time CSVs, plot and run-stats CSV under the JAX CLI's names.
A single-node config (`examples/node_configs/standalone.json`) runs every
stage in this one process.

The device is `--device`, else the node JSON's "device", else cuda; a
CUDA device on a machine without one raises.  A refusal on the starter
(an unported flag, a bad stage count, a failed load) reaches every
secondary as an abort through the run-spec channel, so no process waits
on a spec that never comes.  `--tp-devices N` (or the node config's
`tp_devices`) runs N tensor-parallel ranks inside each stage, all on the
process's device, and travels in the run spec as the JAX starter's `tp`
does.  Before the checkpoint loads, the plan audit (`analysis/audit.py`:
the stage split, the tp split, the ring's schedule and the paper's
n_samples >= stages invariant, with `--hbm-gb N` the per-device bytes)
checks the ring the flags describe; a refused plan reaches every
secondary as the abort, and `--no-preflight` launches it anyway with the
findings as warnings.

    python -m mdi_llm_tpu_torch.cli.starter --model tiny-llama-1.1b \
        --nodes-config examples/node_configs/standalone.json --pipeline-stages 2 \
        --samples-per-slot 2 --n-samples 4 --greedy --tp-devices 2
    # two processes (run cli/secondary.py with the same flags and index 0):
    python -m mdi_llm_tpu_torch.cli.starter --model tiny-llama-1.1b --nodes-config cfg.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mdi_llm_tpu_torch.cli._common import (
    add_common_args,
    add_log_args,
    add_preflight_args,
    add_run_args,
    audit_device_kind,
    load_model,
    report_run,
    resolve_config,
    resolve_kv_dtype,
    select_device,
    setup_logging,
)
from mdi_llm_tpu_torch.parallel.nodes import (
    NodesConfig,
    broadcast_run_spec,
    check_params_consistency,
    init_distributed,
    parse_nodes_config,
    shutdown_distributed,
)
from mdi_llm_tpu_torch.utils.prompts import get_user_prompt


def add_node_args(ap: argparse.ArgumentParser) -> None:
    """The flags the starter and the secondary share."""
    add_common_args(ap)
    ap.set_defaults(device=None)  # CLI > node JSON "device" > cuda
    add_run_args(ap)
    add_log_args(ap)
    ap.add_argument("--pipeline-stages", type=int, default=None,
                    help="stages to split over (default: the config's, else one per node)")
    ap.add_argument("--samples-per-slot", type=int, default=1,
                    help="samples batched per ring slot (M): full utilization "
                    "serves stages x M concurrent samples")
    ap.add_argument("--chunk", type=int, default=16,
                    help="steady-state ring rotations per call")
    ap.add_argument("--tp-devices", type=int, default=None,
                    help="tensor-parallel ranks per stage, on each process's device "
                    "(default: the node config's tp_devices, else 1)")
    ap.add_argument("--overlap-chunks", action="store_true",
                    help="run the next steady chunk before reading the previous one")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    add_node_args(ap)
    ap.add_argument("--nodes-config", type=Path, required=True,
                    help="topology JSON (reference settings_distr schema or mesh schema)")
    ap.add_argument("--stream", action="store_true",
                    help="print sample 0's text live as its tokens come back around "
                    "the ring (needs a --ckpt with a tokenizer)")
    add_preflight_args(ap)
    return ap


def _preflight(args, n_stages: int, tp: int, n_samples: int, log) -> None:
    """The plan audit of the ring, before the checkpoint load: findings go
    to the log and a one-line summary to stderr; an error refuses the plan
    (SystemExit with the refusal and every finding, which `_run` ships to
    the secondaries as the abort) unless --no-preflight."""
    from mdi_llm_tpu_torch.analysis.audit import enforce_preflight, preflight, refusal_text

    report = preflight(
        resolve_config(args), n_stages=n_stages, pipeline=True, tp=tp,
        samples_per_slot=args.samples_per_slot, n_samples=n_samples, batch=n_samples,
        seq_len=args.sequence_length, dtype=args.dtype, cache_dtype=args.kv_dtype,
        quantize=args.quantize, hbm_gb=args.hbm_gb, origin="cli.starter",
        device_kind=audit_device_kind(args.device),
    )
    total = report.breakdown.get("per_device", {}).get("total_bytes", 0)
    budget = f" of the {args.hbm_gb:g} GiB budget" if args.hbm_gb is not None else ""
    print(f"cli.starter: plan audit: {len(report.errors)} error(s), "
          f"{len(report.warnings)} warning(s); {total / 2**30:.2f} GiB per device{budget}",
          file=sys.stderr, flush=True)
    if not enforce_preflight(report, "cli.starter", allow=args.no_preflight,
                             emit=lambda line: log.warning("%s", line), exit_=False):
        raise SystemExit(refusal_text("cli.starter") + "\n"
                         + "\n".join(report.render_findings()))


def _starter_spec(args, nodes_cfg: NodesConfig, log):
    """Check the flags, audit the plan, load the model and build the run
    spec (process 0).  Returns (spec, cfg, params, tokenizer)."""
    # CLI beats the config file, the config the default of 1
    eff_tp = args.tp_devices if args.tp_devices is not None else nodes_cfg.tp_devices
    if eff_tp < 1:
        raise SystemExit(f"--tp-devices {eff_tp} must be a positive device count")
    n_nodes = nodes_cfg.n_nodes
    n_stages = args.pipeline_stages or nodes_cfg.pipeline_stages or n_nodes
    if n_stages % n_nodes:
        raise SystemExit(f"--pipeline-stages {n_stages} must be a multiple of the "
                         f"{n_nodes} nodes (each owns a contiguous group of stages)")
    raw_prompts = get_user_prompt(args.prompt, args.n_samples)
    _preflight(args, n_stages, eff_tp, len(raw_prompts), log)
    cfg, params, tokenizer, prompt_style = load_model(args, need_tokenizer=True)
    if tokenizer is not None:
        prompt_ids = [tokenizer.encode(prompt_style.apply(p)).tolist() for p in raw_prompts]
        stop_seqs = tuple(tuple(s) for s in prompt_style.stop_tokens(tokenizer))
    else:
        rng = np.random.default_rng(args.seed)
        prompt_ids = [rng.integers(1, cfg.vocab_size, 8).tolist() for _ in raw_prompts]
        stop_seqs = ()
    spec = dict(
        prompt_ids=prompt_ids, n_tokens=args.n_tokens,
        temperature=0.0 if args.greedy else args.temperature,
        top_k=args.top_k, top_p=args.top_p, stop_seqs=stop_seqs, seed=args.seed,
        dtype=args.dtype, quantize=args.quantize, kv_dtype=args.kv_dtype,
        seq_len=args.sequence_length, n_stages=n_stages,
        samples_per_slot=args.samples_per_slot, rotations_per_call=args.chunk,
        tp=eff_tp, overlap_chunks=args.overlap_chunks,
    )
    return spec, cfg, params, tokenizer


def run_node(args, nodes_cfg: NodesConfig, process_id: int):
    """The starter's and the secondaries' body: join the job, load the
    model, originate (or receive) the run spec and run the ring.  Returns
    (outs, stats, seconds, engine); every process returns the same outs."""
    role = "starter" if process_id == 0 else f"secondary{process_id - 1}"
    log = setup_logging(args, role=role)
    node = nodes_cfg.starter if process_id == 0 else nodes_cfg.secondary[process_id - 1]
    select_device(args, node.device)
    ring = init_distributed(nodes_cfg, process_id, device=args.device)
    if ring is not None:
        args.device = str(ring.device)
    try:
        return _run(args, nodes_cfg, process_id, ring, log)
    finally:
        shutdown_distributed()


def _run(args, nodes_cfg, process_id, ring, log):
    from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

    is_starter = process_id == 0
    tokenizer = None
    if is_starter:
        try:
            spec, cfg, params, tokenizer = _starter_spec(args, nodes_cfg, log)
        except BaseException as e:
            if ring is not None:  # the secondaries wait on the spec: end them too
                msg = str(e) if isinstance(e, SystemExit) else f"{type(e).__name__}: {e}"
                broadcast_run_spec({"abort": msg}, ring)
            raise
        spec = broadcast_run_spec(spec, ring)
    else:
        spec = broadcast_run_spec(None, ring)
        if "abort" in spec:
            log.warning("starter aborted the job: %s", spec["abort"])
            raise SystemExit(f"starter aborted the job: {spec['abort']}")
        # the starter's dtype; the weights come from this node's own --ckpt
        # or --seed, and a mismatch is refused on every process below
        args.dtype = spec["dtype"]
        cfg, params, _, _ = load_model(args, need_tokenizer=False)
    check_params_consistency(params, ring)
    engine = PipelineEngine(
        cfg, params, n_stages=spec["n_stages"], max_seq_length=spec["seq_len"],
        rng_seed=spec["seed"], quantize=spec["quantize"],
        cache_dtype=resolve_kv_dtype(spec["kv_dtype"]),
        samples_per_slot=spec["samples_per_slot"],
        rotations_per_call=spec["rotations_per_call"], tp=spec["tp"],
        overlap_chunks=spec["overlap_chunks"], device=args.device, ring=ring,
    )
    del params
    backend = ring.backend if ring is not None else "one process"
    log.info("%s: stages %s of %d on %s (%s)", "starter" if is_starter else "secondary",
             engine.owned, engine.n_stages, args.device, backend)
    stream_cb = printer = None
    if is_starter and getattr(args, "stream", False):
        if tokenizer is None:
            log.warning("--stream needs a checkpoint with a tokenizer (--ckpt); "
                        "running without live output")
        else:
            from mdi_llm_tpu_torch.generation import StreamPrinter

            printer = StreamPrinter(tokenizer, spec["stop_seqs"])

            def stream_cb(j: int, tok: int):
                if j == 0:
                    printer.push(tok)

    t0 = time.perf_counter()
    outs, stats = engine.generate(
        spec["prompt_ids"], spec["n_tokens"], temperature=spec["temperature"],
        top_k=spec["top_k"], top_p=spec["top_p"], stop_sequences=spec["stop_seqs"],
        stream_cb=stream_cb,
    )
    gen_time = time.perf_counter() - t0
    if printer is not None:
        printer.finish(outs[0][len(spec["prompt_ids"][0]):])
        print()
    ring_line = {"process": process_id, "stages": engine.owned, "n_stages": engine.n_stages,
                 "tp": engine.tp, "backend": backend, "rotations": stats.rotations,
                 **(ring.stats() if ring is not None else {}),
                 **{k: v for k, v in engine.graph_stats().items() if k != "steps"}}
    dev = engine.mesh[engine.owned[0]]
    if dev.type == "cuda":  # this process's own allocator, beside the monitor's view
        ring_line["cuda_max_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
    print("ring: " + json.dumps(ring_line), file=sys.stderr, flush=True)
    if not is_starter:
        log.info("secondary %d done (%d tokens)", process_id, stats.tokens_generated)
        return outs, stats, gen_time, engine
    args.sequence_length = spec["seq_len"]
    n_nodes = nodes_cfg.n_nodes
    report_run(args, cfg, tokenizer, spec["prompt_ids"], outs, stats, gen_time, n_nodes,
               f"{n_nodes} node(s) / {engine.n_stages} stage(s), {backend}")
    if stats.interrupted:
        raise SystemExit(130)  # conventional SIGINT exit code
    return outs, stats, gen_time, engine


def main(argv=None):
    args = build_parser().parse_args(argv)
    nodes_cfg = parse_nodes_config(args.nodes_config)
    outs, _, _, _ = run_node(args, nodes_cfg, process_id=0)
    return outs


if __name__ == "__main__":
    main()
