"""Offline serving driver of the port: a request trace through the
paged-KV continuous-batching engine (`serving/engine.py`).

Port of `mdi_llm_tpu/cli/serve.py`: the weights of
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
misses).  `--host-pool-mib N` puts a host-RAM block tier behind the pool
(`serving/host_tier.py`): preemption victims swap to it and cold prefix
chains spill to it; the stats line's `swaps_*` and `prefix_hits_host`
count its work.  `--quantize int8|w8a8|int4` serves quantized weights
(`ops/quant.py`).  `--pp S` serves over an S-stage recurrent ring
(`serving/pipeline.py`), every stage on `--device`: the layers split
by the reference's stage table, each stage's paged attention through K1,
and the stats line gains the ring's `pipeline` block (stages, lanes,
each stage's layers, the bubble fraction).  `--tp N` serves over a
tensor-parallel mesh of N ranks, every rank on `--device`
(`cli._common.make_tp_mesh`): the weights split under the Megatron
rules, the pool's KV groups over the ranks, each rank's paged attention
through K1; the stats line's `tp` and `n_chips` (tp x pp, the JAX line's
chip count) say so.  `--tp N --pp S` composes them: the S-stage ring
with N ranks inside each stage (`parallel.mesh.pipeline_mesh(S,
[--device], tp=N)`), each stage's pool split over its ranks' KV groups,
K1 once per stage layer and rank.  Runs on the GPU unless `--device cpu` is given; without a
GPU and without that flag it raises.

Before any weight loads, the plan audit (`analysis/audit.py`,
`preflight_serving`) checks the serve the flags describe against the
architecture alone: the tp split, the pool's geometry and token budget,
K1's tuning entry and shared memory on the card and, with `--hbm-gb N`,
the per-device bytes of weights, pool and activations against N GiB.  A
plan with an error is refused there, each finding on stderr, with nothing
on the card.  Once the engine is built, the ir and flow preflights
(`analysis/ir.py`, `analysis/liveness.py`) trace its steps on its meta
twin (nothing runs on the card, no counter moves): compile-set closure,
in-place pool writes, graph hygiene, buffer liveness; an error refuses
the launch.  `--no-preflight` launches anyway with every finding as a
warning.  The stats line's `detail` carries both preflights' records and
seconds.

Observability rides every run (`obs/`, hooks at the engine's host-sync
boundaries): the stats line carries the per-request latency block
(TTFT/TPOT/E2E/queue-wait p50/p95/p99) and, unless `--no-device-obs`, a
`device` block with the achieved MFU/MBU against the card's peak (null
off the peak table, e.g. on the CPU; an MoE model's MFU counts all its
experts, as its dense formulation computes them) and each step's report
(`obs/device.py`).  `--metrics-out`/`--prom-out` write the metrics
registry (JSON / Prometheus text), `--trace-out` a Perfetto-loadable
request/step timeline, `--sample-rss` adds a host RSS gauge, and
`--xprof-steps N` writes a torch.profiler trace of N mid-run steps.

    python -m mdi_llm_tpu_torch.cli.serve --ckpt checkpoints/tiny-llama --prompt-file prompts.txt
    python -m mdi_llm_tpu_torch.cli.serve --model tiny-llama-1.1b --synthetic 16
    python -m mdi_llm_tpu_torch.cli.serve --model tiny-llama-1.1b --synthetic 16 --hbm-gb 80
    python -m mdi_llm_tpu_torch.cli.serve --device cpu --model pythia-14m \\
        --synthetic 3 --max-batch 2 --n-tokens 8 --sequence-length 128 --block-size 8 \\
        --metrics-out logs/metrics.json --trace-out logs/trace.json
    python -m mdi_llm_tpu_torch.cli.serve --device cpu --model pythia-14m \\
        --synthetic 6 --max-batch 4 --n-tokens 48 --sequence-length 128 --block-size 8 \\
        --max-blocks 24 --host-pool-mib 16
    python -m mdi_llm_tpu_torch.cli.serve --device cpu --model pythia-14m \\
        --synthetic 3 --max-batch 2 --n-tokens 8 --sequence-length 128 --block-size 8 --pp 2
    python -m mdi_llm_tpu_torch.cli.serve --device cpu --model pythia-14m \\
        --synthetic 3 --max-batch 2 --n-tokens 8 --sequence-length 128 --block-size 8 --tp 2
    python -m mdi_llm_tpu_torch.cli.serve --device cpu --model pythia-14m \\
        --synthetic 3 --max-batch 2 --n-tokens 8 --sequence-length 128 --block-size 8 --tp 2 --pp 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from mdi_llm_tpu_torch.cli._common import (
    DTYPES,
    add_common_args,
    add_preflight_args,
    audit_device_kind,
    load_model,
    make_tp_mesh,
    resolve_config,
    resolve_kv_dtype,
)
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.models import transformer


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
    ap.add_argument("--scan-unroll", type=int, default=1,
                    help="the JAX CLI's layer-scan unroll factor; the port runs "
                    "the layers as a Python loop, so the Generator takes 1 only")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable hash-based prefix block reuse")
    ap.add_argument("--host-pool-mib", type=int, default=0,
                    help="host-RAM KV block tier in MiB (0 = off): "
                    "preemption victims swap their int8/fp blocks to "
                    "pinned host slabs and resume without re-prefill "
                    "(when the swap cost model beats recompute), and "
                    "cold prefix chains spill there instead of being "
                    "dropped")
    ap.add_argument("--host-link-gbps", type=float, default=None,
                    help="host<->device link bandwidth (GB/s) for the "
                    "swap-vs-recompute cost model (default: the "
                    "per-device table in serving/host_tier.py)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="engine-wide sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel serving: split the layers over "
                    "this many recurrent ring stages (the reference's stage "
                    "table), all on --device, each holding its own shard of "
                    "the paged KV pool; decode lanes fill the ring, so keep "
                    "--max-batch >= --pp.  1 = no pipelining")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel serving over this many ranks, all "
                    "on --device: the weights split under the Megatron "
                    "rules, the paged pool's KV groups over the ranks, one "
                    "all-reduce per row-parallel product.  1 = no split")
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "priority", "fair", "deadline"),
                    help="scheduling policy (serving/policy.py)")
    add_preflight_args(ap)
    # observability: recorded at the engine's host-sync boundaries only
    ap.add_argument("--metrics-out", type=Path, default=None, metavar="JSON",
                    help="write serving metrics JSON: per-request "
                    "TTFT/TPOT/E2E/queue-wait p50/p95/p99, the counter/"
                    "gauge/histogram registry, the serving stats and the "
                    "step reports")
    ap.add_argument("--prom-out", type=Path, default=None, metavar="TXT",
                    help="also write the metrics registry in Prometheus "
                    "text exposition format")
    ap.add_argument("--trace-out", type=Path, default=None, metavar="JSON",
                    help="write a Chrome-trace-event timeline of the run "
                    "(request lifecycles + engine steps), for Perfetto")
    ap.add_argument("--trace-ring", type=int, default=65536,
                    help="bounded ring capacity for trace events and the "
                    "completed-request percentile window")
    ap.add_argument("--sample-rss", type=float, default=None, nargs="?",
                    const=0.5, metavar="SECONDS",
                    help="sample the host process tree's RSS into a "
                    "host_rss_bytes gauge at most once per this many "
                    "seconds (default 0.5 when given bare), at host-sync "
                    "boundaries only (needs psutil)")
    ap.add_argument("--no-device-obs", action="store_true",
                    help="skip the step reports (counted FLOPs and bytes "
                    "per captured step) and the MFU/MBU block of the stats "
                    "line")
    ap.add_argument("--xprof-steps", type=int, default=None, metavar="N",
                    help="wrap N mid-run engine steps (after --xprof-skip) "
                    "in a torch.profiler trace written as a Chrome trace "
                    "(utils/profiling.StepWindowProfiler)")
    ap.add_argument("--xprof-dir", type=Path, default=Path("logs/xprof"),
                    metavar="DIR", help="where --xprof-steps writes the trace")
    ap.add_argument("--xprof-skip", type=int, default=8,
                    help="engine steps to let pass before the --xprof-steps "
                    "window opens")
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
        # mdi-lint: disable-next-line=host-sync -- a numpy draw of the synthetic trace: host data, no device read
        prompt = rng.integers(1, vocab, plen).tolist()
        reqs.append((f"syn{i}", prompt, new))
    return reqs


def make_serving_config(args, admission_queue=None):
    """The ServingConfig the flags describe (shared with `cli.server`):
    --kv-dtype int8 selects the quantized pool; the float names reach the
    pool through the Generator's cache dtype (`build_generator`)."""
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
        admission_queue=admission_queue,
        host_pool_mib=args.host_pool_mib,
        host_link_gbps=args.host_link_gbps,
        # spill needs the prefix hash chains: without the prefix cache the
        # tier serves preemption swaps only
        host_prefix_spill=not args.no_prefix_cache,
    )


def preflight_serving(args, serving_cfg, origin):
    """The plan audit of the serve the flags describe, with the pool's size
    on stderr (shared with `cli.server`).  It runs BEFORE the checkpoint
    load, on the architecture alone: a refused plan exits here, naming
    each finding, with no weight on the card; `--no-preflight` turns the
    refusal into warnings.  Returns the `AuditReport`."""
    from mdi_llm_tpu_torch.analysis.audit import enforce_preflight, preflight

    report = preflight(
        resolve_config(args),
        tp=args.tp,
        pp=args.pp,
        batch=args.max_batch,
        seq_len=args.sequence_length,
        dtype=args.dtype,
        cache_dtype=args.kv_dtype,
        quantize=args.quantize,
        serving=serving_cfg,
        hbm_gb=args.hbm_gb,
        origin=origin,
        device_kind=audit_device_kind(args.device),
    )
    enforce_preflight(report, origin, allow=args.no_preflight)
    pool = report.breakdown.get("kv_pool", {})
    if pool:
        axes = " x ".join(f"{ax}={pool[ax]}" for ax in ("tp", "pp") if pool.get(ax, 1) > 1)
        per_dev = (f" ({pool['pool_bytes_per_device'] / 2**20:.1f} MiB/device over "
                   f"{axes})" if axes else "")
        q_tag = (f" [int8 + {pool['scale_bytes'] / 2**20:.2f} MiB scales]"
                 if pool.get("kv_dtype") == "int8" else "")
        print(f"{origin}: KV pool {pool['num_blocks']} blocks x {pool['block_size']} "
              f"tokens ~= {pool['pool_bytes'] / 2**20:.1f} MiB{q_tag}{per_dev}",
              file=sys.stderr)
    return report


def build_generator(args, cfg, params, _graphs=None):
    """The Generator the flags describe; with `--pp S > 1` on a pipeline
    mesh of S stages (of `--tp` ranks each), with `--tp N > 1` alone on a
    tp mesh of N ranks, all on `--device`."""
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.parallel.mesh import pipeline_mesh

    dtype = DTYPES[args.dtype]
    mesh = None
    if args.pp > 1:
        mesh = pipeline_mesh(args.pp, [args.device], tp=args.tp)
    elif args.tp > 1:
        mesh = make_tp_mesh(args.tp, args.quantize, args.device)
    return Generator(
        cfg, params,
        mesh=mesh,
        max_seq_length=args.sequence_length,
        cache_dtype=(
            dtype if args.kv_dtype == "int8"
            else resolve_kv_dtype(args.kv_dtype) or dtype
        ),
        rng_seed=args.seed,
        device=args.device,
        quantize=args.quantize,
        scan_unroll=args.scan_unroll,
        _graphs=_graphs,
    )


def make_observer(args):
    """The observer every run carries (the JAX CLI always builds one)."""
    from mdi_llm_tpu_torch.obs import ServingObserver

    return ServingObserver(ring=args.trace_ring, rss_interval_s=args.sample_rss,
                           device=not args.no_device_obs)


def build_engine(args, need_tokenizer, _graphs=None, admission_queue=None,
                 origin="cli.serve"):
    """The model and an empty engine the flags describe, with its observer
    (`engine.obs`) and the plan audit's report (`engine.audit`, made
    before the weights load: `preflight_serving`); returns (engine,
    tokenizer).  On the card the engine's steps are CUDA graphs captured
    here; `_graphs=False` (comparisons only) launches them eagerly.  With a
    host tier, a line on stderr says its size (`origin` names the CLI)."""
    from mdi_llm_tpu_torch.serving.policy import make_policy

    if args.tp < 1:
        raise SystemExit("--tp must be a positive rank count")
    resolve_device(args.device)  # raises before any work without the device
    serving_cfg = make_serving_config(args, admission_queue=admission_queue)
    report = preflight_serving(args, serving_cfg, origin)
    cfg, params, tokenizer, _style = load_model(args, need_tokenizer=need_tokenizer)
    gen = build_generator(args, cfg, params, _graphs=_graphs)
    engine = gen.serve(serving=serving_cfg, obs=make_observer(args),
                       policy=make_policy(args.policy))
    engine.audit = report
    if engine.host_tier is not None:
        store = engine.host_tier.store
        print(f"{origin}: host KV tier {store.num_slots} blocks ~= "
              f"{store.nbytes / 2**20:.1f} MiB "
              f"{'pinned ' if store.pin_memory else ''}host RAM", file=sys.stderr)
    return engine, tokenizer


# engine signature -> the preflights' detail: a process that builds the
# same engine again (the same model, mesh, ServingConfig and weight
# layout) traces its steps once
_PREFLIGHTED: Dict[Any, Dict[str, Any]] = {}


def _engine_signature(engine) -> tuple:
    from mdi_llm_tpu_torch.analysis.trace import leaves_of

    gen = engine.gen

    def layout(tree):
        return tuple((tuple(t.shape), t.dtype) for t in leaves_of(tree))

    draft = engine.draft_gen
    return (type(engine).__qualname__, repr(gen.cfg), repr(engine.cfg), gen.max_seq_length,
            layout(engine._step_params(gen)), layout(engine._kv), gen.use_flash,
            gen.flash_min_len, gen.flash_kernel, device_kind(engine.device),
            None if draft is None else (repr(draft.cfg), layout(engine._step_params(draft))))


def preflight_steps(args, engine, origin="cli.serve") -> Dict[str, Any]:
    """The ir and flow preflights over the engine just built (the JAX
    serve's): its steps traced once on its meta twin, K1's split planned
    for its card; each finding on stderr; an error refuses the launch
    unless `--no-preflight`.  Returns {"ir": ..., "liveness": ...}, each
    the report's compact record with its seconds (the trace counts in
    ir's)."""
    from mdi_llm_tpu_torch.analysis import ir, liveness

    key = _engine_signature(engine)
    if key in _PREFLIGHTED:
        return _PREFLIGHTED[key]
    t0 = time.perf_counter()
    traces = ir.trace_engine(engine)
    ir_report = ir.ir_preflight(engine, origin=origin, traces=traces)
    t1 = time.perf_counter()
    ir.enforce_ir_preflight(ir_report, origin, allow=args.no_preflight)
    flow_report = liveness.flow_preflight(engine, origin=origin, traces=traces)
    t2 = time.perf_counter()
    liveness.enforce_flow_preflight(flow_report, origin, allow=args.no_preflight)
    detail = {"ir": {**ir.ir_detail(ir_report), "seconds": round(t1 - t0, 3)},
              "liveness": {**liveness.flow_detail(flow_report), "seconds": round(t2 - t1, 3)}}
    _PREFLIGHTED[key] = detail
    return detail


def build(args, _graphs=None):
    """Build the model and engine the flags describe, run the ir and flow
    preflights on it (`engine.preflight`) and queue the trace; returns
    (trace, engine, tokenizer)."""
    engine, tokenizer = build_engine(args, not args.synthetic, _graphs=_graphs)
    engine.preflight = preflight_steps(args, engine)
    cfg, gen = engine.gen.cfg, engine.gen
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
    """`build`, then run the trace (with the `--xprof-steps` window);
    returns (trace, results, stats, engine, tokenizer)."""
    trace, engine, tokenizer = build(args, _graphs=_graphs)
    xprof = None
    if args.xprof_steps:
        from mdi_llm_tpu_torch.utils.profiling import StepWindowProfiler

        xprof = StepWindowProfiler(args.xprof_dir, args.xprof_steps, skip=args.xprof_skip)
    try:
        results, stats = engine.run(step_hook=xprof.on_step if xprof is not None else None)
    finally:
        if xprof is not None:
            xprof.close()  # short runs / exceptions: never leak a window
    if xprof is not None and xprof.window is not None:
        print(f"cli.serve: profiler window steps {xprof.window[0]}-{xprof.window[1]} "
              f"-> {xprof.path} (open in Perfetto)", file=sys.stderr)
    return trace, results, stats, engine, tokenizer


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def roofline_block(engine, stats, contexts) -> dict:
    """The stats line's `device` block: achieved MFU/MBU of the run against
    the card's peak (`obs/roofline.py`; null off the peak table) at the
    mean context of `contexts`, and with an observer the engine's step
    reports."""
    from mdi_llm_tpu_torch.obs import roofline as rf

    gen, kind = engine.gen, device_kind(engine.device)
    ctx_mean = int(sum(contexts) / max(1, len(contexts)))
    B = engine.scheduler.max_batch
    eff_batch = (max(1, round(stats.mixed_batch_occupancy * B))
                 if stats.mixed_batch_occupancy else B)
    roof = rf.serving_roofline(
        gen.cfg, engine.cfg, tokens_per_s=stats.tokens_per_s, context=ctx_mean,
        batch=eff_batch, weight_bytes=rf.param_bytes(gen.params), device_kind=kind,
        dtype=str(transformer.param_dtype(gen.params)).replace("torch.", ""),
    )
    block = {
        "device_kind": rf.normalize_device_kind(kind),
        "mfu": None if roof["mfu"] is None else round(roof["mfu"], 6),
        "mbu": None if roof["mbu"] is None else round(roof["mbu"], 6),
        "achieved_tflops_per_s": round(roof["achieved_tflops_per_s"], 4),
        "achieved_hbm_gbps": round(roof["achieved_hbm_gbps"], 4),
        "context_mean": ctx_mean,
    }
    obs = engine.obs
    if obs is not None:
        block["executables"] = len(obs.device)
        block["reports"] = {
            name: {k: r[k] for k in ("flops", "argument_bytes", "output_bytes",
                                     "temp_bytes", "alias_bytes", "error")}
            for name, r in obs.device.to_dict().items()}
    return block


def stats_line(stats, engine, contexts=()) -> dict:
    """The JSON stats line: the engine's stats, the JAX CLI's topology
    keys (`tp`, `pp`, `n_chips` = tp x pp, the JAX line's chip count;
    `devices`, the distinct devices the engine runs on; with `--pp` > 1
    the `pipeline` block too), the latency block,
    and the port's own keys (forward counts and the step graphs, captured
    when the engine was built, outside wall_s); `device` names the card
    and, with the observer's device capture on, carries `roofline_block`
    over the requests' `contexts` (prompt + half the generation each)."""
    line = stats.to_dict()
    graphs = engine.graph_stats()
    dev = engine.device
    pp = getattr(engine, "n_stages", 1)
    tp = engine.gen.tp
    n_dev = engine.devices
    line.update({
        "kv_dtype": engine.kv_dtype_name,
        "tp": tp,
        "pp": pp,
        "n_chips": tp * pp,
        "devices": n_dev,
        "tokens_per_s_per_chip": round(stats.tokens_per_s / n_dev, 2),
        "forward_calls": engine.forward_calls,
        "draft_forward_calls": engine.draft_forward_calls,
        "graph_captures": graphs["captures"],
        "graph_replays": graphs["replays"],
        "capture_s": round(graphs["capture_s"], 3),
        "device": {"type": dev.type, "kind": device_kind(dev)},
    })
    if pp > 1:
        line["pipeline"] = engine.pipeline_fill()
    if getattr(engine, "preflight", None):
        line["detail"] = engine.preflight
    obs = engine.obs
    if obs is not None:
        line["latency"] = {
            name: {k: (round(v, 6) if isinstance(v, float) else v) for k, v in summ.items()}
            for name, summ in obs.latency_summaries().items()}
        if obs.device.capture_enabled:
            line["device"].update(roofline_block(engine, stats, contexts))
    return line


def write_outputs(args, obs, stats, origin="cli.serve") -> None:
    """--metrics-out, --prom-out and --trace-out."""
    if args.metrics_out:
        args.metrics_out.parent.mkdir(parents=True, exist_ok=True)
        args.metrics_out.write_text(json.dumps(obs.metrics_dict(stats), indent=2) + "\n")
        print(f"{origin}: metrics -> {args.metrics_out}", file=sys.stderr)
    if args.prom_out:
        args.prom_out.parent.mkdir(parents=True, exist_ok=True)
        args.prom_out.write_text(obs.metrics.render_prometheus())
        print(f"{origin}: prometheus -> {args.prom_out}", file=sys.stderr)
    if args.trace_out:
        obs.tracer.write_chrome_trace(args.trace_out)
        print(f"{origin}: trace -> {args.trace_out} (open in https://ui.perfetto.dev)",
              file=sys.stderr)


def main(argv=None):
    args = build_parser().parse_args(argv)
    trace, results, stats, engine, tokenizer = serve(args)
    for rid, prompt, _new in trace:
        out = results.get(rid, [])
        gen_tokens = out[len(prompt):]
        print(f"--- {rid} ({len(gen_tokens)} new tokens) " + "-" * 30)
        print(tokenizer.decode(np.asarray(out)) if tokenizer is not None else gen_tokens)
    contexts = [len(p) + max(0, len(results.get(rid, [])) - len(p)) / 2
                for rid, p, _new in trace]
    line = stats_line(stats, engine, contexts)
    print(json.dumps(line), file=sys.stderr)
    write_outputs(args, engine.obs, stats)
    return line


if __name__ == "__main__":
    main()
