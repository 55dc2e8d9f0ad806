"""Where a serve run's time goes on the GPU, with the engine's steps as
CUDA graphs and as eager launches, in one call.

For each route (the graphs the port runs, then eager launches of the same
step bodies, for comparison), builds the serve CLI's model and engine
(same flags as `cli/serve.py`; on the graph route the steps are captured
here, outside the window), runs the trace once to warm up, builds again
and profiles `engine.run()` alone under `torch.profiler`, and prints one
JSON line: the run's wall time, the device time summed over all kernels
(the profiler sees each kernel of a replayed graph), the device's idle
share of the wall time, and the kernels that took the most device time.
The profiler's own cost is inside the profiled wall time, so the idle
share is an upper bound.

    python -m mdi_llm_tpu_torch.cli.profile_serve --model tiny-llama-1.1b \\
        --synthetic 16 --n-tokens 64 --sequence-length 2048 [--kv-dtype int8]
        [--spec-k 4 --draft-model NanoLlama]
"""

from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mdi_llm_tpu_torch.cli import serve as cli


def device_summary(prof, wall_s: float, top: int) -> dict:
    """Device time summed over all kernels of a profiled window, its idle
    share of `wall_s`, and the `top` kernels by device time."""
    # device-side events only: the CPU ops that launched them carry the
    # same time again
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_s": round(wall_s, 4),
        "device_s": round(device_us / 1e6, 4),
        "device_idle_share": round(1 - device_us / 1e6 / wall_s, 4),
        "top_kernels": [
            {"name": e.key[:80], "calls": e.count,
             "device_ms": round(e.device_time_total / 1e3, 3)}
            for e in kernels[:top]
        ],
    }


def main(argv=None, top: int = 12) -> list:
    args = cli.build_parser().parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise SystemExit("profile_serve measures the GPU: run it with a CUDA device")
    lines = []
    for route, graphs in (("graphs", True), ("eager", False)):
        # warm-up: CUDA context, cuBLAS handles, kernel build
        cli.serve(args, _graphs=graphs)
        # mdi-lint: disable-next-line=host-sync -- profiler harness: drain the warm-up before the window
        torch.cuda.synchronize()
        _trace, engine, _tokenizer = cli.build(args, _graphs=graphs)
        # mdi-lint: disable-next-line=host-sync -- profiler harness: drain the build before the window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _results, stats = engine.run()
            # mdi-lint: disable-next-line=host-sync -- profiler harness: the window ends at a sync
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        line = {"route": route, **device_summary(prof, wall_s, top)}
        graph_stats = engine.graph_stats()
        line.update(engine_wall_s=round(stats.wall_s, 4),
                    tokens_generated=stats.tokens_generated,
                    tokens_per_s=round(stats.tokens_per_s, 2),
                    host_syncs=stats.host_syncs,
                    forward_calls=engine.forward_calls,
                    draft_forward_calls=engine.draft_forward_calls,
                    graph_captures=graph_stats["captures"],
                    graph_replays=graph_stats["replays"],
                    capture_s=round(graph_stats["capture_s"], 4),
                    kv_dtype=engine.kv_dtype_name)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del engine
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
