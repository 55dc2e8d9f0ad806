"""Open-system HTTP serving daemon over the paged-KV engine.

Port of `mdi_llm_tpu/cli/server.py`.  Where `cli.serve` replays a fixed
trace and exits, `cli.server` stands up the live system: the
continuous-batching engine runs in a dedicated thread behind a bounded
admission queue (`server/frontend.py`), and an asyncio HTTP front door
(`server/http.py`) streams tokens to clients over SSE —

    POST /v1/completions   JSON in; SSE token stream or JSON out
    GET  /healthz          liveness + queue/lane depths
    GET  /v1/stats         canonical ServingStats + latency percentiles
    GET  /metrics          Prometheus text exposition

Backpressure is explicit: arrivals past ``--admission-queue`` get 429 +
Retry-After, and SIGINT/SIGTERM trigger a graceful drain — stop
accepting, finish in-flight streams, stop the engine — bounded by
``--drain-timeout``; the stats line (the `cli.serve` one, with the
latency block) then goes to stderr.  It runs on the GPU unless
`--device cpu` is given; the engine's steps are captured as CUDA graphs
before the listener opens, and the engine thread only replays them.
It takes `cli.serve`'s flags (the host tier's, `--quantize` and `--tp`
among them: `--tp N` serves over N tensor-parallel ranks on `--device`),
and runs `cli.serve`'s plan audit before the weights load (`--hbm-gb`,
`--no-preflight`; the admission queue is audited against the pool);
`--pp` is refused: the JAX package's server has no pipeline-parallel
engine either.

    python -m mdi_llm_tpu_torch.cli.server --model tiny-llama-1.1b --port 8080
    python -m mdi_llm_tpu_torch.cli.server --ckpt checkpoints/tiny-llama --policy deadline
    curl -N localhost:8080/v1/completions -d \\
        '{"prompt": "Once upon a time,", "max_tokens": 64, "stream": true}'
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys

from mdi_llm_tpu_torch.cli import serve as serve_cli
from mdi_llm_tpu_torch.cli._common import refuse


def build_parser():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
        parents=[serve_cli.build_parser()], conflict_handler="resolve", add_help=True,
    )
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 exposes the server beyond "
                    "localhost — it speaks plaintext HTTP with no auth, so "
                    "front it with something that terminates TLS first)")
    ap.add_argument("--port", type=int, default=8000,
                    help="TCP port (0 = ephemeral, printed at startup)")
    ap.add_argument("--admission-queue", type=int, default=None,
                    help="bound on accepted-but-not-yet-scheduled requests; "
                    "arrivals past it get HTTP 429 + Retry-After (default "
                    "4 x max-batch)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="graceful-shutdown bound (s): on SIGINT/SIGTERM "
                    "stop accepting (503), wait this long for in-flight "
                    "requests to finish, then stop the engine thread")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.pp != 1:
        refuse("cli.server --pp")
    from mdi_llm_tpu_torch.server import ServingFrontend
    from mdi_llm_tpu_torch.server.http import ServingHTTPServer

    # token-id requests always work; text prompts need the checkpoint's
    # tokenizer (the HTTP layer answers 400 without one)
    engine, tokenizer = serve_cli.build_engine(
        args, need_tokenizer=False, admission_queue=args.admission_queue,
        origin="cli.server")
    obs = engine.obs
    frontend = ServingFrontend(engine, max_queue=args.admission_queue)
    server = ServingHTTPServer(
        frontend, host=args.host, port=args.port, tokenizer=tokenizer,
        drain_timeout_s=args.drain_timeout,
    )

    async def run():
        await server.start()
        print(
            f"cli.server: serving {engine.gen.cfg.name} on "
            f"http://{args.host}:{server.port} (policy={args.policy}, "
            f"slots={args.max_batch}, admission queue {frontend.max_queue}; "
            "POST /v1/completions, GET /healthz)",
            file=sys.stderr, flush=True,
        )
        loop = asyncio.get_running_loop()
        drain = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, drain.set)
        await drain.wait()
        print("cli.server: draining (new requests get 503) ...", file=sys.stderr, flush=True)
        await server.shutdown()
        contexts = [t.n_prompt + t.n_tokens / 2 for t in obs.tracer.completed]
        line = serve_cli.stats_line(engine.stats, engine, contexts)
        print(json.dumps(line), file=sys.stderr, flush=True)
        serve_cli.write_outputs(args, obs, engine.stats, origin="cli.server")

    asyncio.run(run())


if __name__ == "__main__":
    main()
