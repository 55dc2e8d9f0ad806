"""Staged triage of the port's CUDA bring-up that a wedged driver cannot hang.

Port of `mdi_llm_tpu/cli/doctor.py`.  Bring-up is split into ordered
stages — import torch -> the card -> one bf16 product -> the port's
kernels built and launched -> a CUDA-graph round trip -> a profiler trace
-> one NCCL all-reduce (with more than one card) -> the server's thread
contract — and EACH stage runs in a fresh interpreter under its own hard
timeout, so a wedge or a crash localizes to a stage and the tool itself
always returns.  The stages (the JAX ones, for the card):

- ``import_torch`` — torch, its CUDA and `nvcc`'s versions;
- ``devices`` — the card's name, its power limit as `nvidia-smi
  --query-gpu=name,power.limit` gives it, its compute capability (fails
  unless sm_90: the kernels are built for `sm_90a`), total memory and
  opt-in shared memory per block; without a card it fails (it is not
  skipped) unless `--device cpu` asked for the CPU;
- ``matmul`` — one bf16 product of small integers, checked exactly
  against a float64 product on the CPU;
- ``kernels`` — builds every CUDA source through `kernels.build` into
  `build/torch_kernels/`, launches K1 (ragged paged attention) and K2
  (flash attention) once each at a small shape and holds each against
  its plain version; a failed build or launch fails the stage;
- ``graph`` — a CUDA-graph capture and replay through the engine's own
  `utils.step_graph.CudaGraph` (the JAX stage checked buffer donation,
  that engine's idiom);
- ``profiler_trace`` — a `torch.profiler` Chrome trace written;
- ``collective`` — one NCCL all-reduce over every card (skipped on one);
- ``threads`` — the seeded schedule-explorer burst on a tiny CPU engine
  (`server.explorer.doctor_burst`).

The output is one JSON snapshot: `provenance()` (versions read through
importlib.metadata, host, the CUDA/NCCL/torch environment; no import of
torch, so a broken install cannot take the doctor down) and each stage's
status, seconds, error and detail.

Exit status: 0 when every stage is ok or skipped, 1 otherwise.

    python -m mdi_llm_tpu_torch.cli.doctor                 # full triage
    python -m mdi_llm_tpu_torch.cli.doctor --quick         # import/devices/matmul
    python -m mdi_llm_tpu_torch.cli.doctor --json out.json # also a pretty file
    python -m mdi_llm_tpu_torch.cli.doctor --device cpu    # the stages on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import re
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

SCHEMA_VERSION = 1
ROOT = Path(__file__).resolve().parents[2]  # the checkout holding the package
DEVICE_ENV = "MDI_DOCTOR_DEVICE"  # the stages' device: "cuda" or "cpu"

# environment keys that decide how the card comes up, captured verbatim
# (truncated, never redacted: platform knobs, not secrets)
_ENV_PREFIXES = ("CUDA_", "NVIDIA_", "NCCL_", "TORCH_", "PYTORCH_", "MDI_")
_ENV_VALUE_CAP = 200
# K1 and K2 against their plain versions in bfloat16 (chip_smoke.py's TOL)
KERNEL_TOL = 1.5e-2


def _stage(name: str, help_: str, timeout: float, quick: bool) -> Dict[str, Any]:
    """A stage whose body is `_STAGE_FUNCS[name]`, run in a fresh
    interpreter that prints its detail as one JSON line."""
    return {
        "name": name, "help": help_, "timeout": timeout, "quick": quick,
        "code": f"from mdi_llm_tpu_torch.cli.doctor import run_in_child; run_in_child({name!r})",
    }


STAGES: List[Dict[str, Any]] = [
    _stage("import_torch", "import torch; torch, CUDA and nvcc versions", 120.0, True),
    _stage("devices", "the card: name, power limit, sm_90, memory, shared memory", 120.0, True),
    _stage("matmul", "one bf16 product checked against float64", 120.0, True),
    _stage("kernels", "build the CUDA sources; K1 and K2 once each against their "
           "plain versions", 600.0, False),
    _stage("graph", "CUDA-graph capture and replay (the engine's idiom)", 120.0, False),
    _stage("profiler_trace", "write a torch.profiler Chrome trace", 120.0, False),
    _stage("collective", "one NCCL all-reduce over every card (skipped on 1)", 180.0, False),
    _stage("threads", "seeded schedule-explorer burst on a tiny CPU serving engine "
           "(host concurrency-contract triage)", 300.0, False),
]


# ---------------------------------------------------------------------------
# the stage bodies (run in the child interpreter)
# ---------------------------------------------------------------------------


def _nvcc_version() -> Optional[str]:
    from mdi_llm_tpu_torch import kernels

    try:
        out = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    m = re.search(r"release (\d+\.\d+)", out)
    return m.group(1) if m else None


def _import_torch(device: str) -> Dict[str, Any]:
    t0 = time.perf_counter()
    import torch

    import_s = time.perf_counter() - t0
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": _nvcc_version(), "import_s": round(import_s, 3)}


def _devices(device: str) -> Dict[str, Any]:
    import torch

    from mdi_llm_tpu_torch.ops.tuning import power_limit

    if device == "cpu":
        return {"platform": "cpu", "device_kind": "cpu", "device_count": 1}
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no CUDA card "
                           "(--device cpu triages the CPU)")
    props = torch.cuda.get_device_properties(0)
    cap = f"{props.major}.{props.minor}"
    if (props.major, props.minor) != (9, 0):
        raise RuntimeError(f"{props.name}: compute capability {cap}, but the port's "
                           "kernels are built for sm_90a (Hopper)")
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "power": power_limit(),
        "capability": cap,
        "total_memory_bytes": int(props.total_memory),
        "smem_per_block_optin": int(props.shared_memory_per_block_optin),
    }


def _matmul(device: str) -> Dict[str, Any]:
    import torch

    g = torch.Generator().manual_seed(0)
    a, b = (torch.randint(-1, 2, (256, 256), generator=g) for _ in range(2))
    dev = "cpu" if device == "cpu" else "cuda"
    t0 = time.perf_counter()
    y = a.to(dev, torch.bfloat16) @ b.to(dev, torch.bfloat16)
    y = y.double().cpu()  # waits for the product
    seconds = time.perf_counter() - t0
    # sums of 256 products in {-1, 0, 1}: exact in bfloat16 and float64
    err = float((y - a.double() @ b.double()).abs().max())
    if err != 0.0:
        raise RuntimeError(f"bf16 product off the float64 one by {err}")
    return {"matmul_s": round(seconds, 3), "max_abs_err": err, "correct": True}


def _kernels(device: str) -> Dict[str, Any]:
    import torch

    from mdi_llm_tpu_torch import kernels
    from mdi_llm_tpu_torch.ops import flash
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    if device == "cpu":
        return {"skipped": "--device cpu: the CUDA kernels run on the card only"}
    build_s = kernels.build()
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    # K1: two slots over a shuffled 16-token-block pool, a decode lane at
    # depth 20 and a 3-token span at depth 40 (4 heads over 2 groups)
    H, G, hs, BS, MB = 4, 2, 64, 16, 4
    q, kp, vp = randn(1, H, 4, hs), randn(9, BS, G, hs), randn(9, BS, G, hs)
    tables = ints([[3, 7, 1, 5], [2, 8, 6, 4]])
    args = (q, kp, vp, tables, ints([0, 1]), ints([1, 3]), ints([20, 40]),
            ints([19, 37, 38, 39]))
    out = rpa.ragged_paged_attention(*args, scale=hs ** -0.5)
    ref_args = [a.float() if a.is_floating_point() else a for a in args]
    ref = rpa.ragged_paged_attention_plain(*ref_args, scale=hs ** -0.5)
    k1_err = float((out.float() - ref).abs().max())
    # K2: causal B=1 T=100 (not a whole tile) with the same GQA grouping
    q2, k2, v2 = randn(1, H, 100, hs), randn(1, G, 100, hs), randn(1, G, 100, hs)
    out2 = flash.flash_attention(q2, k2, v2, use_kernel=True)
    ref2 = flash.flash_attention_plain(q2.float(), k2.float(), v2.float())[0]
    k2_err = float((out2.float() - ref2).abs().max())
    if not (k1_err <= KERNEL_TOL and k2_err <= KERNEL_TOL):
        raise RuntimeError(f"K1 max|err| {k1_err}, K2 max|err| {k2_err} against their "
                           f"plain versions (tolerance {KERNEL_TOL})")
    return {"build_s": {k: round(v, 1) for k, v in build_s.items()},
            "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err, "tolerance": KERNEL_TOL}


def _graph(device: str) -> Dict[str, Any]:
    import torch

    from mdi_llm_tpu_torch.utils.step_graph import CudaGraph

    if device == "cpu":
        return {"skipped": "--device cpu: CUDA graphs run on the card only"}
    x = torch.zeros(256, device="cuda")
    graph = CudaGraph()
    graph.warm_up(lambda: x * 2 + 1)
    t0 = time.perf_counter()
    y = graph.capture(lambda: x * 2 + 1)
    capture_s = time.perf_counter() - t0
    x.fill_(3.0)
    graph.replay()
    got = float(y.max().cpu())  # waits for the replay
    if got != 7.0:
        raise RuntimeError(f"replay read {got}, want 7.0: the graph did not see the "
                           "new input")
    return {"capture_s": round(capture_s, 4), "replayed": True}


def _profiler_trace(device: str) -> Dict[str, Any]:
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device != "cpu"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    dev = "cuda" if cuda else "cpu"
    a = torch.ones(64, 64, device=dev)
    with profile(activities=acts) as prof:
        (a @ a).sum().cpu()
    with tempfile.TemporaryDirectory(prefix="mdi_doctor_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        nbytes = path.stat().st_size
        events = json.loads(path.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not events or (cuda and not kernels):
        raise RuntimeError(f"the trace holds {len(events)} events, {len(kernels)} device "
                           "kernels")
    return {"n_events": len(events), "device_kernels": len(kernels), "trace_bytes": nbytes}


def _allreduce_worker(rank: int, n: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        x = torch.ones(1024, device="cuda")
        dist.all_reduce(x)
        got = float(x.min().cpu())
        if got != n:
            raise RuntimeError(f"rank {rank}: all-reduce gave {got}, want {n}")
    finally:
        dist.destroy_process_group()


def _collective(device: str) -> Dict[str, Any]:
    import torch

    n = 0 if device == "cpu" else torch.cuda.device_count()
    if n < 2:
        return {"skipped": "single device"}
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_allreduce_worker, args=(n, port), nprocs=n, start_method="spawn")
    return {"devices": n, "all_reduce_correct": True}


def _threads(device: str) -> Dict[str, Any]:
    from mdi_llm_tpu_torch.server.explorer import doctor_burst

    burst = doctor_burst()
    if not burst.get("ok"):
        raise RuntimeError(f"the explorer burst found mismatches: {burst.get('mismatches')}")
    return burst


_STAGE_FUNCS: Dict[str, Callable[[str], Dict[str, Any]]] = {
    "import_torch": _import_torch,
    "devices": _devices,
    "matmul": _matmul,
    "kernels": _kernels,
    "graph": _graph,
    "profiler_trace": _profiler_trace,
    "collective": _collective,
    "threads": _threads,
}


def run_in_child(name: str) -> None:
    """A stage's body, in the fresh interpreter: prints its detail."""
    print(json.dumps(_STAGE_FUNCS[name](os.environ.get(DEVICE_ENV, "cuda"))), flush=True)


# ---------------------------------------------------------------------------
# the parent: provenance, stages under timeouts, the snapshot
# ---------------------------------------------------------------------------


def _package_versions() -> Dict[str, Optional[str]]:
    """Versions WITHOUT importing anything heavy: a broken install must not
    keep the snapshot from recording what is installed."""
    from importlib import metadata

    out: Dict[str, Optional[str]] = {}
    for pkg in ("torch", "numpy", "triton"):
        try:
            out[pkg] = metadata.version(pkg)
        except metadata.PackageNotFoundError:
            out[pkg] = None
    return out


def _probe_env() -> Dict[str, str]:
    return {
        k: (v if len(v) <= _ENV_VALUE_CAP else v[:_ENV_VALUE_CAP] + "…")
        for k, v in sorted(os.environ.items())
        if k.startswith(_ENV_PREFIXES)
    }


def provenance() -> Dict[str, Any]:
    """The cheap, always-safe environment record (no subprocess, no torch
    import): versions, host and the probe-relevant environment."""
    return {
        "schema": SCHEMA_VERSION,
        "hostname": socket.gethostname(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "versions": _package_versions(),
        "env": _probe_env(),
    }


def run_stage(stage: Dict[str, Any], timeout: Optional[float] = None,
              env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Run one stage in a fresh interpreter under a hard timeout.  Returns
    {"name", "status": ok|failed|timeout|skipped, "elapsed_s", "timeout_s",
    "error", "detail"}."""
    budget = float(timeout if timeout is not None else stage["timeout"])
    rec: Dict[str, Any] = {
        "name": stage["name"],
        "status": "failed",
        "elapsed_s": 0.0,
        "timeout_s": budget,
        "error": None,
        "detail": {},
    }
    path = os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", stage["code"]],
            capture_output=True, text=True, timeout=budget,
            env={**os.environ, "PYTHONPATH": path, **(env or {})},
        )
    except subprocess.TimeoutExpired:
        rec["elapsed_s"] = round(time.perf_counter() - t0, 3)
        rec["status"] = "timeout"
        rec["error"] = f"no answer within {budget:g}s (process killed)"
        return rec
    except OSError as exc:  # spawn failure: still a record, never a raise
        rec["elapsed_s"] = round(time.perf_counter() - t0, 3)
        rec["error"] = f"{type(exc).__name__}: {exc}"
        return rec
    rec["elapsed_s"] = round(time.perf_counter() - t0, 3)
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-6:]
        rec["error"] = " | ".join(tail) or f"exit code {proc.returncode}"
        return rec
    payload: Dict[str, Any] = {}
    for line in reversed((proc.stdout or "").strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                payload = json.loads(line)
            except json.JSONDecodeError:
                pass
            break
    rec["detail"] = payload
    rec["status"] = "skipped" if "skipped" in payload else "ok"
    return rec


def collect_snapshot(quick: bool = False,
                     stage_timeout: Optional[float] = None,
                     stages: Optional[List[Dict[str, Any]]] = None,
                     env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Provenance + staged results.  `quick` keeps the first three stages
    (import/devices/matmul: is the card alive); `stage_timeout` overrides
    every stage's own budget; `stages` swaps in a custom stage list (tests
    inject a wedged stage).  `ok` is True iff every stage ended ok/skipped."""
    chosen = stages if stages is not None else [
        s for s in STAGES if not quick or s.get("quick")
    ]
    records = [run_stage(s, timeout=stage_timeout, env=env) for s in chosen]
    snap = provenance()
    snap["quick"] = bool(quick)
    snap["stages"] = records
    snap["ok"] = all(r["status"] in ("ok", "skipped") for r in records)
    for r in records:  # surface the device identity at the top level
        d = r.get("detail") or {}
        if "device_kind" in d:
            snap["backend"] = d.get("platform")
            snap["device_kind"] = d.get("device_kind")
            snap["device_count"] = d.get("device_count")
            break
    return snap


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mdi_llm_tpu_torch.cli.doctor",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--quick", action="store_true",
                    help="run only the bring-up stages (import_torch, devices, matmul)")
    ap.add_argument("--stage-timeout", type=float, default=None, metavar="SECONDS",
                    help="override every stage's own hard timeout "
                    "(defaults are per stage, 120-600 s)")
    ap.add_argument("--json", type=str, default=None, metavar="PATH",
                    help="also write the snapshot as pretty JSON to PATH "
                    "(stdout always carries the one-line snapshot)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the stages' device (default cuda; cpu must be asked for: "
                    "the card's stages then skip)")
    ap.add_argument("--list-stages", action="store_true",
                    help="print the stage list and exit")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_stages:
        for s in STAGES:
            tag = " [quick]" if s.get("quick") else ""
            print(f"{s['name']:<16} {s['timeout']:>5.0f}s{tag}  {s['help']}")
        return 0
    snap = collect_snapshot(quick=args.quick, stage_timeout=args.stage_timeout,
                            env={DEVICE_ENV: args.device})
    for r in snap["stages"]:
        mark = {"ok": "ok ", "skipped": "-- ", "timeout": "T/O", "failed": "ERR"}[r["status"]]
        line = f"doctor: [{mark}] {r['name']:<16} {r['elapsed_s']:.1f}s"
        if r["error"]:
            line += f"  {r['error']}"
        print(line, file=sys.stderr)
    v = snap["versions"]
    print(
        f"doctor: torch={v.get('torch')} backend={snap.get('backend')} "
        f"device_kind={snap.get('device_kind')} "
        f"-> {'HEALTHY' if snap['ok'] else 'UNHEALTHY'}",
        file=sys.stderr,
    )
    print(json.dumps(snap), flush=True)
    if args.json:
        p = Path(args.json)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(snap, indent=2) + "\n")
        print(f"doctor: snapshot -> {p}", file=sys.stderr)
    return 0 if snap["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
