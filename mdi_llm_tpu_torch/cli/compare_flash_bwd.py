"""Time the flash backward kernels K3 (dQ) and K4 (dK/dV) of this checkout
against the same kernels built from a variant of their sources, on the GPU.

    python -m mdi_llm_tpu_torch.cli.compare_flash_bwd --other DIR \\
        [--shapes main,ragged,noncausal,hs32,hs128] [--iters 20]

DIR is a copy of `mdi_llm_tpu_torch/csrc/` with one change (it must sit
where the GPU machine's copy of the checkout can read it).  Both libraries
are built, each under its own digest in `build/torch_kernels/`.  For each
shape (bfloat16, tiny-llama-1.1b's 32 heads and 4 KV groups, inputs and
the forward's LSE from a seed) the two versions run in turns this, other,
other, this: each turn holds K3 and K4 against their plain versions run in
float32 on the same inputs (max |err|) and times each with CUDA events.
Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from mdi_llm_tpu_torch import kernels
from mdi_llm_tpu_torch.ops import flash

SHAPES = {  # label: (B, T, head size, causal)
    "main": (4, 2048, 64, True),
    "ragged": (2, 1000, 64, True),
    "noncausal": (2, 512, 64, False),
    "hs32": (1, 1000, 32, True),
    "hs128": (1, 1000, 128, True),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--other", required=True, help="a variant of mdi_llm_tpu_torch/csrc/")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    return ap


def _use(csrc: Path) -> None:
    kernels.CSRC = csrc
    kernels._loaded.pop("flash_attention_bwd", None)
    kernels.library("flash_attention_bwd")


def _ms(fn, n: int) -> float:
    fn()
    # mdi-lint: disable-next-line=host-sync -- timing harness: the sync is the point
    torch.cuda.synchronize()
    # the host queues every launch while the card sleeps, so the events
    # time the launches back to back on the device, not the host's pace
    torch.cuda._sleep(100_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _case(B, T, hs, causal, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
               for shape in ((B, 32, T, hs), (B, 4, T, hs), (B, 4, T, hs)))
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    dsum = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, dsum, hs ** -0.5, causal)
    f32 = [x.float() for x in (q, k, v, do)] + [lse, dsum, hs ** -0.5, causal]
    ref = (flash.flash_dq_plain(*f32),) + flash.flash_dkv_plain(*f32)
    return args, ref


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_flash_bwd measures the GPU: it needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card")
    versions = {"this": kernels.CSRC, "other": Path(args.other).resolve()}
    lines = []
    for label in args.shapes.split(","):
        B, T, hs, causal = SHAPES[label]
        call, ref = _case(B, T, hs, causal, seed=T)
        res = {name: {"K3_ms": [], "K4_ms": [], "max_abs_err": 0.0} for name in versions}
        for name in ("this", "other", "other", "this"):
            _use(versions[name])
            got = (flash.flash_dq(*call),) + flash.flash_dkv(*call)
            # mdi-lint: disable-next-line=host-sync -- one error read per version in a 4-turn A/B, off the timed path
            err = max((a.float() - r).abs().max().item() for a, r in zip(got, ref))
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            res[name]["K3_ms"].append(round(_ms(lambda: flash.flash_dq(*call), args.iters), 4))
            res[name]["K4_ms"].append(round(_ms(lambda: flash.flash_dkv(*call), args.iters), 4))
        line = {"shape": label, "B": B, "T": T, "hs": hs, "causal": causal, **res}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del call, ref
        torch.cuda.empty_cache()
    _use(versions["this"])
    return lines


if __name__ == "__main__":
    main()
