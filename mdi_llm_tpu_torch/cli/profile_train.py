"""Where a training step's time goes on the GPU.

Builds the Trainer for a registry model with random weights from
`--seed` (bf16, remat, attention on the flash kernels at `--block-size`
>= 2048), runs one optimizer step to warm up and one under
`torch.profiler` on synthetic batches (tokens from `--vocab` ids), and
prints one JSON line: the step's wall time, the device time summed over
all kernels, the device's idle share of the wall time, the device time of
each flash kernel (K2 forward, K3 dQ, K4 dK/dV) and its share of the
step's device time, and the kernels that took the most device time.  The
profiler's own cost is inside the profiled wall time, so the idle share
is an upper bound.

    python -m mdi_llm_tpu_torch.cli.profile_train --model tiny-llama-1.1b \\
        --batch-size 4 --block-size 2048 --grad-acc-steps 2
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mdi_llm_tpu_torch.cli.profile_serve import device_summary
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.training import Trainer, TrainingConfig

# name fragments: each kernel is flash_<name>_kernel (float32) or
# flash_<name>_wg_kernel (bfloat16)
FLASH_KERNELS = {"K2": "flash_attention_", "K3": "flash_dq_", "K4": "flash_dkv_"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=2048)
    ap.add_argument("--grad-acc-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=10137)
    ap.add_argument("--vocab", type=int, default=512, help="synthetic tokens' id range")
    ap.add_argument("--use-flash", choices=("auto", "on", "off"), default="auto")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the GPU: it needs a CUDA device")
    cfg = Config.from_name(args.model)
    tc = TrainingConfig(
        batch_size=args.batch_size, block_size=args.block_size,
        grad_acc_steps=args.grad_acc_steps, learning_rate=1e-3, warmup_iters=0,
        seed=args.seed, use_flash={"auto": None, "on": True, "off": False}[args.use_flash],
    )
    tr = Trainer(cfg, tc, device="cuda")
    rng = np.random.default_rng(args.seed)
    shape = (args.grad_acc_steps, args.batch_size, args.block_size + 1)

    def step():
        tok = rng.integers(0, args.vocab, shape).astype(np.int32)
        return tr.train_step(tok[..., :-1], tok[..., 1:])

    step()  # warm-up: CUDA context, cuBLAS handles, kernel build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step()  # a host float: the step has finished on the device
        wall_s = time.perf_counter() - t0
    line = device_summary(prof, wall_s, top=12)
    device_ms = line["device_s"] * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    flash = {}
    for label, name in FLASH_KERNELS.items():
        hits = [e for e in kernels if name in e.key]
        ms = sum(e.device_time_total for e in hits) / 1e3
        flash[label] = {"calls": sum(e.count for e in hits), "device_ms": round(ms, 3),
                        "share_of_device": round(ms / device_ms, 4)}
    line.update(model=args.model, batch=args.batch_size, block=args.block_size,
                grad_acc=args.grad_acc_steps, use_flash=tr.use_flash, loss=round(loss, 4),
                flash_kernels=flash)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
