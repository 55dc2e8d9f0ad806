"""Evaluation CLI of the port: mean cross-entropy and perplexity of a
checkpoint on a token bin.

Port of `mdi_llm_tpu/cli/evaluate.py` (the reference's in-training
`estimate_loss`, standalone): `--eval-iters` random batches of
`--batch-size` windows of `--block-size` tokens from `<dataset>/<split>.bin`
(`utils/data_loader.get_batch`, drawn from `--seed` as the JAX CLI draws
them), each scored by `training.cross_entropy_loss` with `remat=False` on
the dense attention route, as the JAX CLI scores them; one JSON line with
the JAX CLI's keys.  No optimizer state is built.  Runs on the GPU unless
`--device cpu` is given; without a GPU and without that flag it raises.

    python -m mdi_llm_tpu_torch.cli.evaluate --ckpt checkpoints/custom/NanoLlama \\
        --dataset data/shakespeare --split val --eval-iters 50
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", type=Path, required=True)
    ap.add_argument("--dataset", type=Path, required=True, help="dir with <split>.bin")
    ap.add_argument("--split", default="val", choices=("train", "val"))
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--eval-iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=10137)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu must be asked for)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mdi_llm_tpu_torch.cli._common import DTYPES, select_device
    from mdi_llm_tpu_torch.training import cross_entropy_loss
    from mdi_llm_tpu_torch.utils import data_loader
    from mdi_llm_tpu_torch.utils.checkpoint import load_checkpoint

    device = select_device(args)
    cfg, params = load_checkpoint(args.ckpt, dtype=DTYPES[args.dtype], device=device)
    block_size = int(args.block_size or cfg.block_size)
    bin_path = args.dataset / f"{args.split}.bin"
    data = data_loader.open_bin(bin_path)
    if len(data) <= block_size + 1:
        raise SystemExit(
            f"{bin_path} holds {len(data)} tokens — need more than "
            f"block_size+1 = {block_size + 1} (pass a smaller --block-size)"
        )
    rng = np.random.default_rng(args.seed)
    losses = []
    with torch.no_grad():
        for _ in range(args.eval_iters):
            x, y = data_loader.get_batch(data, args.batch_size, block_size, rng)
            loss = cross_entropy_loss(cfg, params, torch.from_numpy(x).to(device),
                                      torch.from_numpy(y).to(device), remat=False)
            losses.append(float(loss))
    loss = float(np.mean(losses))
    print(json.dumps({
        "ckpt": str(args.ckpt),
        "split": args.split,
        "tokens": int(len(data)),
        "eval_iters": args.eval_iters,
        "loss": round(loss, 4),
        "perplexity": round(math.exp(min(loss, 20.0)), 3),
    }))
    return 0


if __name__ == "__main__":
    main()
