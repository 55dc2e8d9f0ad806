"""Training CLI of the port (`mdi_llm_tpu/cli/train.py`'s flags).

    python -m mdi_llm_tpu_torch.cli.train --model tiny-llama-1.1b \\
        --ckpt out/tiny-llama --dataset data/shakespeare --batch-size 4 \\
        --block-size 2048 --grad-acc-steps 2 --max-iters 100

trains on one GPU from `--dataset`'s `train.bin`/`val.bin` (uint16 token
bins, sampled by the native C++ loader where `make -C native` builds it,
else by the NumPy loader), prints one JSON line per log entry and writes
the checkpoint to `--ckpt` (default `out`).  `--init scratch` draws random
weights from `--seed` (or takes the params of a checkpoint the port wrote
in `--ckpt` before), `--init hf` starts from the checkpoint in `--ckpt`
(HF weights there are converted in place first), `--init resume`
continues a run from its checkpoint.
`--use-flash auto` runs attention through the flash kernels K2-K4 on a GPU
at `--block-size` >= 2048.  It runs on `cuda` and raises without a GPU
unless `--device cpu` is given.

Refused, each naming its ROADMAP item: `--mesh` and
`--coordinator`/`--process-id`/`--num-processes` (multi-device training),
and MoE settings other than the defaults.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from mdi_llm_tpu_torch.cli._common import DTYPES, refuse
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.training import Trainer, TrainingConfig
from mdi_llm_tpu_torch.utils import data_loader, native_loader
from mdi_llm_tpu_torch.utils.checkpoint import (
    convert_hf_checkpoint,
    has_checkpoint,
    load_checkpoint,
)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", type=Path, default=None,
                    help="output (and --init resume input) directory, default out")
    ap.add_argument("--model", default=None,
                    help="registry model name (default: the --ckpt directory's name)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    ap.add_argument("--seed", type=int, default=10137)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--dataset", type=Path, required=True, help="dir with train.bin/val.bin")
    ap.add_argument("--init", choices=["scratch", "resume", "hf"], default="scratch")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--grad-acc-steps", type=int, default=1)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--max-iters", type=int, default=600000)
    ap.add_argument("--learning-rate", type=float, default=3e-4)
    ap.add_argument("--warmup-iters", type=int, default=2000)
    ap.add_argument("--lr-decay-iters", type=int, default=600000)
    ap.add_argument("--min-lr", type=float, default=6e-5)
    ap.add_argument("--weight-decay", type=float, default=1e-1)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--ckpt-interval", type=int, default=1000)
    ap.add_argument("--eval-iters", type=int, default=20)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--patience", type=int, default=5)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument(
        "--use-flash", choices=("auto", "on", "off"), default="auto",
        help="attention via the flash kernels (K2 forward, K3/K4 backward); "
        "auto = on a GPU at block size >= 2048",
    )
    ap.add_argument("--mesh", default=None, help="not ported yet: refused")
    ap.add_argument("--moe-aux-weight", type=float, default=0.01,
                    help="MoE training is not ported: only the default")
    ap.add_argument("--moe-capacity-factor", type=float, default=None,
                    help="MoE training is not ported: only the default")
    ap.add_argument("--coordinator", default=None, help="not ported yet: refused")
    ap.add_argument("--process-id", type=int, default=None, help="not ported yet: refused")
    ap.add_argument("--num-processes", type=int, default=None, help="not ported yet: refused")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh:
        refuse("--mesh (multi-device training, items 14-17)")
    if args.coordinator or args.process_id is not None or args.num_processes is not None:
        refuse("--coordinator/--process-id/--num-processes (multi-host training, item 17)")

    tc = TrainingConfig(
        batch_size=args.batch_size,
        block_size=args.block_size,
        grad_acc_steps=args.grad_acc_steps,
        learning_rate=args.learning_rate,
        warmup_iters=args.warmup_iters,
        lr_decay_iters=args.lr_decay_iters,
        min_lr=args.min_lr,
        weight_decay=args.weight_decay,
        grad_clip=args.grad_clip,
        max_iters=args.max_iters,
        eval_iters=args.eval_iters,
        ckpt_interval=args.ckpt_interval,
        log_interval=args.log_interval,
        patience=args.patience,
        seed=args.seed,
        dtype=args.dtype if args.dtype != "float16" else "bfloat16",
        remat=not args.no_remat,
        use_flash={"auto": None, "on": True, "off": False}[args.use_flash],
        moe_aux_weight=args.moe_aux_weight,
        moe_capacity_factor=args.moe_capacity_factor,
    )
    out_dir = Path(args.ckpt) if args.ckpt else Path("out")

    if args.init == "resume":
        trainer = Trainer.resume(out_dir, device=args.device)
        print(f"resumed at iter {trainer.iter_num}", flush=True)
    else:
        device = resolve_device(args.device)
        if args.init == "hf" and not has_checkpoint(out_dir):
            convert_hf_checkpoint(out_dir, model_name=args.model, dtype=DTYPES[tc.dtype])
        if args.init == "hf" or (args.ckpt and has_checkpoint(out_dir)):
            cfg, params = load_checkpoint(out_dir, device=device)
        else:
            cfg = (
                Config.from_checkpoint(out_dir)
                if (out_dir / "model_config.yaml").exists()
                else Config.from_name(args.model or out_dir.name)
            )
            params = None
        trainer = Trainer(cfg, tc, params=params, out_dir=out_dir, device=device)

    train_p, val_p = args.dataset / "train.bin", args.dataset / "val.bin"
    if native_loader.is_available():
        train = native_loader.NativeBinDataset(train_p, seed=args.seed)
        val = native_loader.NativeBinDataset(val_p, seed=args.seed + 1) if val_p.exists() else None
        print("using native C++ data loader", flush=True)
    else:
        train = data_loader.open_bin(train_p)
        val = data_loader.open_bin(val_p) if val_p.exists() else None

    def log_cb(entry):
        print(json.dumps(entry), flush=True)

    result = trainer.fit(train, val, max_iters=args.max_iters, log_cb=log_cb)
    trainer.save(out_dir)
    print(
        f"finished at iter {result['iter_num']}, best val loss "
        f"{result['best_val_loss']:.4f} → {out_dir}"
    )
    return result, trainer


if __name__ == "__main__":
    main()
