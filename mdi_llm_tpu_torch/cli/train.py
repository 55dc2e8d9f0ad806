"""Training CLI of the port (`mdi_llm_tpu/cli/train.py`'s flags).

    python -m mdi_llm_tpu_torch.cli.train --model tiny-llama-1.1b \\
        --ckpt out/tiny-llama --dataset data/shakespeare --batch-size 4 \\
        --block-size 2048 --grad-acc-steps 2 --max-iters 100 --mesh dp=2

trains from `--dataset`'s `train.bin`/`val.bin` (uint16 token bins,
sampled by the native C++ loader where `make -C native` builds it, else
by the NumPy loader), prints one JSON line per log entry and writes the
checkpoint to `--ckpt` (default `out`).  `--init scratch` draws random
weights from `--seed` (or takes the params of a checkpoint the port wrote
in `--ckpt` before), `--init hf` starts from the checkpoint in `--ckpt`
(HF weights there are converted in place first), `--init resume`
continues a run from its checkpoint, on any mesh.
`--use-flash auto` runs attention through the flash kernels K2-K4 on a GPU
at `--block-size` >= 2048.  It runs on `cuda` and raises without a GPU
unless `--device cpu` is given.

`--mesh` ("dp=2", "tp=2", "dp=2,tp=2", "dp=1,pp=2", "dp=2,pp=2,tp=2")
lays the Trainer over a mesh whose every position sits on `--device` in
one process.  `--coordinator host:port --process-id I --num-processes N`
runs it over N processes (one command per process, process 0 holding the
TCP store at host:port; NCCL when each has a card of its own, else gloo,
staged through pinned host memory on a shared card): each holds a
contiguous block of the mesh's positions (the DDP/torchrun path of the
reference), samples the same global batch and keeps its rows; process 0
alone prints and writes the checkpoint.  With `--mesh pp=2` (or
`pp=2,tp=2`) over two processes each holds one GPipe stage (with its
whole tp group): the stages' activations and their gradients pass
between the processes (`training.MeshLayout`, the mesh's axes in the
order dp, pp, tp).  A process that does not join
within `parallel.nodes.TIMEOUT_S` seconds, or stops answering, fails the
others.

`--mesh dp=2,sp=4` (or `dp=2,sp=2,tp=2`) splits every row's sequence over
the sp ranks, attention riding the ring (`ops/ring_attention.py`, with tp
ranks inside each sp rank); `--mesh dp=2,ep=4` splits an MoE config's
experts over the ep ranks and its tokens over dp x ep
(`parallel/expert.py`, at `--moe-capacity-factor`, exact by default).
With `--coordinator` a process holds a contiguous block of the mesh's
positions: of the sp ranks (the ring's K/V chunks pass between the
processes, the gradients sum over them; `--mesh dp=1,sp=2,tp=2` over
four processes gives each one (sp, tp) position, the ring running per
tp rank), of the ep ranks (it keeps only their experts; the tokens'
dispatch and return cross the processes: `--mesh dp=1,ep=2`, `ep=2,tp=2`
with each process's whole tp group, `ep=2,dp=2` with both dp rows, or
`dp=2,ep=2` over four processes, one (dp, ep) position each), or of the
tp ranks beside every expert (`--mesh tp=2,ep=2`).  Start one command
per process, e.g. four on one card:

    for i in 3 2 1 0; do python -m mdi_llm_tpu_torch.cli.train \\
        --model tiny-llama-1.1b --dataset data/shakespeare --mesh dp=1,sp=2,tp=2 \\
        --coordinator 127.0.0.1:29500 --num-processes 4 --process-id $i & done

An MoE config (Mixtral) trains with `--moe-aux-weight` times its
load-balancing loss, in the dense formulation without an ep axis.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from mdi_llm_tpu_torch.cli._common import DTYPES, add_override_arg, config_overrides
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.parallel import nodes
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from mdi_llm_tpu_torch.training import Trainer, TrainingConfig, mesh_experts
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
    add_override_arg(ap)
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
    ap.add_argument("--mesh", default=None,
                    help='e.g. "dp=2", "tp=2", "dp=2,tp=2", "dp=1,pp=2" (GPipe stages), '
                    '"dp=2,pp=2,tp=2", "dp=2,sp=4" (ring attention), "dp=2,sp=2,tp=2", '
                    'or "dp=2,ep=4" (MoE configs: token-dispatch expert parallelism)')
    ap.add_argument("--moe-aux-weight", type=float, default=0.01,
                    help="weight of the MoE load-balancing loss (layer mean; "
                    "no effect on dense configs, not applied on pp meshes)")
    ap.add_argument("--moe-capacity-factor", type=float, default=None,
                    help="ep-mesh MoE training: dispatch capacity factor (bounds the "
                    "per-rank buffers, Switch-style drops past capacity); default "
                    "exact, no drops: gradients then match the dense formulation")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's TCP store: train one mesh over "
                    "--num-processes processes (each given its --process-id)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    return ap


def parse_mesh(spec):
    """{axis: size} of "dp=2,tp=2" (the JAX CLI's `parse_mesh` grammar)."""
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    return axes


def main(argv=None):
    args = build_parser().parse_args(argv)
    axes = parse_mesh(args.mesh)
    if args.coordinator or args.process_id is not None or args.num_processes is not None:
        if not args.coordinator or args.process_id is None or args.num_processes is None:
            raise SystemExit("--coordinator, --process-id and --num-processes go together")
        if not axes:
            raise SystemExit("--coordinator trains one mesh over the processes: give --mesh")

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
    overrides = config_overrides(args.override)
    if overrides and (args.init != "scratch" or has_checkpoint(out_dir)
                      or (out_dir / "model_config.yaml").exists()):
        raise SystemExit(
            f"--override changes a registry config: it goes with --model, not with "
            f"--init {args.init} or an out dir ({out_dir}) that holds a checkpoint or "
            "model_config.yaml")

    pid, n_proc = (args.process_id or 0), (args.num_processes or 1)
    try:
        if args.coordinator:
            ring = nodes.init_distributed(
                nodes.coordinator_config(args.coordinator, n_proc), pid,
                device=args.device)
            device = ring.device
        else:
            device = resolve_device(args.device)
        mesh = make_mesh(axes, [device], pid, n_proc) if axes else None
        return _train(args, tc, out_dir, overrides, device, mesh, lead=pid == 0)
    finally:
        nodes.shutdown_distributed()


def _train(args, tc, out_dir, overrides, device, mesh, lead: bool):
    """Build the Trainer, fit it and save; only the lead process prints."""
    say = print if lead else (lambda *a, **k: None)
    if args.init == "resume":
        trainer = Trainer.resume(out_dir, mesh=mesh, device=device)
        say(f"resumed at iter {trainer.iter_num}", flush=True)
    else:
        if args.init == "hf" and not has_checkpoint(out_dir):
            if lead:
                convert_hf_checkpoint(out_dir, model_name=args.model, dtype=DTYPES[tc.dtype])
            if mesh is not None and mesh.num_processes > 1:
                import torch.distributed as dist

                dist.barrier()  # the others read what process 0 converted
        if args.init == "hf" or (args.ckpt and has_checkpoint(out_dir)):
            cfg = Config.from_checkpoint(out_dir)
            # with the ep axis over the processes, this process's experts only
            cfg, params = load_checkpoint(out_dir, cfg=cfg, device=device,
                                          experts=mesh_experts(mesh, cfg))
        else:
            cfg = (
                Config.from_checkpoint(out_dir)
                if (out_dir / "model_config.yaml").exists()
                else Config.from_name(args.model or out_dir.name, **overrides)
            )
            params = None
        trainer = Trainer(cfg, tc, mesh=mesh, params=params, out_dir=out_dir, device=device)

    train_p, val_p = args.dataset / "train.bin", args.dataset / "val.bin"
    if native_loader.is_available():
        train = native_loader.NativeBinDataset(train_p, seed=args.seed)
        val = native_loader.NativeBinDataset(val_p, seed=args.seed + 1) if val_p.exists() else None
        say("using native C++ data loader", flush=True)
    else:
        train = data_loader.open_bin(train_p)
        val = data_loader.open_bin(val_p) if val_p.exists() else None

    def log_cb(entry):
        say(json.dumps(entry), flush=True)

    result = trainer.fit(train, val, max_iters=args.max_iters, log_cb=log_cb)
    trainer.save(out_dir)
    say(
        f"finished at iter {result['iter_num']}, best val loss "
        f"{result['best_val_loss']:.4f} → {out_dir}"
    )
    return result, trainer


if __name__ == "__main__":
    main()
