"""Shared CLI plumbing of the port: model/dtype/device flags and model
loading (the parts of `mdi_llm_tpu/cli/_common.py` the serve CLI needs).

Only `--model NAME` with random weights drawn from `--seed` is ported;
checkpoints (`--ckpt`) and weight quantization (`--quantize`) are refused
until a later slice carries them.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.models import transformer

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model", default=None,
                    help="registry model name (random weights from --seed)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (not ported yet: refused)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    ap.add_argument("--seed", type=int, default=10137)
    ap.add_argument("--sequence-length", type=int, default=None,
                    help="truncate max context")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--quantize", default="none",
                    help="weight quantization (not ported yet: only 'none')")
    ap.add_argument("--kv-dtype", choices=("auto", *DTYPES), default="auto",
                    help="paged KV pool dtype (auto follows --dtype)")


def refuse(what: str) -> None:
    raise SystemExit(
        f"mdi_llm_tpu_torch: {what} is not ported yet (see ROADMAP.md Queue 1)"
    )


def load_model(args) -> Tuple[Config, dict]:
    """(config, random params from --seed on --device) for --model."""
    if args.ckpt:
        refuse("--ckpt (checkpoint loading)")
    if args.quantize != "none":
        refuse(f"--quantize {args.quantize}")
    if not args.model:
        raise SystemExit("--model is required")
    cfg = Config.from_name(args.model)
    transformer.check_supported(cfg)
    params = transformer.init_params(
        cfg, args.seed, dtype=DTYPES[args.dtype], device=args.device
    )
    return cfg, params
