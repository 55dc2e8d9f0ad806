"""Shared CLI plumbing of the port: model/dtype/device flags, model,
tokenizer and prompt-style loading, and the generation-run flags and
report (the parts of `mdi_llm_tpu/cli/_common.py` the single-device CLIs
need).

`--ckpt DIR` loads a checkpoint of the port (`params.pt`), converting a
directory that holds HF weights in place first; `--model NAME` draws
random weights from `--seed`.  Weight quantization (`--quantize`) is
refused until a later slice carries it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from mdi_llm_tpu_torch.config import TEMPERATURE, TOP_K, Config
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.utils import checkpoint as ckpt_utils
from mdi_llm_tpu_torch.utils.prompts import (
    PromptStyle,
    has_prompt_style,
    load_prompt_style,
    style_for_model,
)
from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
# KV-cache dtypes: the cache is written with a cast and upcast at the read
# (ops/attention.py), so it may be narrower than the compute dtype
KV_DTYPES = {**DTYPES, "float8": torch.float8_e4m3fn}


def resolve_kv_dtype(name: str):
    """--kv-dtype as a torch dtype; "auto" -> None (follow the weights).
    "int8" is not a dense-cache dtype: it selects the quantized paged pool
    (ServingConfig.kv_dtype), which the serve CLI routes there first."""
    if name == "int8":
        raise ValueError(
            "--kv-dtype int8 quantizes the paged serving pool "
            "(ServingConfig.kv_dtype), not the dense KV cache"
        )
    return None if name == "auto" else KV_DTYPES[name]


def add_common_args(ap: argparse.ArgumentParser, serving_kv: bool = False) -> None:
    """`serving_kv=True` (the serve CLI) also accepts --kv-dtype int8: the
    paged pool then stores int8 blocks with per-block-per-group scales."""
    ap.add_argument("--model", default=None,
                    help="registry model name (random weights from --seed)")
    ap.add_argument("--ckpt", type=Path, default=None,
                    help="checkpoint directory (params.pt, or HF weights that "
                    "are converted in place first)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    ap.add_argument("--seed", type=int, default=10137)
    ap.add_argument("--sequence-length", type=int, default=None,
                    help="truncate max context")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--quantize", default="none",
                    help="weight quantization (not ported yet: only 'none')")
    ap.add_argument(
        "--kv-dtype", choices=("auto", *KV_DTYPES) + (("int8",) if serving_kv else ()),
        default="auto",
        help="KV cache / paged pool storage dtype (auto follows --dtype; "
        "float8 is e4m3, upcast at the read)"
        + ("; int8 quantizes the paged pool: int8 blocks with per-block-per-"
           "group scales, dequantized inside kernel K1" if serving_kv else ""),
    )


def refuse(what: str) -> None:
    raise SystemExit(
        f"mdi_llm_tpu_torch: {what} is not ported yet (see ROADMAP.md Queue 1)"
    )


def load_model(
    args, need_tokenizer: bool = True
) -> Tuple[Config, dict, Optional[Tokenizer], Optional[PromptStyle]]:
    """(config, params on --device, tokenizer, prompt style) from --ckpt
    or --model.  A --ckpt dir holding raw HF weights is converted in place
    first; its tokenizer and prompt style load when `need_tokenizer`.
    --model draws random weights from --seed and has no tokenizer."""
    if args.quantize != "none":
        refuse(f"--quantize {args.quantize} (weight quantization, item 10)")
    dtype = DTYPES[args.dtype]
    tokenizer = prompt_style = None
    if args.ckpt:
        ckpt_dir = Path(args.ckpt)
        if not ckpt_dir.is_dir():
            raise SystemExit(f"--ckpt {ckpt_dir}: no such checkpoint directory")
        if not ckpt_utils.has_checkpoint(ckpt_dir):
            ckpt_utils.convert_hf_checkpoint(ckpt_dir, model_name=args.model, dtype=dtype)
        cfg = Config.from_checkpoint(ckpt_dir)
        transformer.check_supported(cfg)
        cfg, params = ckpt_utils.load_checkpoint(
            ckpt_dir, dtype=dtype, cfg=cfg, device=args.device
        )
        if need_tokenizer:
            tokenizer = Tokenizer(ckpt_dir)
            prompt_style = (
                load_prompt_style(ckpt_dir)
                if has_prompt_style(ckpt_dir)
                else style_for_model(cfg.name)
            )
    elif args.model:
        cfg = Config.from_name(args.model)
        transformer.check_supported(cfg)
        params = transformer.init_params(cfg, args.seed, dtype=dtype, device=args.device)
        prompt_style = style_for_model(cfg.name)
    else:
        raise SystemExit("one of --ckpt or --model is required")
    return cfg, params, tokenizer, prompt_style


def add_run_args(ap: argparse.ArgumentParser) -> None:
    """Generation-run flags (the JAX CLI's sample/starter flag set)."""
    ap.add_argument("--n-samples", type=int, default=1)
    ap.add_argument("--n-tokens", type=int, default=300, help="tokens per sample")
    ap.add_argument("--prompt", default="Once upon a time,", help='text or "FILE:<path>"')
    ap.add_argument("--temperature", type=float, default=TEMPERATURE)
    ap.add_argument("--top-k", type=int, default=TOP_K)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--greedy", action="store_true", help="temperature 0 (parity mode)")
    ap.add_argument("--plots", action="store_true")
    ap.add_argument("--time-run", type=Path, default=None, help="append run stats CSV")
    ap.add_argument("--logs-dir", type=Path, default=Path("logs"))


def report_run(args, cfg, tokenizer, prompt_ids, outs, stats, gen_time):
    """Print the samples (decoded where there is a tokenizer) and the
    throughput line, and write the tokens/time CSV, its plot and the
    run-stats CSV under the JAX CLI's file names (one device: one node)."""
    from mdi_llm_tpu_torch.utils import plots

    for i, (ids, plen) in enumerate(zip(outs, (len(p) for p in prompt_ids))):
        print(f"--- sample {i} ({len(ids) - plen} new tokens) " + "-" * 30)
        print(tokenizer.decode(np.asarray(ids)) if tokenizer is not None else ids)
    print(
        f"[1 node(s)] {stats.tokens_generated} tokens in {gen_time:.2f}s — "
        f"{stats.tokens_per_s:.2f} tok/s decode (prefill {stats.prefill_s:.2f}s)",
        file=sys.stderr,
    )
    if stats.interrupted:
        print("WARNING: generation interrupted — output is partial", file=sys.stderr)
    if args.plots or args.time_run:
        csv_path = plots.tok_time_csv_path(
            args.logs_dir, 1, cfg.name, args.n_samples
        )
        plots.write_tok_time_csv(csv_path, stats.tok_time)
        if args.plots:
            plots.plot_tokens_per_time(
                stats.tok_time, csv_path.with_suffix(".png"),
                label=f"{cfg.name} 1 node(s)",
            )
        if args.time_run:
            plots.append_run_stats(
                args.time_run, args.n_samples, cfg.n_layer,
                args.sequence_length or cfg.block_size, gen_time,
            )
