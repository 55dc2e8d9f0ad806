"""Shared CLI plumbing of the port: model/dtype/device flags, model,
tokenizer and prompt-style loading, and the generation-run flags and
report (the parts of `mdi_llm_tpu/cli/_common.py` the single-device CLIs
need).

`--ckpt DIR` loads a checkpoint of the port (`params.pt`), converting a
directory that holds HF weights in place first; `--model NAME` draws
random weights from `--seed`, with `--override KEY=VALUE` changing
fields of the registry config (a depth cut, or a tiny width for the
CPU). `--quantize int8|w8a8|int4` quantizes the weights when the
Generator is built (`ops/quant.py`); a checkpoint written by
`prepare_model --quantize` loads already quantized, with `--quantize
none`.  `make_tp_mesh` is the tensor-parallel mesh of `--tp` and
`--tp-devices`, `make_ep_mesh` the expert-parallel one of `--ep-devices`,
every rank on `--device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
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
    add_override_arg(ap)
    ap.add_argument("--ckpt", type=Path, default=None,
                    help="checkpoint directory (params.pt, or HF weights that "
                    "are converted in place first)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    ap.add_argument("--seed", type=int, default=10137)
    ap.add_argument("--sequence-length", type=int, default=None,
                    help="truncate max context")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument(
        "--quantize", choices=("none", "int8", "w8a8", "int4"), default="none",
        help="int8: weight-only per-channel int8 (half the weight bytes); "
        "w8a8: also quantizes activations per token and contracts int8 x "
        "int8 -> int32; int4: group-wise weight-only nibbles (a quarter of "
        "the weight bytes, coarser numerics)",
    )
    ap.add_argument(
        "--kv-dtype", choices=("auto", *KV_DTYPES) + (("int8",) if serving_kv else ()),
        default="auto",
        help="KV cache / paged pool storage dtype (auto follows --dtype; "
        "float8 is e4m3, upcast at the read)"
        + ("; int8 quantizes the paged pool: int8 blocks with per-block-per-"
           "group scales, dequantized inside kernel K1" if serving_kv else ""),
    )


def add_override_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--override", action="append", default=[], metavar="KEY=VALUE",
        help="set a field of --model's registry config (repeatable; VALUE is "
        "read as JSON, else as a string), e.g. --override n_layer=16",
    )


def config_overrides(items) -> dict:
    """`--override KEY=VALUE` items as Config keyword arguments."""
    fields = {f.name for f in dataclasses.fields(Config)}
    out = {}
    for item in items:
        key, sep, value = item.partition("=")
        if not sep or key not in fields:
            raise SystemExit(f"--override {item!r}: want KEY=VALUE with KEY a Config field")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def make_tp_mesh(tp_devices: int, quantize: str, device: str = "cuda",
                 process_id: int = 0, num_processes: int = 1):
    """Shared --tp-devices / --tp handling: validate, then a 1-D tp mesh
    (`parallel.mesh.make_mesh`), over `num_processes` processes when the
    CLI joined a job (`--coordinator`).  Composes with --quantize:
    quantized layouts split under the adapted Megatron specs
    (`parallel.sharding.adapt_specs_to_tree`).

    One deliberate difference from the JAX CLI, which lays the mesh over
    the first N devices: every rank (of this process) goes on the one
    `--device` (the default `cuda`, or `cpu`), so one card runs tp = N.
    A mesh over several cards is `make_mesh({"tp": N}, devices)` in the
    library."""
    del quantize  # accepted everywhere, as in the JAX CLI
    if tp_devices < 1:
        raise SystemExit("--tp-devices must be a positive device count")
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"tp": tp_devices}, [device], process_id, num_processes)


def make_ep_mesh(ep_devices: int, cfg: Config, device: str = "cuda",
                 process_id: int = 0, num_processes: int = 1):
    """Shared --ep-devices handling (the JAX CLI's): an MoE config and at
    least 2 ranks, then a 1-D ep mesh, over `num_processes` processes when
    the CLI joined a job (`--coordinator`), as `make_tp_mesh`.  Every rank
    of a process goes on the one `--device`, so one card runs ep = N."""
    if ep_devices < 2:
        raise SystemExit(
            "--ep-devices needs at least 2 devices (expert dispatch over an "
            "ep mesh; a single device is just the dense MoE path)")
    if cfg.mlp_class_name != "LLaMAMoE":
        raise SystemExit(f"--ep-devices needs a MoE config; {cfg.name} has "
                         f"mlp_class_name={cfg.mlp_class_name}")
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"ep": ep_devices}, [device], process_id, num_processes)


def refuse(what: str) -> None:
    raise SystemExit(
        f"mdi_llm_tpu_torch: {what} is not ported yet (see ROADMAP.md Queue 1)"
    )


def resolve_config(args) -> Config:
    """The architecture alone, with no weight read: the plan preflight runs
    on it, so a refused plan never pays the checkpoint load.  The
    --ckpt/--model resolution of `load_model` (a --ckpt dir of HF weights
    not converted yet gives its `config.json`'s architecture)."""
    overrides = config_overrides(getattr(args, "override", []))
    if args.ckpt and overrides:
        raise SystemExit("--override changes a registry config: it goes with --model, "
                         "not with --ckpt")
    if args.ckpt:
        ckpt_dir = Path(args.ckpt)
        if not ckpt_dir.is_dir():
            raise SystemExit(f"--ckpt {ckpt_dir}: no such checkpoint directory")
        cfg = Config.from_checkpoint(ckpt_dir)
    elif args.model:
        cfg = Config.from_name(args.model, **overrides)
    else:
        raise SystemExit("one of --ckpt or --model is required")
    transformer.check_supported(cfg)
    return cfg


def audit_device_kind(device) -> str:
    """The card a plan is audited for: "cpu" (the plain route) for a CPU
    device, else the card the port targets (`analysis.plan.H100`), named
    without asking the driver: the audit creates no CUDA context."""
    from mdi_llm_tpu_torch.analysis.plan import H100

    return "cpu" if torch.device(device or "cuda").type == "cpu" else H100


def add_preflight_args(ap: argparse.ArgumentParser) -> None:
    """The plan audit's flags (the JAX serve CLI's)."""
    ap.add_argument("--no-preflight", action="store_true",
                    help="downgrade a failing plan audit to a warning instead "
                    "of refusing to launch")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device memory budget in GiB for the plan audit "
                    "(e.g. 80 for an H100)")


def load_model(
    args, need_tokenizer: bool = True, experts: Optional[Tuple[int, int]] = None
) -> Tuple[Config, dict, Optional[Tokenizer], Optional[PromptStyle]]:
    """(config, params on --device, tokenizer, prompt style) from --ckpt
    or --model.  A --ckpt dir holding raw HF weights is converted in place
    first; its tokenizer and prompt style load when `need_tokenizer`.
    --model draws random weights from --seed and has no tokenizer.
    `experts` = (first, count): the MoE stacks hold only those experts (a
    process of an ep mesh over processes, `parallel.expert.owned_experts`)."""
    dtype = DTYPES[args.dtype]
    tokenizer = prompt_style = None
    overrides = config_overrides(getattr(args, "override", []))
    if args.ckpt and overrides:
        raise SystemExit("--override changes a registry config: it goes with --model, "
                         "not with --ckpt")
    if args.ckpt:
        ckpt_dir = Path(args.ckpt)
        if not ckpt_dir.is_dir():
            raise SystemExit(f"--ckpt {ckpt_dir}: no such checkpoint directory")
        if not ckpt_utils.has_checkpoint(ckpt_dir):
            ckpt_utils.convert_hf_checkpoint(ckpt_dir, model_name=args.model, dtype=dtype)
        cfg = Config.from_checkpoint(ckpt_dir)
        transformer.check_supported(cfg)
        cfg, params = ckpt_utils.load_checkpoint(
            ckpt_dir, dtype=dtype, cfg=cfg, device=args.device, experts=experts
        )
        if need_tokenizer:
            tokenizer = Tokenizer(ckpt_dir)
            prompt_style = (
                load_prompt_style(ckpt_dir)
                if has_prompt_style(ckpt_dir)
                else style_for_model(cfg.name)
            )
    elif args.model:
        cfg = Config.from_name(args.model, **overrides)
        transformer.check_supported(cfg)
        params = transformer.init_params(cfg, args.seed, dtype=dtype, device=args.device,
                                         experts=experts)
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


def report_run(args, cfg, tokenizer, prompt_ids, outs, stats, gen_time,
               n_nodes: int = 1, label: Optional[str] = None):
    """Print the samples (decoded where there is a tokenizer) and the
    throughput line, and write the tokens/time CSV, its plot and the
    run-stats CSV under the JAX CLI's file names, which carry the node
    count (`n_nodes`; `label` heads the throughput line)."""
    from mdi_llm_tpu_torch.utils import plots

    label = label or f"{n_nodes} node(s)"
    for i, (ids, plen) in enumerate(zip(outs, (len(p) for p in prompt_ids))):
        print(f"--- sample {i} ({len(ids) - plen} new tokens) " + "-" * 30)
        print(tokenizer.decode(np.asarray(ids)) if tokenizer is not None else ids)
    print(
        f"[{label}] {stats.tokens_generated} tokens in {gen_time:.2f}s — "
        f"{stats.tokens_per_s:.2f} tok/s decode (prefill {stats.prefill_s:.2f}s)",
        file=sys.stderr,
    )
    if stats.interrupted:
        print("WARNING: generation interrupted — output is partial", file=sys.stderr)
    if args.plots or args.time_run:
        csv_path = plots.tok_time_csv_path(
            args.logs_dir, n_nodes, cfg.name, args.n_samples
        )
        plots.write_tok_time_csv(csv_path, stats.tok_time)
        if args.plots:
            plots.plot_tokens_per_time(
                stats.tok_time, csv_path.with_suffix(".png"),
                label=f"{cfg.name} {n_nodes} node(s)",
            )
        if args.time_run:
            plots.append_run_stats(
                args.time_run, args.n_samples, cfg.n_layer,
                args.sequence_length or cfg.block_size, gen_time,
            )


def add_log_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--debug", action="store_true",
                    help="debug logging; a node also writes logs/logs_<role>.log")


def setup_logging(args, role: Optional[str] = None) -> logging.Logger:
    """Console logging; with --debug and a node role, also a per-role file
    `<logs_dir>/logs_<role>.log` (the reference's logs_starter.log /
    logs_secondary<i>.log).  Calling it again does not stack handlers."""
    debug = getattr(args, "debug", False)
    level = logging.DEBUG if debug else (
        logging.INFO if getattr(args, "verbose", False) else logging.WARNING)
    logging.basicConfig(level=level, format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("mdi_llm_tpu_torch")
    if debug and role:
        logs_dir = Path(getattr(args, "logs_dir", None) or "logs")
        logs_dir.mkdir(parents=True, exist_ok=True)
        path = logs_dir / f"logs_{role}.log"
        for h in list(log.handlers):
            if isinstance(h, logging.FileHandler) and h.baseFilename == os.path.abspath(path):
                h.close()
                log.removeHandler(h)
        fh = logging.FileHandler(path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
        log.addHandler(fh)
    return log


def select_device(args, node_device: Optional[str] = None) -> torch.device:
    """The run's device by precedence: an explicit --device, then the node
    JSON's "device", then cuda.  A CUDA device on a machine without one
    raises (the port never falls back to the CPU by itself).  Sets
    `args.device` to the choice."""
    from mdi_llm_tpu_torch.generation import resolve_device

    choice = args.device or node_device or "cuda"
    try:
        torch.device(choice)
    except RuntimeError:
        raise SystemExit(f"device {choice!r} is not a torch device (cuda or cpu)")
    args.device = choice
    return resolve_device(choice)
