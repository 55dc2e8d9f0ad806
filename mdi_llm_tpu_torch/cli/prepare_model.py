"""Model preparation CLI of the port: convert a local HF snapshot.

Port of `mdi_llm_tpu/cli/prepare_model.py` for a local directory: the HF
weights in it (`*.safetensors` or `*.bin`, with their `config.json`) are
converted in place into a checkpoint of the port (`params.pt` +
`model_config.yaml`, the tokenizer files kept beside them), unless one is
there already.  Nothing is downloaded: a hub name is refused.  Stage
partitioning (`--n-stages`, item 15) and pre-quantized copies
(`--quantize`, item 10) are refused.

    python -m mdi_llm_tpu_torch.cli.prepare_model checkpoints/TinyLlama-1.1B-Chat-v1.0
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mdi_llm_tpu_torch.cli._common import refuse
from mdi_llm_tpu_torch.utils.checkpoint import convert_hf_checkpoint, has_checkpoint

DTYPES = ("bfloat16", "float32")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model", help="local HF checkpoint directory")
    ap.add_argument("--dtype", choices=DTYPES, default="bfloat16")
    unported = ap.add_argument_group("not ported yet (refused when set)")
    unported.add_argument("--n-stages", "--n-nodes", type=int, default=0, dest="n_stages")
    unported.add_argument("--quantize", default="none")
    return ap


def main(argv=None) -> Path:
    import torch

    args = build_parser().parse_args(argv)
    if args.n_stages > 1:
        refuse("--n-stages (stage partitioning, item 15)")
    if args.quantize != "none":
        refuse(f"--quantize {args.quantize} (weight quantization, item 10)")
    ckpt_dir = Path(args.model)
    if not ckpt_dir.is_dir():
        raise SystemExit(
            f"{args.model} is not a local directory: the port downloads "
            "nothing (no network access is assumed); place the HF snapshot "
            "in a directory and pass its path"
        )
    if not has_checkpoint(ckpt_dir):
        convert_hf_checkpoint(ckpt_dir, dtype=getattr(torch, args.dtype))
    print(f"checkpoint ready: {ckpt_dir}")
    return ckpt_dir


if __name__ == "__main__":
    main()
