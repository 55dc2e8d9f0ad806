"""Inverse checkpoint conversion: the port's tree to a HF state dict.

Port of `mdi_llm_tpu/cli/convert_to_hf.py`: loads a checkpoint of the
port, un-fuses the QKV interleave and restores HF's naming per family
(`utils/checkpoint.convert_to_hf_state_dict`), and writes
`model.safetensors` (the port's own writer) or `pytorch_model.bin`
(`torch.save`), so the weights load back into `transformers`.

    python -m mdi_llm_tpu_torch.cli.convert_to_hf --ckpt checkpoints/custom/NanoLlama --out export/
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None, help="default: <ckpt>/hf_export")
    ap.add_argument("--format", choices=("safetensors", "bin"), default="safetensors")
    return ap


def main(argv=None) -> Path:
    import torch

    from mdi_llm_tpu_torch.utils.checkpoint import (
        convert_to_hf_state_dict,
        load_checkpoint,
        write_safetensors,
    )

    args = build_parser().parse_args(argv)
    cfg, params = load_checkpoint(args.ckpt)
    sd = convert_to_hf_state_dict(cfg, params)
    out = args.out or (args.ckpt / "hf_export")
    out.mkdir(parents=True, exist_ok=True)
    if args.format == "safetensors":
        path = out / "model.safetensors"
        write_safetensors(sd, path, metadata={"format": "pt"})
    else:
        path = out / "pytorch_model.bin"
        torch.save({k: v.contiguous().clone() for k, v in sd.items()}, path)
    print(f"wrote {len(sd)} tensors to {path}")
    return path


if __name__ == "__main__":
    main()
