"""Model preparation CLI of the port: download, convert, partition.

Port of `mdi_llm_tpu/cli/prepare_model.py`.  A local directory's HF
weights (`*.safetensors` or `*.bin`, with their `config.json`) are
converted in place into a checkpoint of the port (`params.pt` +
`model_config.yaml`, the tokenizer files kept beside them), unless one is
there already.  Any other argument is a hub id (`org/name`): it is
downloaded into `<checkpoints-dir>/org/name` and converted there
(`utils/download.download_from_hub`; with `HF_HUB_OFFLINE=1` a snapshot
already placed in that directory is converted and nothing is fetched).
`--quantize int8|int4` also writes a pre-quantized copy into the sibling
directory `<ckpt>-<mode>/` (quantized `params.pt`, the config and the
tokenizer files), which every CLI's `--ckpt` loads with no further flag.
`--n-stages S` also writes the stage partition: one checkpoint per stage
under `<ckpt>/chunks/<S>stages/stage_<i>/` (`parallel/partition.py`'s
split) and its `stage_map.json` (for the quantized copy too).

    python -m mdi_llm_tpu_torch.cli.prepare_model TinyLlama/TinyLlama-1.1B-Chat-v1.0
    python -m mdi_llm_tpu_torch.cli.prepare_model checkpoints/TinyLlama-1.1B-Chat-v1.0
    python -m mdi_llm_tpu_torch.cli.prepare_model checkpoints/TinyLlama-1.1B-Chat-v1.0 --quantize int8
    python -m mdi_llm_tpu_torch.cli.prepare_model checkpoints/TinyLlama-1.1B-Chat-v1.0 --n-stages 2
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from mdi_llm_tpu_torch.parallel.partition import save_stage_manifest, split_params
from mdi_llm_tpu_torch.utils.checkpoint import (
    TOKENIZER_FILES,
    convert_hf_checkpoint,
    has_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

DTYPES = ("bfloat16", "float32")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model", help="HF repo id (org/name) or local checkpoint dir")
    ap.add_argument("--checkpoints-dir", type=Path, default=Path("checkpoints"),
                    help="where a hub id is downloaded to (<dir>/org/name)")
    ap.add_argument("--dtype", choices=DTYPES, default="bfloat16")
    ap.add_argument("--access-token", default=None, help="HF token for gated repos")
    ap.add_argument(
        "--quantize", choices=("none", "int8", "int4"), default="none",
        help="additionally write a pre-quantized checkpoint (<ckpt>-<mode>/) "
        "that every CLI loads with no further flags: quantize once here "
        "instead of in every process at load",
    )
    ap.add_argument("--n-stages", "--n-nodes", type=int, default=0, dest="n_stages",
                    help="also write one checkpoint per pipeline stage and the "
                    "stage manifest")
    return ap


def write_stages(base_dir: Path, cfg, params, n_stages: int, quantize: str = "none") -> Path:
    """One checkpoint per stage under `base_dir/chunks/<S>stages/` and its
    `stage_map.json`; returns the chunk directory."""
    chunk_dir = base_dir / "chunks" / f"{n_stages}stages"
    for i, st in enumerate(split_params(cfg, params, n_stages)):
        save_checkpoint(st, cfg, chunk_dir / f"stage_{i}")
    save_stage_manifest(chunk_dir, cfg, n_stages, quantize=quantize)
    print(f"wrote {n_stages} stage checkpoints -> {chunk_dir}")
    return chunk_dir


def main(argv=None) -> Path:
    import torch

    args = build_parser().parse_args(argv)
    dtype = getattr(torch, args.dtype)
    ckpt_dir = Path(args.model)
    if ckpt_dir.exists():
        if not has_checkpoint(ckpt_dir):
            convert_hf_checkpoint(ckpt_dir, dtype=dtype)
    else:
        from mdi_llm_tpu_torch.utils.download import download_from_hub

        ckpt_dir = download_from_hub(args.model, args.checkpoints_dir,
                                     access_token=args.access_token, dtype=dtype)
    cfg = params = None
    if args.n_stages > 1 or args.quantize != "none":
        cfg, params = load_checkpoint(ckpt_dir)
    if args.n_stages > 1:
        write_stages(ckpt_dir, cfg, params, args.n_stages)
    if args.quantize != "none":
        from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params

        qp = quantize_params(params, mode=FLAG_TO_MODE[args.quantize])
        q_dir = ckpt_dir.parent / f"{ckpt_dir.name}-{args.quantize}"
        save_checkpoint(qp, cfg, q_dir)
        # the tokenizer files travel with the quantized copy, so it is a
        # self-contained --ckpt target
        for name in TOKENIZER_FILES:
            if (ckpt_dir / name).exists():
                shutil.copy(ckpt_dir / name, q_dir / name)
        if args.n_stages > 1:  # pipeline deployments get quantized stage chunks too
            write_stages(q_dir, cfg, qp, args.n_stages, quantize=args.quantize)
        print(f"wrote {args.quantize}-quantized checkpoint -> {q_dir}")
    print(f"checkpoint ready: {ckpt_dir}")
    return ckpt_dir


if __name__ == "__main__":
    main()
