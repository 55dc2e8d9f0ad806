"""Weights download CLI of the port (port of
`mdi_llm_tpu/cli/download_weights.py`): fetch `org/name` from the HF hub
into `<checkpoints-dir>/org/name` and convert it into a checkpoint of the
port (`params.pt` + `model_config.yaml`, bfloat16); prints the directory.
With `HF_HUB_OFFLINE=1` it converts a snapshot already placed there.

    python -m mdi_llm_tpu_torch.cli.download_weights TinyLlama/TinyLlama-1.1B-Chat-v1.0
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mdi_llm_tpu_torch.utils.download import download_from_hub


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("repo_id", help="HF repo id, e.g. TinyLlama/TinyLlama-1.1B-Chat-v1.0")
    ap.add_argument("--checkpoints-dir", type=Path, default=Path("checkpoints"))
    ap.add_argument("--access-token", default=None)
    ap.add_argument("--tokenizer-only", action="store_true")
    ap.add_argument("--no-convert", action="store_true")
    return ap


def main(argv=None) -> Path:
    args = build_parser().parse_args(argv)
    out = download_from_hub(
        args.repo_id,
        args.checkpoints_dir,
        access_token=args.access_token,
        tokenizer_only=args.tokenizer_only,
        convert=not args.no_convert,
    )
    print(out)
    return out


if __name__ == "__main__":
    main()
