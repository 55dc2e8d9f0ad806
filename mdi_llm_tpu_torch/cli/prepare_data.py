"""Dataset preparation CLI of the port: raw text -> tokenized train.bin and
val.bin.

Port of `mdi_llm_tpu/cli/prepare_data.py` (the reference's
`src/prepare_data.py`): the text file is tokenized with the checkpoint's
tokenizer (`utils/tokenizer.py`), split 90/10 (`--frac-train`) and
written as uint16 bins that `np.memmap` reads
(`utils/data_loader.prepare_bin`); the bins are byte for byte the JAX
CLI's.  No device is involved.

    python -m mdi_llm_tpu_torch.cli.prepare_data --dataset data/shakespeare/input.txt \\
        --ckpt checkpoints/tiny-llama
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mdi_llm_tpu_torch.utils.data_loader import prepare_bin
from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", type=Path, required=True, help="input .txt file")
    ap.add_argument("--ckpt", type=Path, required=True, help="tokenizer source dir")
    ap.add_argument("--out", type=Path, default=None,
                    help="output dir (default: alongside the input)")
    ap.add_argument("--frac-train", type=float, default=0.9)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = args.out or args.dataset.parent
    train_p, val_p = prepare_bin(args.dataset, out, Tokenizer(args.ckpt), args.frac_train)
    print(f"wrote {train_p} and {val_p}")
    return train_p, val_p


if __name__ == "__main__":
    main()
