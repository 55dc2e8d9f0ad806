"""OpenWebText (or any HF dataset) preparation CLI of the port: tokenize a
dataset of documents into memmapped token bins.

Port of `mdi_llm_tpu/cli/prepare_owt.py`: HF `datasets` load (a dataset
saved with `save_to_disk`, a `DatasetDict`'s splits concatenated, else
`datasets.load_dataset`) → a seeded `train_test_split` → `.map` tokenize
with the checkpoint's tokenizer (`utils/tokenizer.py`), eos after each
document → `train.bin` / `val.bin`, uint16 below a 2^16 vocabulary and
uint32 from it.  The bins are byte for byte the JAX CLI's, in the format
of `cli/prepare_data.py`, so the trainer and `cli/evaluate.py` read
either.  No device is involved.  `--num-proc 1` tokenizes in this process
(recent `datasets` releases start a pool of one worker for `num_proc=1`;
the port passes `None` instead, so nothing is forked from a process that
may hold a CUDA context).

    python -m mdi_llm_tpu_torch.cli.prepare_owt --ckpt <tokenizer-dir> --out data/owt
    python -m mdi_llm_tpu_torch.cli.prepare_owt --dataset wikitext \\
        --dataset-config wikitext-2-raw-v1 --ckpt <dir> --out data/wt2
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="openwebtext", help="HF dataset id or local dir")
    ap.add_argument("--dataset-config", default=None)
    ap.add_argument("--ckpt", type=Path, required=True, help="tokenizer source dir")
    ap.add_argument("--out", type=Path, required=True, help="output directory")
    ap.add_argument("--text-column", default="text")
    ap.add_argument("--num-proc", type=int, default=4)
    ap.add_argument("--val-frac", type=float, default=0.0005)
    ap.add_argument("--seed", type=int, default=2357)
    return ap


def save_documents(texts, path: Path, text_column: str = "text") -> Path:
    """Save a list of documents as a local dataset (`save_to_disk`) that
    `--dataset path` reads."""
    import datasets

    datasets.Dataset.from_dict({text_column: list(texts)}).save_to_disk(str(path))
    return path


def _tokenize_split(ds, tok, text_column, num_proc, eos_id):
    def enc(batch):
        outs = [np.asarray(tok.encode(t), np.uint32) for t in batch[text_column]]
        if eos_id is not None:  # document separator (≡ append eot per doc)
            outs = [np.concatenate([o, [eos_id]]) for o in outs]
        return {"ids": [o.tolist() for o in outs], "len": [len(o) for o in outs]}

    return ds.map(
        enc,
        batched=True,
        num_proc=num_proc if num_proc > 1 else None,
        remove_columns=ds.column_names,
        desc="tokenizing",
    )


def _write_bin(ds, path: Path, dtype) -> int:
    """Concatenate all docs into one memmapped bin (constant RAM)."""
    total = int(np.sum(ds["len"], dtype=np.int64))
    arr = np.memmap(path, dtype=dtype, mode="w+", shape=(total,))
    n_shards = min(1024, max(1, len(ds)))
    idx = 0
    for shard in range(n_shards):
        batch = ds.shard(num_shards=n_shards, index=shard, contiguous=True)
        if len(batch) == 0:
            continue
        ids = np.concatenate([np.asarray(d, dtype) for d in batch["ids"]])
        arr[idx : idx + len(ids)] = ids
        idx += len(ids)
    arr.flush()
    return total


def main(argv=None):
    """Write `train.bin` and `val.bin` into `--out`; returns their paths."""
    args = build_parser().parse_args(argv)
    import datasets  # HF datasets; the heavy import stays out of module scope

    from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(args.ckpt)
    eos_id = getattr(tok, "eos_id", None)
    vocab = getattr(tok, "vocab_size", 2**17) or 2**17
    dtype = np.uint16 if vocab < 2**16 else np.uint32

    local = Path(args.dataset)
    if local.exists():
        ds = datasets.load_from_disk(str(local))
        if isinstance(ds, datasets.DatasetDict):
            ds = datasets.concatenate_datasets(list(ds.values()))
    else:
        ds = datasets.load_dataset(
            args.dataset, args.dataset_config, split="train", num_proc=args.num_proc
        )

    split = ds.train_test_split(test_size=args.val_frac, seed=args.seed, shuffle=True)
    args.out.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, part in (("train", split["train"]), ("val", split["test"])):
        tokked = _tokenize_split(part, tok, args.text_column, args.num_proc, eos_id)
        path = args.out / f"{name}.bin"
        n = _write_bin(tokked, path, dtype)
        print(f"{name}.bin: {n} tokens ({dtype.__name__})")
        paths.append(path)
    return tuple(paths)


if __name__ == "__main__":
    main()
