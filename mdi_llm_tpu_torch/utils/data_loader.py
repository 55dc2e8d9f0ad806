"""Training data pipeline: tokenized .bin memmaps and batch sampling.

The port's own copy of `mdi_llm_tpu/utils/data_loader.py` (NumPy only;
the port imports nothing of the JAX package): tokenize a text corpus to
uint16 `train.bin` / `val.bin`, then sample random block_size windows as
(x, y) next-token pairs.  The same `rng` gives the JAX package's batches.
Host-side; the trainer moves batches to the device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def load_dataset(path: PathLike, tokenizer) -> np.ndarray:
    """Tokenize a raw text file into one long uint16/uint32 id array
    (≡ reference `load_dataset`)."""
    text = Path(path).read_text()
    ids = tokenizer.encode(text, bos=False)
    dtype = np.uint16 if int(ids.max()) < 2**16 else np.uint32
    return ids.astype(dtype)


def split_dataset(data: np.ndarray, frac_train: float = 0.9) -> Tuple[np.ndarray, np.ndarray]:
    """90/10 train/val split (≡ reference `split_dataset`)."""
    n = int(len(data) * frac_train)
    return data[:n], data[n:]


def prepare_bin(
    text_path: PathLike, out_dir: PathLike, tokenizer, frac_train: float = 0.9
) -> Tuple[Path, Path]:
    """Tokenize `text_path` and write train.bin/val.bin (≡ prepare_data.py)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = load_dataset(text_path, tokenizer)
    train, val = split_dataset(data, frac_train)
    train_p, val_p = out_dir / "train.bin", out_dir / "val.bin"
    train.tofile(train_p)
    val.tofile(val_p)
    return train_p, val_p


def open_bin(path: PathLike, dtype=np.uint16) -> np.ndarray:
    """Memory-map a token bin file (≡ reference np.memmap usage,
    train.py:138-139)."""
    return np.memmap(path, dtype=dtype, mode="r")


def get_batch(
    data: np.ndarray,
    batch_size: int,
    block_size: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample `batch_size` random windows: x = tokens[i:i+T],
    y = tokens[i+1:i+T+1] (≡ reference `get_batch`, data_loader.py:70-126)."""
    rng = rng or np.random.default_rng()
    ix = rng.integers(0, len(data) - block_size - 1, size=batch_size)
    x = np.stack([np.asarray(data[i : i + block_size], dtype=np.int32) for i in ix])
    y = np.stack(
        [np.asarray(data[i + 1 : i + 1 + block_size], dtype=np.int32) for i in ix]
    )
    return x, y
