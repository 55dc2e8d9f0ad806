"""Self-contained trainable tokenizers for scratch experiments.

Copy of `mdi_llm_tpu/utils/simple_tokenizers.py` (NumPy only): a
character-level tokenizer and a minimal trainable byte-pair encoder, each
with the encode/decode surface of `utils.tokenizer.Tokenizer` plus
`train(text)` and JSON persistence.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


class CharTokenizer:
    """Character-level tokenizer (one char = one token)."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None):
        self.stoi: Dict[str, int] = dict(vocab or {})
        self.itos: Dict[int, str] = {i: c for c, i in self.stoi.items()}

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)

    def train(self, text: str) -> "CharTokenizer":
        chars = sorted(set(text))
        self.stoi = {c: i for i, c in enumerate(chars)}
        self.itos = {i: c for c, i in self.stoi.items()}
        return self

    def encode(self, text: str, bos: bool = False, eos: bool = False, max_length: int = -1) -> np.ndarray:
        ids = [self.stoi[c] for c in text if c in self.stoi]
        if max_length > 0:
            ids = ids[:max_length]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos.get(int(i), "") for i in np.asarray(ids).reshape(-1))

    def save(self, path: PathLike) -> None:
        Path(path).write_text(json.dumps({"type": "char", "vocab": self.stoi}))

    @classmethod
    def load(cls, path: PathLike) -> "CharTokenizer":
        data = json.loads(Path(path).read_text())
        return cls(data["vocab"])


class BPETokenizer:
    """Minimal trainable byte-pair-encoding tokenizer.

    `train(text, vocab_size)` learns merges greedily over byte pairs
    (≡ reference `BPETokenizer.tokenize(out_vocab_size)`,
    old/GPT2/sub/bpe_tokenizer.py:134); encode applies merges in learned
    order; decode concatenates byte sequences.
    """

    def __init__(self):
        self.merges: List[Tuple[int, int]] = []  # pair -> new id = 256 + idx
        self._ranks: Dict[Tuple[int, int], int] = {}

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def train(self, text: str, vocab_size: int) -> "BPETokenizer":
        if vocab_size < 256:
            raise ValueError("vocab_size must be >= 256 (byte alphabet)")
        ids = list(text.encode("utf-8"))
        self.merges = []
        while 256 + len(self.merges) < vocab_size:
            counts = Counter(zip(ids, ids[1:]))
            if not counts:
                break
            pair, freq = counts.most_common(1)[0]
            if freq < 2:
                break
            new_id = 256 + len(self.merges)
            self.merges.append(pair)
            ids = self._merge(ids, pair, new_id)
        self._ranks = {p: i for i, p in enumerate(self.merges)}
        return self

    @staticmethod
    def _merge(ids: List[int], pair: Tuple[int, int], new_id: int) -> List[int]:
        out = []
        i = 0
        while i < len(ids):
            if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        return out

    def encode(self, text: str, bos: bool = False, eos: bool = False, max_length: int = -1) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        while len(ids) >= 2:
            pairs = set(zip(ids, ids[1:]))
            ranked = [p for p in pairs if p in self._ranks]
            if not ranked:
                break
            best = min(ranked, key=lambda p: self._ranks[p])
            ids = self._merge(ids, best, 256 + self._ranks[best])
        if max_length > 0:
            ids = ids[:max_length]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        table: Dict[int, bytes] = {i: bytes([i]) for i in range(256)}
        for idx, (a, b) in enumerate(self.merges):
            table[256 + idx] = table[a] + table[b]
        data = b"".join(table.get(int(i), b"") for i in np.asarray(ids).reshape(-1))
        return data.decode("utf-8", errors="replace")

    def save(self, path: PathLike) -> None:
        Path(path).write_text(
            json.dumps({"type": "bpe", "merges": [list(m) for m in self.merges]})
        )

    @classmethod
    def load(cls, path: PathLike) -> "BPETokenizer":
        data = json.loads(Path(path).read_text())
        tok = cls()
        tok.merges = [tuple(m) for m in data["merges"]]
        tok._ranks = {p: i for i, p in enumerate(tok.merges)}
        return tok
