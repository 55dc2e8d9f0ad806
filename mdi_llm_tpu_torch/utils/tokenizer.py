"""Dual-backend tokenizer wrapper.

Copy of `mdi_llm_tpu/utils/tokenizer.py`: auto-detect a HuggingFace
`tokenizer.json` (through the `tokenizers` library) or a SentencePiece
`tokenizer.model` in a checkpoint directory, resolve bos/eos ids from
`tokenizer_config.json`, then `generation_config.json`, and expose
encode/decode.  Returns NumPy int32 arrays.  Both libraries are imported
only when a tokenizer of their kind is opened; SentencePiece falls through
to `tokenizer.json` where it is not installed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Union

import numpy as np


class Tokenizer:
    def __init__(self, checkpoint_dir: Union[str, Path], force_backend: Optional[str] = None):
        checkpoint_dir = Path(checkpoint_dir)
        if not checkpoint_dir.exists():
            raise NotADirectoryError(f"checkpoint dir {checkpoint_dir} not found")

        self.model_name = checkpoint_dir.stem
        self.use_bos = self._check_use_bos(checkpoint_dir)
        self.bos_id: Optional[int] = None
        self.eos_id: Optional[int] = None
        self.backend: str

        hf_file = checkpoint_dir / "tokenizer.json"
        sp_file = checkpoint_dir / "tokenizer.model"

        want = force_backend
        if want not in (None, "huggingface", "sentencepiece"):
            raise ValueError(f"unknown tokenizer backend {want!r}")

        if (want == "sentencepiece" or (want is None and sp_file.is_file())) and sp_file.is_file():
            try:
                from sentencepiece import SentencePieceProcessor  # type: ignore
            except ImportError as e:
                if want == "sentencepiece":
                    raise RuntimeError(
                        "sentencepiece backend requested but the library is not installed"
                    ) from e
                SentencePieceProcessor = None  # fall through to HF
            else:
                self.processor = SentencePieceProcessor(model_file=str(sp_file))
                self.backend = "sentencepiece"
                self.bos_id = self.processor.bos_id()
                self.eos_id = self.processor.eos_id()
                self._load_special_ids(checkpoint_dir)
                return

        if hf_file.is_file():
            from tokenizers import Tokenizer as HFTokenizer

            self.processor = HFTokenizer.from_file(str(hf_file))
            self.backend = "huggingface"
            self._load_special_ids(checkpoint_dir)
            if self.bos_id is None:
                self.bos_id = self.token_to_id("<s>", missing_ok=True)
            if self.eos_id is None:
                self.eos_id = self.token_to_id("</s>", missing_ok=True)
            return

        raise NotImplementedError(
            f"no tokenizer.json or usable tokenizer.model in {checkpoint_dir}"
        )

    # -- special ids ---------------------------------------------------------

    def _load_special_ids(self, checkpoint_dir: Path) -> None:
        """bos/eos resolution order mirrors the reference
        (tokenizer.py:58-79): tokenizer_config.json tokens, then
        generation_config.json ids."""
        cfg_path = checkpoint_dir / "tokenizer_config.json"
        if cfg_path.is_file():
            cfg = json.loads(cfg_path.read_text())

            def tok_str(entry):
                if entry is None:
                    return None
                return entry["content"] if isinstance(entry, dict) else entry

            bos = tok_str(cfg.get("bos_token"))
            eos = tok_str(cfg.get("eos_token"))
            if bos is not None and self.bos_id is None:
                self.bos_id = self.token_to_id(bos, missing_ok=True)
            if eos is not None and self.eos_id is None:
                self.eos_id = self.token_to_id(eos, missing_ok=True)
        gen_path = checkpoint_dir / "generation_config.json"
        if gen_path.is_file():
            gen = json.loads(gen_path.read_text())
            if self.bos_id is None:
                b = gen.get("bos_token_id")
                self.bos_id = b[0] if isinstance(b, list) else b
            if self.eos_id is None:
                e = gen.get("eos_token_id")
                self.eos_id = e[0] if isinstance(e, list) else e

    @staticmethod
    def _check_use_bos(checkpoint_dir: Path) -> bool:
        cfg_path = checkpoint_dir / "tokenizer_config.json"
        if cfg_path.is_file():
            cfg = json.loads(cfg_path.read_text())
            if "add_bos_token" in cfg:
                return bool(cfg["add_bos_token"])
            # LlamaTokenizer adds bos by default
            return cfg.get("tokenizer_class") == "LlamaTokenizer"
        return False

    # -- API -----------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        if self.backend == "huggingface":
            return self.processor.get_vocab_size(with_added_tokens=False)
        return self.processor.vocab_size()

    def token_to_id(self, token: str, missing_ok: bool = False) -> Optional[int]:
        if self.backend == "huggingface":
            tid = self.processor.token_to_id(token)
        else:
            tid = self.processor.piece_to_id(token)
        if tid is None and not missing_ok:
            raise ValueError(f"token {token!r} not found in the vocabulary")
        return tid

    def encode(
        self,
        text: str,
        bos: Optional[bool] = None,
        eos: bool = False,
        max_length: int = -1,
    ) -> np.ndarray:
        if self.backend == "huggingface":
            ids: List[int] = self.processor.encode(text).ids
        else:
            ids = self.processor.encode(text)

        use_bos = self.use_bos if bos is None else bos
        if use_bos:
            if self.bos_id is None:
                raise NotImplementedError("tokenizer has no bos token")
            if not ids or ids[0] != self.bos_id:
                ids = [self.bos_id] + ids
        if eos and (not ids or ids[-1] != self.eos_id):
            ids = ids + [self.eos_id]
        if max_length > 0:
            ids = ids[:max_length]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        ids = [int(t) for t in np.asarray(ids).reshape(-1)]
        if self.backend == "huggingface":
            return self.processor.decode(ids)
        return self.processor.decode(ids)
