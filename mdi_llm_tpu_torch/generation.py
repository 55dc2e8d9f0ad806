"""The model handle the serving engine is built from.

Port of the parts of `mdi_llm_tpu/generation.py` the serving path needs:
the `Generator` constructor for one device, `Generator.serve`, and the
host-side stop-token helpers.  `Generator.generate`, `generate_chat` and
`ChatSession` (sequential generation, kernel K2) are a later slice.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.models import transformer


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, "cuda" when None.  A CUDA device on a
    machine without one raises: the port never falls back to the CPU by
    itself — pass device="cpu" (or --device cpu) to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mdi_llm_tpu_torch runs on the GPU by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return dev


def detect_stop_tokens(tokens: Sequence[int], stop_sequences: Sequence[Sequence[int]]) -> bool:
    """True if `tokens` ends with any of the stop sequences."""
    for seq in stop_sequences:
        n = len(seq)
        if n and len(tokens) >= n and list(tokens[-n:]) == list(seq):
            return True
    return False


def find_eot(tokens: Sequence[int], stop_sequences: Sequence[Sequence[int]]) -> int:
    """Index of the first stop-sequence start in `tokens` (len(tokens) if
    none): where a finished stream is cut."""
    tokens = list(tokens)
    best = len(tokens)
    for seq in stop_sequences:
        n = len(seq)
        if not n:
            continue
        for i in range(len(tokens) - n + 1):
            if tokens[i : i + n] == list(seq):
                best = min(best, i)
                break
    return best


class Generator:
    """One model on one device: config, parameters (the layer-stacked tree
    of `transformer.init_params`), context window, KV dtype, rope tables
    and the sampling seed."""

    def __init__(
        self,
        cfg: Config,
        params: Any,
        max_seq_length: Optional[int] = None,
        cache_dtype: Optional[torch.dtype] = None,  # None → params dtype
        rng_seed: int = 1337,
        device=None,  # None → "cuda"
    ):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = transformer.tree_map(lambda x: x.to(self.device), params)
        if cache_dtype is None:
            cache_dtype = transformer.param_dtype(self.params)
        self.cache_dtype = cache_dtype
        self.max_seq_length = int(
            min(max_seq_length or cfg.block_size, cfg.block_size)
        )
        self.rope = transformer.get_rope_cache(cfg, device=self.device)
        self.rng_seed = int(rng_seed)

    def serve(self, serving=None, policy=None, **knobs):
        """A paged-KV continuous-batching engine over this model
        (`serving/engine.py`).  Pass a `ServingConfig`, or its fields as
        keywords::

            engine = gen.serve(block_size=16, max_batch=8)
            engine.add_request("r0", prompt_tokens, max_new_tokens=128)
            results, stats = engine.run()
        """
        from mdi_llm_tpu_torch.config import ServingConfig
        from mdi_llm_tpu_torch.serving.engine import ServingEngine

        if serving is None:
            serving = ServingConfig(**knobs)
        elif knobs:
            raise ValueError("pass a ServingConfig or keywords, not both")
        return ServingEngine(self, serving, policy=policy)
