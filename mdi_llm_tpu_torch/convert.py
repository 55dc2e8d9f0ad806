"""Parameter trees from NumPy arrays into the port.

`params_from_numpy(tree, device, dtype)` turns the JAX package's parameter
tree, given as NumPy arrays (`jax.tree_util.tree_map(np.asarray, params)`),
into the port's: the same nested dicts and layer-stacked leaves, as torch
tensors on `device`.  Every leaf goes through float32 on the way, because
NumPy holds bfloat16 as `ml_dtypes.bfloat16`, which `torch.from_numpy`
does not take.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mdi_llm_tpu_torch.models.transformer import tree_map


def params_from_numpy(tree: Any, device="cpu", dtype=torch.float32) -> Any:
    return tree_map(
        # np.array copies: torch.from_numpy wants a writable array
        lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device, dtype=dtype
        ),
        tree,
    )
