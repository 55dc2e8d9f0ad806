"""The collectives of the sharded forward, over the ranks of one process.

Where XLA inserts a psum or an all-gather between the shards of a GSPMD
program, the port's sharded forward (`models/transformer.sharded_forward`)
calls these on the list of the ranks' partial results, rank order:

- `all_reduce(parts)`: the sum (or the maximum), in rank order, on each
  rank's device;
- `all_gather(parts, dim)`: the concatenation along `dim`, in rank order,
  on each rank's device.

When every rank is on one device (tp ranks sharing one card) these are
plain tensor ops, done once and handed to every rank.  Across local
cards each device gets the parts copied to it and reduces them there
(written, not verified: it needs a host with several cards).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

__all__ = ["all_reduce", "all_gather"]


def _per_device(parts: Sequence[torch.Tensor], combine) -> List[torch.Tensor]:
    out: Dict[torch.device, torch.Tensor] = {}
    for p in parts:
        if p.device not in out:
            out[p.device] = combine([q.to(p.device, non_blocking=True) for q in parts])
    return [out[p.device] for p in parts]


_OPS = {"sum": torch.add, "max": torch.maximum}


def all_reduce(parts: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
    """The ranks' `parts` reduced by `op` ("sum" or "max") in rank order,
    one result per rank on its device (the same tensor for ranks that
    share a device)."""
    fn = _OPS[op]

    def reduce(ps):
        total = ps[0]
        for p in ps[1:]:
            total = fn(total, p)
        return total

    return _per_device(parts, reduce)


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The ranks' `parts` joined along `dim` in rank order, one result per
    rank on its device."""
    return _per_device(parts, lambda ps: torch.cat(list(ps), dim=dim))
