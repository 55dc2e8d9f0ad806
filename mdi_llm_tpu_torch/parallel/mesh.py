"""Stage placement: which device holds each pipeline stage.

The pipeline half of `mdi_llm_tpu/parallel/mesh.py` (`pipeline_mesh`):
where the JAX package lays S stages over a 1-D `pipe` mesh axis, the port
maps each stage to a `torch.device`.  Three layouts:

- S stages on one device (`devices` one entry, or None: the default
  device), the ring's hop a shift on that device;
- S stages on S local devices (`devices` S entries), the hop a copy
  between them;
- a process's share of the stages (`stages` a range of stage indices),
  the hop to a stage of another process a send/recv (`parallel/nodes.py`).

A tensor-parallel axis inside each stage (`tp > 1`) is ROADMAP item 14.
`make_mesh` (dp/tp training meshes) waits for that item too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def pipeline_mesh(
    n_stages: int,
    devices: Optional[Sequence] = None,
    tp: int = 1,
    stages: Optional[Sequence[int]] = None,
) -> Dict[int, torch.device]:
    """{stage index: device} for the stages `stages` (default: all S).
    `devices` holds one device for all stages, or one per stage (each
    process's share indexes it by global stage)."""
    if tp > 1:
        raise NotImplementedError(
            f"tp={tp}: a tensor-parallel axis inside each stage is not ported "
            "yet (ROADMAP item 14)"
        )
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    devs = [torch.device(d) for d in (devices or ["cuda"])]
    if len(devs) not in (1, n_stages):
        raise ValueError(
            f"{len(devs)} devices for {n_stages} stages: give one device for "
            "all stages or one per stage"
        )
    owned = range(n_stages) if stages is None else list(stages)
    if not all(0 <= s < n_stages for s in owned):
        raise ValueError(f"stages {list(owned)} out of range for {n_stages} stages")
    return {s: devs[0] if len(devs) == 1 else devs[s] for s in owned}
