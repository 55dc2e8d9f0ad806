"""Device meshes of the port: the tensor/data-parallel mesh and the stage
placement of the pipeline.

Port of `mdi_llm_tpu/parallel/mesh.py`.

- `make_mesh(axes, devices)` is the JAX package's `make_mesh`: a grid of
  devices with named axes (`dp`, `tp`), the same validation and messages.
  The port's `Mesh` is a small record (axis names, sizes, the grid of
  `torch.device`s); nothing is compiled over it: the sharded forward
  (`models/transformer.sharded_forward`) runs each tensor-parallel rank's
  slice on the rank's device and sums the partial results
  (`parallel/collectives.py`).  One addition, the rule `pipeline_mesh`
  has too: `devices` with ONE entry puts every mesh position on that
  device, which is how one card runs tp = 2 or 4.  A mesh over the
  processes of a job (`num_processes` > 1, the training CLI's
  `--coordinator`) gives each process `n / num_processes` contiguous
  positions, process-major, as `jax.distributed` lays out its global
  device list (`Mesh.owned`); `devices` then names the process's own
  device, where every position it owns sits.
- `pipeline_mesh` maps each pipeline stage to a `torch.device` where the
  JAX package lays S stages over a 1-D `pipe` mesh axis.  Three layouts:
  S stages on one device (`devices` one entry, or None: the default
  device), the ring's hop a shift on that device; S stages on S local
  devices, the hop a copy between them; a process's share of the stages
  (`stages` a range of stage indices), the hop to a stage of another
  process a send/recv (`parallel/nodes.py`).  A tensor-parallel axis
  inside each stage (`tp > 1`) is ROADMAP item 14, second half.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "pipeline_mesh"]


class Mesh:
    """A grid of devices with named axes: `axis_names` in order, `shape`
    {axis: size} in that order, and `devices`, a numpy object array of
    `torch.device`s of that shape (positions may share a device)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 process_id: int = 0, num_processes: int = 1):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.process_id, self.num_processes = process_id, num_processes

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def owned(self, process_id: Optional[int] = None) -> range:
        """The row-major indices of the positions process `process_id`
        (default: this one) holds: a contiguous block of size /
        num_processes."""
        p = self.process_id if process_id is None else process_id
        n = self.size // self.num_processes
        return range(p * n, (p + 1) * n)

    def positions(self):
        """Every mesh position as {axis: coordinate}, row-major (the order
        of `devices.flat`)."""
        for idx in np.ndindex(*self.devices.shape):
            yield dict(zip(self.axis_names, idx))

    def device_list(self):
        """The positions' devices, row-major."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        procs = (f", process {self.process_id} of {self.num_processes}"
                 if self.num_processes > 1 else "")
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})}{procs})"


def _default_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device here and no `devices` given; pass "
            "devices=['cpu'] to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None,
              process_id: int = 0, num_processes: int = 1) -> Mesh:
    """A Mesh with the given {axis_name: size}.  Sizes must multiply to at
    most the device count; pass -1 for one axis to infer it.  `devices`
    with one entry puts every position on that device (any sizes).

    Over `num_processes` > 1 processes, `devices` is this process's one
    device (every position it owns sits there), every size is given and
    they multiply to a multiple of `num_processes`."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for {num_processes} processes")
    if num_processes > 1:
        if devices is None or len(devices) != 1 or -1 in axes.values():
            raise ValueError(
                f"a mesh over {num_processes} processes takes this process's one "
                f"device and every axis's size; got {dict(axes)} on devices={devices!r}")
        n = math.prod(axes.values())
        if n % num_processes:
            raise ValueError(
                f"mesh {dict(axes)} has {n} positions: not a multiple of the "
                f"{num_processes} processes")
        mesh = make_mesh(axes, devices)
        mesh.process_id, mesh.num_processes = process_id, num_processes
        return mesh
    devs = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    sizes = dict(axes)
    for name, v in sizes.items():
        if not isinstance(v, int) or (v < 1 and v != -1):
            raise ValueError(
                f"mesh axis {name!r} must have size >= 1 (or -1 to infer), "
                f"got {v!r}"
            )
    infer = [k for k, v in sizes.items() if v == -1]
    if len(infer) > 1:
        raise ValueError(f"only one axis size may be -1, got {infer}")
    known = math.prod(v for v in sizes.values() if v != -1)
    if infer:
        if known > len(devs) or len(devs) % known:
            explicit = {k: v for k, v in sizes.items() if v != -1}
            raise ValueError(
                f"cannot infer axis {infer[0]!r}: explicit sizes {explicit} "
                f"multiply to {known}, which does not divide the "
                f"{len(devs)} available devices"
            )
        sizes[infer[0]] = len(devs) // known
    total = math.prod(sizes.values())
    if len(devs) == 1:
        devs = devs * total
    if total > len(devs):
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {len(devs)}"
        )
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devs[:total]):
        grid[i] = d
    return Mesh(grid.reshape(*sizes.values()), tuple(sizes.keys()))


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
            "yet (ROADMAP item 14, second half)"
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
