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
  device, where every position it owns sits; `Mesh.held` reads which
  coordinates of an axis it holds, `Mesh.process_groups` which processes
  split an axis between them (the tp group, the ep group of a Generator
  over processes).
- `pipeline_mesh` maps each pipeline stage to a `torch.device` where the
  JAX package lays S stages over a 1-D `pipe` mesh axis.  Three layouts:
  S stages on one device (`devices` one entry, or None: the default
  device), the ring's hop a shift on that device; S stages on S local
  devices, the hop a copy between them; a process's share of the stages
  (`stages` a range of stage indices), the hop to a stage of another
  process a send/recv (`parallel/nodes.py`).  With a tensor-parallel
  axis inside each stage (`tp > 1`) it returns what the JAX package's
  returns: a `Mesh` with axes `("pipe", "tp")`, stage s's rank r at
  position (s, r).
- `stage_ranks(mesh)` reads either form as {stage: [the devices of its tp
  ranks]} for the stages this process runs.  A pipe x tp mesh over
  processes gives each process whole tp groups of a contiguous group of
  stages (the layout `jax.distributed` gives such a mesh, its pipeline
  axis first); any other layout is refused, naming it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "pipeline_mesh", "pipe_axis", "stage_ranks", "PIPE_AXES"]

# the names of a mesh's pipeline axis: the ring's "pipe", the serving "pp"
PIPE_AXES = ("pipe", "pp")


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

    def held(self, axis: str, process_id: Optional[int] = None) -> List[int]:
        """The coordinates of `axis` (0 where the mesh lacks it) among the
        positions process `process_id` (default: this one) holds."""
        coords = list(self.positions())
        return sorted({coords[i].get(axis, 0) for i in self.owned(process_id)})

    def process_groups(self, axis: str) -> List[List[int]]:
        """The processes that split `axis` between them, one list per
        group: processes holding the same coordinates of every other axis,
        in the order of their `axis` coordinates; the groups in one order
        on every process (sorted by what their members share), a process
        alone left out.  Build a `collectives.CommGroup` of each on every
        process, in this order: `dist.new_group` is collective."""
        table: Dict[tuple, list] = {}
        for p in range(self.num_processes):
            key = tuple(tuple(self.held(a, p)) for a in self.axis_names if a != axis)
            table.setdefault(key, []).append((self.held(axis, p), p))
        return [[p for _, p in sorted(m)] for _, m in sorted(table.items()) if len(m) > 1]

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
):
    """{stage index: device} for the stages `stages` (default: all S).
    `devices` holds one device for all stages, or one per stage (each
    process's share indexes it by global stage).

    With `tp > 1` the pipe x tp mesh: a `Mesh` of axes ("pipe", "tp"),
    `devices` one device for every position or S x tp of them, stage-major.
    A process's share of it is `make_mesh({"pipe": S, "tp": tp}, [device],
    process_id, num_processes)`."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if tp < 1:
        raise ValueError(f"tp={tp} must be a positive device count")
    if tp > 1:
        if stages is not None:
            raise ValueError(
                "a process's share of a pipe x tp mesh is make_mesh({'pipe': S, 'tp': "
                "tp}, [device], process_id, num_processes), not `stages`")
        devs = list(devices or ["cuda"])
        if len(devs) not in (1, n_stages * tp):
            raise ValueError(
                f"{len(devs)} devices for {n_stages} stages x tp={tp}: give one device "
                "for every position or one per position, stage-major")
        return make_mesh({"pipe": n_stages, "tp": tp}, devs)
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


def pipe_axis(mesh: Mesh) -> Optional[str]:
    """The name of `mesh`'s pipeline axis ("pipe" or "pp"), None without
    one."""
    found = [a for a in PIPE_AXES if a in mesh.shape]
    if len(found) > 1:
        raise ValueError(f"mesh {mesh.shape} has two pipeline axes {found}")
    return found[0] if found else None


def stage_ranks(mesh) -> Dict[int, List[torch.device]]:
    """{stage: [the device of each of its tp ranks, in tp order]} for the
    stages this process runs: from `pipeline_mesh`'s {stage: device} (one
    rank each), or from a Mesh of a pipeline axis ("pipe" or "pp") and a
    "tp" axis (any order; the other axes must have size 1).

    Over processes the process must hold whole tp groups of a contiguous
    group of stages (`Mesh.owned`, row-major): the pipeline axis first,
    and a stage count the process count divides."""
    if isinstance(mesh, dict):
        return {s: [torch.device(d)] for s, d in sorted(mesh.items())}
    pa = pipe_axis(mesh)
    extra = {a: n for a, n in mesh.shape.items() if a not in (pa, "tp") and n > 1}
    if pa is None or extra:
        raise ValueError(f"mesh {mesh.shape}: a pipeline mesh has a pipeline axis "
                         f"{PIPE_AXES} and a tp axis, and no other axis above size 1")
    coords = list(mesh.positions())
    devs = mesh.device_list()
    out: Dict[int, Dict[int, torch.device]] = {}
    for i in mesh.owned():
        c = coords[i]
        out.setdefault(c[pa], {})[c.get("tp", 0)] = devs[i]
    tp = int(mesh.shape.get("tp", 1))
    stages = sorted(out)
    whole = all(sorted(r) == list(range(tp)) for r in out.values())
    if not whole or stages != list(range(stages[0], stages[0] + len(stages))):
        raise ValueError(
            f"process {mesh.process_id} of {mesh.num_processes} holds the positions "
            f"{[coords[i] for i in mesh.owned()]} of mesh {mesh.shape}: a process of a "
            "pipeline mesh holds whole tp groups of a contiguous group of stages (put "
            f"the {pa!r} axis first and give it a multiple of the process count)")
    return {s: [torch.device(out[s][r]) for r in range(tp)] for s in stages}
