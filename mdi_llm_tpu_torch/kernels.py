"""Build and load the port's hand-written CUDA kernels.

Every source `csrc/<name>.cu` has a plain C interface.  At first use it is
compiled by `nvcc` for `sm_90a` (Hopper) into `build/torch_kernels/` at the
repository root and loaded with `ctypes`; nothing is compiled when a
module is imported, so the CPU-only test machines import every module.
The library's file name carries a digest of its source, of every header
under `csrc/` (a shared `*.cuh` may be included by any source) and of the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.  A failed
build raises with the compiler's output.

    python -c "from mdi_llm_tpu_torch import kernels; print(kernels.build())"

builds all of them (one `nvcc` each, started together) and prints the
seconds each took; `build/torch_kernels/<name>.log` keeps the `-Xptxas -v`
register and shared-memory report.

A kernel is called through ctypes, so `torch.utils.flop_counter.
FlopCounterMode` (which the observability layer counts a step's
operations with, `obs/device.py`) cannot see it.  `flop_tally()` opens a
tally for the current thread; while it is open every wrapper adds the
operations of each launch, counted from its static shapes, through
`add_flops`.

`define_op` binds a launch as an operator of the port's own `torch.library`
namespace (`torch.ops.mdi_torch`): its CUDA implementation is the launch,
its meta implementation gives the shapes the launch returns and allocates.
A step traced on meta tensors (the compiled-program analysis,
`analysis/ir.py`) then holds one node per launch, where the card launches
it; the CPU has no implementation (the wrappers send CPU tensors to the
plain versions before the operator).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterator, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("ragged_paged_attention", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_tally: contextvars.ContextVar = contextvars.ContextVar("flop_tally", default=None)


class FlopTally:
    """Operations the kernel wrappers launched while the tally was open."""

    def __init__(self):
        self.flops = 0.0


@contextlib.contextmanager
def flop_tally() -> Iterator[FlopTally]:
    """Count the kernels' operations launched in this context (thread)."""
    tally = FlopTally()
    token = _tally.set(tally)
    try:
        yield tally
    finally:
        _tally.reset(token)


def add_flops(n: float) -> None:
    """Called by a kernel wrapper at each launch: adds `n` to the open
    tally, if any (a no-op outside `flop_tally`)."""
    tally = _tally.get()
    if tally is not None:
        tally.flops += n


NAMESPACE = "mdi_torch"
_library = None


def define_op(schema: str, *, cuda, meta):
    """Define `torch.ops.mdi_torch.<name>` from `schema` with `cuda` as its
    CUDA implementation and `meta` as its meta one; returns the operator.
    An operator defined already (a module imported twice) is returned as
    it is."""
    import torch

    global _library
    name = schema.split("(", 1)[0]
    ns = getattr(torch.ops, NAMESPACE)
    if hasattr(ns, name):
        return getattr(ns, name).default
    if _library is None:
        _library = torch.library.Library(NAMESPACE, "FRAGMENT")
    _library.define(schema)
    _library.impl(name, cuda, "CUDA")
    _library.impl(name, meta, "Meta")
    return getattr(ns, name).default


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the GPU"
        )
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in `names` that is not built yet, all nvcc
    processes at once; returns {name: build seconds} (0.0 when reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {name: 0.0 for name in names}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
