"""ctypes binding for the native C++ data loader (native/mdi_data.cpp).

The port's own copy of `mdi_llm_tpu/utils/native_loader.py`: a host-side
counterpart of `utils.data_loader.get_batch` with mmap'd token bins and
the window gathering done in C++.  It builds the shared library on demand
with the repository's Makefile (`make -C native`); `is_available()` says
whether that worked (no compiler: False), and the train CLI then samples
with the NumPy loader.  The same seed gives the JAX package's batches.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO_PATH = _NATIVE_DIR / "libmdi_data.so"
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not _SO_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (subprocess.SubprocessError, FileNotFoundError):
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError:
        _build_failed = True
        return None
    lib.mdi_open_bin.restype = ctypes.c_void_p
    lib.mdi_open_bin.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mdi_num_tokens.restype = ctypes.c_int64
    lib.mdi_num_tokens.argtypes = [ctypes.c_void_p]
    lib.mdi_sample_batch.restype = ctypes.c_int
    lib.mdi_sample_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mdi_read_tokens.restype = ctypes.c_int
    lib.mdi_read_tokens.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mdi_close_bin.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def is_available() -> bool:
    return _load() is not None


class NativeBinDataset:
    """Random-window batch sampler over a token .bin file, C++-backed."""

    def __init__(self, path, dtype=np.uint16, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no compiler / build failed)")
        self._lib = lib
        dtype = np.dtype(dtype)
        if dtype == np.uint16:
            ds = 2
        elif dtype == np.uint32:
            ds = 4
        else:
            raise ValueError("token dtype must be uint16 or uint32")
        self._handle = lib.mdi_open_bin(str(path).encode(), ds)
        if not self._handle:
            raise FileNotFoundError(f"cannot open token bin {path}")
        self._counter = np.uint64(seed or 1)

    def __len__(self) -> int:
        return int(self._lib.mdi_num_tokens(self._handle))

    def get_batch(self, batch_size: int, block_size: int) -> Tuple[np.ndarray, np.ndarray]:
        x = np.empty((batch_size, block_size), np.int32)
        y = np.empty((batch_size, block_size), np.int32)
        rc = self._lib.mdi_sample_batch(
            self._handle,
            batch_size,
            block_size,
            int(self._counter),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError(f"mdi_sample_batch failed (rc={rc})")
        nxt = (int(self._counter) + 0x9E3779B97F4A7C15) % (1 << 64)
        self._counter = np.uint64(nxt or 1)
        return x, y

    def read(self, start: int, count: int) -> np.ndarray:
        out = np.empty((count,), np.int32)
        rc = self._lib.mdi_read_tokens(
            self._handle, start, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        if rc != 0:
            raise RuntimeError(f"mdi_read_tokens failed (rc={rc})")
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.mdi_close_bin(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
