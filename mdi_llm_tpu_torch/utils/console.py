"""Console affordances: progress bar, wait spinner, object sizing.

A copy of `mdi_llm_tpu/utils/console.py` (the port keeps its own copy of
what it needs from the JAX package), with the same output: the
reference's `get_obj_size`, `loading_bar` and `waiting_animation`.
"""

from __future__ import annotations

import gc
import sys
import threading
import types
from typing import Optional


def loading_bar(current: int, total: int, width: int = 20, fill: str = "=") -> str:
    """A textual progress bar like `[=====>    ]`."""
    if total <= 0:
        return "[" + " " * width + "]"
    done = int(width * min(current, total) / total)
    head = ">" if 0 < done < width else ""
    return "[" + fill * max(done - len(head), 0) + head + " " * (width - done) + "]"


class waiting_animation:
    """Context manager printing a spinner on a daemon thread while a slow
    host-side step runs; silent when the stream is not a terminal.

    with waiting_animation("converting"):
        convert(...)
    """

    FRAMES = "|/-\\"

    def __init__(self, message: str = "working", stream=None, interval: float = 0.2):
        self.message = message
        self.stream = stream or sys.stderr
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _spin(self):
        i = 0
        while not self._stop.is_set():
            self.stream.write(f"\r{self.message} {self.FRAMES[i % len(self.FRAMES)]}")
            self.stream.flush()
            i += 1
            self._stop.wait(self.interval)
        self.stream.write("\r" + " " * (len(self.message) + 2) + "\r")
        self.stream.flush()

    def __enter__(self):
        if self.stream.isatty():  # no spinner in logs and pipes
            self._thread = threading.Thread(target=self._spin, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return False


def get_obj_size(obj) -> int:
    """Deep in-memory size of a Python object graph in bytes: a
    breadth-first walk over `gc` referents, skipping types, modules and
    functions."""
    seen = set()
    size = 0
    frontier = [obj]
    while frontier:
        nxt = []
        for o in frontier:
            if id(o) in seen or isinstance(o, (type, types.ModuleType, types.FunctionType)):
                continue
            seen.add(id(o))
            size += sys.getsizeof(o)
            nxt.append(o)
        frontier = [r for r in gc.get_referents(*nxt) if id(r) not in seen] if nxt else []
    return size
