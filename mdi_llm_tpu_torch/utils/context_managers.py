"""Loop guards: turn Ctrl-C inside host-driven decode loops into a clean
stop with partial results.

Copy of `mdi_llm_tpu/utils/context_managers.py` (which imports no JAX):
on an interrupt the loop stops issuing device work and hands back what it
generated so far.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

log = logging.getLogger("mdi_llm_tpu_torch")


class LoopInterrupted(Exception):
    """Raised internally when a guarded loop should stop early."""


class catch_loop_errors:
    """Context manager guarding a host-driven generation loop.

    with catch_loop_errors(on_stop=cleanup) as guard:
        while ...:
            step()
    # guard.interrupted is True if the loop ended on Ctrl-C

    KeyboardInterrupt is swallowed (the loop body exits through the
    exception leaving the `with` body) so callers can return partial
    output; other exceptions run `on_stop` then propagate.
    """

    def __init__(self, on_stop: Optional[Callable[[], None]] = None):
        self.on_stop = on_stop
        self.interrupted = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            return False
        if self.on_stop is not None:
            try:
                self.on_stop()
            except Exception:  # cleanup must not mask the original error
                log.exception("loop cleanup failed")
        if exc_type in (KeyboardInterrupt, LoopInterrupted):
            self.interrupted = True
            log.warning("generation interrupted — returning partial results")
            return True
        return False
