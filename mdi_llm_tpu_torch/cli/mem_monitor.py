"""Host RSS sampling for the serving observer (`cli.serve --sample-rss`).

The port's copy of `sample_rss` from `mdi_llm_tpu/cli/mem_monitor.py`.
The rest of that CLI (the standalone monitor that wraps a command and
samples device memory beside RSS) is ROADMAP item 17.
"""

from __future__ import annotations


def sample_rss(pid: int = None) -> int:
    """Resident-set bytes of a process TREE (pid + recursive children);
    defaults to the calling process.  Needs `psutil`: without it the
    import raises, and the observer turns the gauge off with one warning."""
    import os

    import psutil

    try:
        p = psutil.Process(os.getpid() if pid is None else pid)
        total = p.memory_info().rss
        for child in p.children(recursive=True):
            try:
                total += child.memory_info().rss
            except psutil.NoSuchProcess:
                pass
        return total
    except psutil.NoSuchProcess:
        return 0
