"""Memory monitor: host RSS and GPU memory of a command while it runs.

Port of `mdi_llm_tpu/cli/mem_monitor.py`.  `main` starts the command,
samples its process tree every `--interval` seconds and writes a CSV
(`time_s,rss_bytes,gpu_bytes,card_bytes`, optionally a plot):

- RSS: the tree's resident bytes, read from `/proc` (no extra package);
- GPU memory: the bytes the tree's processes hold on the cards, from
  `nvidia-smi --query-compute-apps=pid,used_memory` (nothing to
  install).  Where no card answers the column says `absent`; where the
  card answers but no process of the tree is listed it says `none` (a
  container whose processes nvidia-smi reports under other pids, one
  host pid for all, lists none of them).  It never writes a zero it did
  not read;
- card memory: the memory in use on all cards
  (`nvidia-smi --query-gpu=memory.used`), every process's together, or
  `absent`.

The summary line on stderr gives the peaks.  `sample_rss` is the
in-process sampler behind `cli.serve --sample-rss` (needs `psutil`).

    python -m mdi_llm_tpu_torch.cli.mem_monitor -o mem.csv -- \
        python -m mdi_llm_tpu_torch.cli.sample --model tiny-llama-1.1b --n-tokens 50
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ABSENT, NONE = "absent", "none"


def sample_rss(pid: int = None) -> int:
    """Resident-set bytes of a process TREE (pid + recursive children);
    defaults to the calling process.  Needs `psutil`: without it the
    import raises, and the observer turns the gauge off with one warning."""
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


def tree_pids(pid: int) -> List[int]:
    """`pid` and its descendants, from the parent ids in `/proc/*/stat`."""
    children: Dict[int, List[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except OSError:
            continue
        # the command name may hold spaces: the fields after its ')' are fixed
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        todo.extend(children.get(p, []))
    return out


def rss_bytes(pids: List[int]) -> int:
    """Summed resident bytes of `pids` (`/proc/<pid>/statm`)."""
    page = os.sysconf("SC_PAGE_SIZE")
    total = 0
    for p in pids:
        try:
            total += int(Path(f"/proc/{p}/statm").read_text().split()[1]) * page
        except (OSError, IndexError, ValueError):
            pass
    return total


def _smi(query: str) -> Optional[List[List[str]]]:
    """nvidia-smi's csv rows for one query, or None when no card answers."""
    try:
        out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [[f.strip() for f in line.split(",")] for line in out.stdout.strip().splitlines()]


def gpu_apps() -> Optional[Dict[int, int]]:
    """{pid: bytes} of every compute process nvidia-smi lists, or None
    when no card answers."""
    rows = _smi("--query-compute-apps=pid,used_memory")
    if rows is None:
        return None
    apps: Dict[int, int] = {}
    for row in rows:
        if len(row) == 2 and row[0].isdigit() and row[1].isdigit():
            apps[int(row[0])] = apps.get(int(row[0]), 0) + int(row[1]) * 2**20
    return apps


def card_used() -> object:
    """Bytes in use on all cards together, or ABSENT."""
    rows = _smi("--query-gpu=memory.used")
    used = [int(r[0]) * 2**20 for r in rows or [] if r and r[0].isdigit()]
    return sum(used) if used else ABSENT


def sample_tree(pid: int) -> Tuple[int, object, object]:
    """(rss bytes, the tree's gpu bytes or ABSENT / NONE, the cards' used
    bytes or ABSENT)."""
    pids = tree_pids(pid)
    apps = gpu_apps()
    if apps is None:
        return rss_bytes(pids), ABSENT, ABSENT
    held = [apps[p] for p in pids if p in apps]
    return rss_bytes(pids), sum(held) if held else NONE, card_used()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--out", type=Path, default=Path("logs/mem_monitor.csv"))
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="command to run (after --)")
    args = ap.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        raise SystemExit("no command given; usage: mem_monitor -o out.csv -- <cmd> ...")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd)
    rows = []
    t0 = time.perf_counter()
    try:
        while proc.poll() is None:
            rows.append((time.perf_counter() - t0, *sample_tree(proc.pid)))
            time.sleep(args.interval)
    except KeyboardInterrupt:
        proc.terminate()
    proc.wait()
    with args.out.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["time_s", "rss_bytes", "gpu_bytes", "card_bytes"])
        w.writerows(rows)

    def peak(col):
        vals = [r[col] for r in rows if isinstance(r[col], int)]
        return f"{max(vals)} bytes" if vals else (rows[-1][col] if rows else ABSENT)

    print(f"mem_monitor: {len(rows)} samples -> {args.out}; peak rss "
          f"{max((r[1] for r in rows), default=0)} bytes, peak gpu {peak(2)}, "
          f"peak card {peak(3)}", file=sys.stderr)
    gpu = [r[2] for r in rows if isinstance(r[2], int)]

    if args.plot and rows:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot([r[0] for r in rows], [r[1] / 2**20 for r in rows], label="RSS")
        if gpu:
            ax.plot([r[0] for r in rows if isinstance(r[2], int)],
                    [r[2] / 2**20 for r in rows if isinstance(r[2], int)], label="GPU")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("MiB")
        ax.legend()
        fig.savefig(args.out.with_suffix(".png"), dpi=120)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
