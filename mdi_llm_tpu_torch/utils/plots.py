"""Tokens-vs-time capture: CSV writers and the plot.

Copy of `mdi_llm_tpu/utils/plots.py` (which imports no JAX): the same CSV
file naming (`tokens_time_samples_<k>nodes_<model>_<n>samples.csv`) and
run-stats CSV (`timestamp,n_samples,n_layers,context_size,gen_time`);
matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Sequence, Tuple, Union

PathLike = Union[str, Path]


def tok_time_csv_path(
    logs_dir: PathLike, n_nodes: int, model_name: str, n_samples: int
) -> Path:
    safe = model_name.replace("/", "_")
    return Path(logs_dir) / f"tokens_time_samples_{n_nodes}nodes_{safe}_{n_samples}samples.csv"


def write_tok_time_csv(path: PathLike, tok_time: Sequence[Tuple[int, float]]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tokens", "time"])
        for n, t in tok_time:
            w.writerow([n, f"{t:.6f}"])
    return path


def append_run_stats(
    path: PathLike, n_samples: int, n_layers: int, context_size: int, gen_time: float
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    new = not path.exists()
    with path.open("a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["timestamp", "n_samples", "n_layers", "context_size", "gen_time"])
        w.writerow(
            [time.strftime("%Y-%m-%d %H:%M:%S"), n_samples, n_layers, context_size, f"{gen_time:.4f}"]
        )
    return path


def plot_tokens_per_time(
    tok_time: Sequence[Tuple[int, float]], out_png: PathLike, label: str = ""
) -> Path:
    """Tokens generated against seconds elapsed, as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_png = Path(out_png)
    out_png.parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    times = [t for _, t in tok_time]
    toks = [n for n, _ in tok_time]
    ax.plot(times, toks, marker=".", markersize=2, label=label or None)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("tokens generated")
    ax.grid(True, alpha=0.3)
    if label:
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
