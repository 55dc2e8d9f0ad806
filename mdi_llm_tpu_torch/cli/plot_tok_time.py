"""Overlay tokens-vs-time CSVs across node counts for one model.

Port of `mdi_llm_tpu/cli/plot_tok_time.py`: finds
`<logs-dir>/tokens_time_samples_<k>nodes_<model>_<n>samples.csv` (written
by `cli.sample --plots/--time-run` and `cli.starter`) and overlays the
curves into one PNG, whose path it prints.

    python -m mdi_llm_tpu_torch.cli.plot_tok_time --model tiny-llama-1.1b --logs-dir logs
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mdi_llm_tpu_torch.utils.plots import plot_overlay


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True)
    ap.add_argument("--n-samples", type=int, default=None)
    ap.add_argument("--logs-dir", type=Path, default=Path("logs"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    pat = f"tokens_time_samples_*nodes_{args.model.replace('/', '_')}_*samples.csv"
    paths = sorted(args.logs_dir.glob(pat))
    if args.n_samples is not None:
        paths = [p for p in paths if p.stem.endswith(f"_{args.n_samples}samples")]
    if not paths:
        raise SystemExit(f"no CSVs matching {pat} under {args.logs_dir}")
    out = args.out or args.logs_dir / f"tok_time_overlay_{args.model.replace('/', '_')}.png"
    plot_overlay(paths, out)
    print(out)
    return out


if __name__ == "__main__":
    main()
