"""Secondary-node entry point of the port's multi-process recurrent pipeline.

Port of `mdi_llm_tpu/cli/secondary.py` (the reference's `secondary.py`,
`--nodes-config CONFIG IDX`): joins the `torch.distributed` job as
process IDX + 1, receives the run spec from the starter (or its abort,
and then exits non-zero), loads the model itself (`--ckpt`, or random
weights from its own `--seed`: a mismatch with the starter's weights is
refused on every process), runs its contiguous group of stages of the
ring and returns the starter's outputs.  The run's flags (stages,
samples per slot, chunk, tp ranks per stage, overlap, dtype) come from
the starter's spec; they are accepted here for launch-script symmetry.  With `--debug` it
logs into `<logs-dir>/logs_secondary<IDX>.log`.

    python -m mdi_llm_tpu_torch.cli.secondary --model tiny-llama-1.1b --nodes-config cfg.json 0
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mdi_llm_tpu_torch.cli.starter import add_node_args, run_node
from mdi_llm_tpu_torch.parallel.nodes import parse_nodes_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    add_node_args(ap)
    ap.add_argument("--nodes-config", nargs=2, metavar=("CONFIG", "IDX"), required=True,
                    help="topology JSON and this node's secondary index (0-based)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    config_path, idx = Path(args.nodes_config[0]), int(args.nodes_config[1])
    nodes_cfg = parse_nodes_config(config_path)
    if not 0 <= idx < len(nodes_cfg.secondary):
        raise SystemExit(
            f"secondary index {idx} out of range (config lists "
            f"{len(nodes_cfg.secondary)} secondaries)"
        )
    args.nodes_config = config_path
    outs, _, _, _ = run_node(args, nodes_cfg, process_id=idx + 1)
    return outs


if __name__ == "__main__":
    main()
