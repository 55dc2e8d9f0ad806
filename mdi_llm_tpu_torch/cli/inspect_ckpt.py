"""Checkpoint inspector: dump config, parameter keys/shapes/dtypes and
sizes.

Port of `mdi_llm_tpu/cli/inspect_ckpt.py` for checkpoints of the port
(`params.pt`).  `--n-stages S` adds the stage view: the layers, bytes
and extra leaves of each of S pipeline stages (`parallel/partition.py`).

    python -m mdi_llm_tpu_torch.cli.inspect_ckpt --ckpt checkpoints/custom/NanoLlama
    python -m mdi_llm_tpu_torch.cli.inspect_ckpt --ckpt checkpoints/custom/NanoLlama --n-stages 2
"""

from __future__ import annotations

import argparse
from pathlib import Path



def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", type=Path, required=True)
    ap.add_argument("--keys-only", action="store_true")
    ap.add_argument("--n-stages", type=int, default=0,
                    help="also show the split over this many pipeline stages")
    return ap


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def main(argv=None) -> int:
    from mdi_llm_tpu_torch.utils.checkpoint import load_checkpoint

    args = build_parser().parse_args(argv)
    cfg, params = load_checkpoint(args.ckpt)
    leaves = list(_flatten(params))
    n_params = sum(t.numel() for _, t in leaves)
    print(f"# {cfg.name}: n_layer={cfg.n_layer} n_head={cfg.n_head} "
          f"n_embd={cfg.n_embd} n_query_groups={cfg.n_query_groups} "
          f"block_size={cfg.block_size} padded_vocab={cfg.padded_vocab_size}")
    print(f"# params: {n_params:,} ({n_params / 1e6:.1f}M)")
    total = 0
    for name, t in leaves:
        total += t.numel() * t.element_size()
        if args.keys_only:
            print(name)
        else:
            print(f"{name:60s} {str(t.dtype).replace('torch.', ''):10s} {tuple(t.shape)}")
    print(f"# total bytes: {total:,} ({total / 2**20:.1f} MiB)")
    if args.n_stages > 1:
        from mdi_llm_tpu_torch.parallel.partition import split_params, stage_layers

        counts = stage_layers(cfg.n_layer, args.n_stages)
        print(f"\n# stage split over {args.n_stages} stages: layers {counts}")
        for i, st in enumerate(split_params(cfg, params, args.n_stages)):
            sz = sum(t.numel() * t.element_size() for _, t in _flatten(st))
            keys = [k for k in st if k != "blocks"]
            print(f"  stage {i}: {counts[i]} layers, {sz / 2**20:.1f} MiB, extras={keys}")
    return total


if __name__ == "__main__":
    main()
