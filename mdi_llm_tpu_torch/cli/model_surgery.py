"""Checkpoint surgery: repair or patch saved checkpoints of the port in
place.

Port of `mdi_llm_tpu/cli/model_surgery.py`.  Operations:

- `--set key=value`: patch a `model_config.yaml` field (e.g. a wrong
  `block_size`, a missing `name`); values parse as YAML scalars (the
  config module's own parser, `config._yaml_value`).
- `--rename old=new`: rename a top-level parameter entry.
- `--drop key`: delete a top-level parameter entry (e.g. a stale optimizer
  moment accidentally saved into the model tree).

    python -m mdi_llm_tpu_torch.cli.model_surgery --ckpt <dir> --set block_size=2048
    python -m mdi_llm_tpu_torch.cli.model_surgery --ckpt <dir> --drop lm_head --dry-run
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", type=Path, required=True)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--rename", action="append", default=[], metavar="OLD=NEW")
    ap.add_argument("--drop", action="append", default=[], metavar="KEY")
    ap.add_argument("--dry-run", action="store_true")
    return ap


def main(argv=None) -> list:
    from mdi_llm_tpu_torch.config import Config, _yaml_value
    from mdi_llm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    args = build_parser().parse_args(argv)
    cfg, params = load_checkpoint(args.ckpt)
    conf = cfg.asdict()
    changed = []

    for item in args.set:
        k, _, v = item.partition("=")
        if k not in conf:
            raise SystemExit(f"unknown config field {k!r}")
        old = conf[k]
        conf[k] = _yaml_value(v.strip())
        changed.append(f"config {k}: {old!r} -> {conf[k]!r}")
    for item in args.rename:
        old, _, new = item.partition("=")
        if old not in params:
            raise SystemExit(f"no parameter entry {old!r} (have {sorted(params)})")
        params[new] = params.pop(old)
        changed.append(f"param rename {old} -> {new}")
    for k in args.drop:
        if k not in params:
            raise SystemExit(f"no parameter entry {k!r} (have {sorted(params)})")
        params.pop(k)
        changed.append(f"param drop {k}")

    for line in changed or ["(no changes requested)"]:
        print(line)
    if args.dry_run or not changed:
        return changed
    # reconstruct through __post_init__ so invariants re-validate
    new_cfg = Config(**{k: v for k, v in conf.items() if k in Config.__dataclass_fields__})
    save_checkpoint(params, new_cfg, args.ckpt)
    print(f"rewrote {args.ckpt}")
    return changed


if __name__ == "__main__":
    main()
