"""The port's serve CLI, its device rule and its import boundary.

- `python -m mdi_llm_tpu_torch.cli.serve --device cpu ...` serves a
  synthetic trace and prints the JSON stats line on stderr, over an fp,
  int8 or float8 pool and with speculative serving and a draft model;
- without `--device cpu` on a machine with no GPU it raises, and does not
  fall back to the CPU;
- every flag of a feature the port does not carry is refused;
- no module of the port, and not `chip_smoke.py`, imports jax, ml_dtypes
  or the JAX package (an AST scan), and importing the serve CLI leaves
  jax out of `sys.modules`.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mdi_llm_tpu_torch.cli import serve as cli

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CPU_RUN = ["--model", "pythia-14m", "--synthetic", "3", "--max-batch", "2",
           "--n-tokens", "8", "--sequence-length", "128", "--block-size", "8"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "mdi_llm_tpu")


def _run(args):
    return subprocess.run(
        [sys.executable, "-m", "mdi_llm_tpu_torch.cli.serve", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)),
    )


def test_cli_serves_on_cpu_and_prints_stats_line():
    proc = _run(["--device", "cpu", *CPU_RUN])
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stderr.strip().splitlines()[-1])
    assert line["requests"] == 3
    assert line["tokens_generated"] > 0 and line["tokens_per_s"] > 0
    assert "kv_block_utilization_mean" in line
    assert line["device"] == {"type": "cpu", "kind": "cpu"}
    assert proc.stdout.count("--- syn") == 3


def test_cli_raises_without_a_gpu_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    proc = _run(CPU_RUN)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "tokens_generated" not in proc.stderr


@pytest.mark.parametrize("flags,check", [
    (["--kv-dtype", "int8"], {"kv_dtype": "int8"}),
    (["--kv-dtype", "float8"], {"kv_dtype": "float8_e4m3fn"}),
    (["--n-tokens", "12", "--spec-k", "2", "--draft-model", "pythia-14m"], {"kv_dtype": "bfloat16"}),
], ids=["int8", "float8", "spec-draft"])
def test_cli_serves_narrow_pools_and_spec_on_cpu(flags, check):
    proc = _run(["--device", "cpu", *CPU_RUN, *flags])
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stderr.strip().splitlines()[-1])
    assert line["requests"] == 3 and line["tokens_generated"] > 0
    assert {k: line[k] for k in check} == check
    if "--spec-k" in flags:
        assert line["spec_drafted_model"] > 0 and line["draft_forward_calls"] > 0
    else:
        assert line["draft_forward_calls"] == 0


@pytest.mark.parametrize("flags", [
    ["--host-pool-mib", "64"],
    ["--tp", "2"], ["--pp", "2"], ["--quantize", "int8"], ["--ckpt", "some/dir"],
    ["--metrics-out", "m.json"], ["--prom-out", "m.txt"], ["--trace-out", "t.json"],
    ["--xprof-steps", "4"], ["--sample-rss", "0.5"],
], ids=lambda f: f[0])
def test_cli_refuses_unported_flags(flags):
    args = cli.build_parser().parse_args(["--device", "cpu", *CPU_RUN, *flags])
    with pytest.raises(SystemExit, match="not ported"):
        cli.serve(args)


def test_cli_refuses_unported_kv_dtype():
    """A dtype no pool stores is refused by the parser; int8 (the
    quantized paged pool) is a serving dtype only, refused for the dense
    cache of the sample CLI."""
    from mdi_llm_tpu_torch.cli import sample

    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--kv-dtype", "int4"])
    assert cli.build_parser().parse_args(["--kv-dtype", "int8"]).kv_dtype == "int8"
    with pytest.raises(SystemExit):
        sample.build_parser().parse_args(["--kv-dtype", "int8"])
    assert sample.build_parser().parse_args(["--kv-dtype", "float8"]).kv_dtype == "float8"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "mdi_llm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, mdi_llm_tpu_torch.cli.serve, mdi_llm_tpu_torch.serving.engine, "
            "mdi_llm_tpu_torch.cli.train, mdi_llm_tpu_torch.cli.profile_train; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'mdi_llm_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
