"""The port's CLIs, their device rule and the port's import boundary.

- `python -m mdi_llm_tpu_torch.cli.serve --device cpu ...` serves a
  synthetic trace and prints the JSON stats line on stderr, over an fp,
  int8 or float8 pool and with speculative serving and a draft model;
- without `--device cpu` on a machine with no GPU it raises, and does not
  fall back to the CPU;
- every flag of a feature the port does not carry is refused;
  `--host-pool-mib`, `--quantize`, `--tp` and `--pp` are ported and serve (`--pp
  2` prints the `--pp 1` streams, and its stats line carries the ring's
  topology and `pipeline` block; `cli.server` keeps refusing `--pp`); the
  observability flags are ported: `--metrics-out`, `--prom-out`,
  `--trace-out`, `--xprof-steps` and `--sample-rss` each do their work;
- no module of the port, and not `chip_smoke.py`, imports jax, ml_dtypes,
  orbax, yaml or the JAX package, and only the tokenizer imports
  `tokenizers`, the hub download `huggingface_hub` and `cli.prepare_owt`
  `datasets` (an AST scan); importing the CLIs leaves jax out of
  `sys.modules`;
- the checkpoint CLIs on a converted HF snapshot are
  `tests/test_torch_cli_ckpt.py`'s.
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
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "orbax", "yaml", "mdi_llm_tpu")
# the HF libraries: only the tokenizer's backend, the hub download and
# the dataset CLI import one
HF_LIBS = {"safetensors": (), "transformers": (),
           "tokenizers": ("mdi_llm_tpu_torch/utils/tokenizer.py",),
           "huggingface_hub": ("mdi_llm_tpu_torch/utils/download.py",),
           "datasets": ("mdi_llm_tpu_torch/cli/prepare_owt.py",)}


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
    # the CPU is off the peak table: MFU/MBU are null, the reports are there
    assert {k: line["device"][k] for k in ("type", "kind", "device_kind", "mfu", "mbu")} == {
        "type": "cpu", "kind": "cpu", "device_kind": None, "mfu": None, "mbu": None}
    assert line["device"]["executables"] == 2 and line["latency"]["ttft_s"]["count"] == 3
    assert proc.stdout.count("--- syn") == 3


# the port's own stats-line keys: forward counts and the step graphs at
# the top level; the device's type, its peak-table key and the step
# reports in `device`
# `n_chips` is the JAX line's tp x pp count, which the JAX line prints as
# `devices`; the port's `devices` counts the distinct devices
PORT_ONLY_KEYS = {"forward_calls", "draft_forward_calls", "graph_captures",
                  "graph_replays", "capture_s", "n_chips", "detail"}
PORT_ONLY_DEVICE_KEYS = {"type", "device_kind", "reports"}


@pytest.mark.parametrize("flags", [[], ["--no-device-obs"]], ids=["device-obs", "no-device-obs"])
def test_stats_line_has_the_jax_clis_keys(flags):
    """The port's stats line carries every key of the JAX serve CLI's, and
    only its own named extras beside them; so do its `latency` and
    `device` blocks (the JAX line has no `device` with --no-device-obs,
    the port's keeps the card's type and name)."""
    # the JAX serve runs beside the port's
    jax_proc = subprocess.Popen(
        [sys.executable, "-m", "mdi_llm_tpu.cli.serve", "--device", "cpu", *CPU_RUN, *flags],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT)))
    try:
        proc = _run(["--device", "cpu", *CPU_RUN, *flags])
        _out, jax_err = jax_proc.communicate(timeout=300)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, jax_err
    assert proc.returncode == 0, proc.stderr
    jline = json.loads(jax_err.strip().splitlines()[-1])
    line = json.loads(proc.stderr.strip().splitlines()[-1])
    extra = PORT_ONLY_KEYS | ({"device"} if flags else set())
    assert set(line) - extra == set(jline)
    assert extra <= set(line)
    assert {k: set(v) for k, v in line["latency"].items()} == {
        k: set(v) for k, v in jline["latency"].items()}
    if not flags:
        assert set(line["device"]) - PORT_ONLY_DEVICE_KEYS == set(jline["device"])
    else:
        assert set(line["device"]) == {"type", "kind"}


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


@pytest.mark.parametrize("flags,match", [
    # the host tier and weight quantization are ported (match None): the
    # run serves every request, with the tier's stats keys and quantized
    # weights
    (["--host-pool-mib", "64"], None),
    (["--tp", "2"], None), (["--pp", "2"], None),
    (["--quantize", "int8"], None),
    # --ckpt is ported: a directory that is not there is refused by name
    (["--ckpt", "some/dir"], "some/dir: no such checkpoint directory"),
], ids=["--host-pool-mib", "--tp", "--pp", "--quantize", "--ckpt"])
def test_cli_refuses_unported_flags(flags, match):
    args = cli.build_parser().parse_args(["--device", "cpu", *CPU_RUN, *flags])
    if match is None:
        _trace, _results, stats, engine, _tok = cli.serve(args)
        assert stats.requests_finished == 3
        if "--quantize" in flags:
            assert engine.gen.quantized
        elif "--pp" in flags:
            assert engine.n_stages == 2 and engine.stage_layer_runs > 0
        elif "--tp" in flags:
            assert engine.gen.tp == 2 and sorted(engine._kv) == [0, 1]
        else:
            assert engine.host_tier.store.num_slots > 0
            assert {"swaps_out", "swaps_in", "prefix_hits_host"} <= set(stats.to_dict())
        return
    with pytest.raises(SystemExit, match=match):
        cli.serve(args)


def test_cli_pp_serves_the_pp1_streams_with_the_ring_in_its_stats_line(capsys):
    """`--pp 2` (pythia-14m's 6 layers as [2, 4], both stages on the CPU)
    prints the `--pp 1` streams (float32, so the ring's other batch shapes
    round alike); its stats line has the JAX CLI's `pp`, `devices`,
    `tokens_per_s_per_chip` and `pipeline`; without `--device cpu` it
    raises here, and `cli.server` refuses `--pp`."""
    from mdi_llm_tpu_torch.cli import server as server_cli

    run = ["--device", "cpu", *CPU_RUN, "--dtype", "float32"]
    lines, printed = {}, {}
    for pp in (1, 2):
        lines[pp] = cli.main([*run, "--pp", str(pp)])
        out, err = capsys.readouterr()
        assert json.loads(err.strip().splitlines()[-1]) == lines[pp]
        printed[pp] = out
    assert printed[2] == printed[1] and printed[1].count("--- syn") == 3
    line = lines[2]
    assert (line["pp"], line["devices"], line["requests"]) == (2, 1, 3)
    assert line["tokens_per_s_per_chip"] == round(line["tokens_per_s"], 2)
    assert line["pipeline"] == {"stages": 2, "lanes": 2, "stage_layers": [2, 4],
                                "bubble_fraction": 0.0, "stage_occupancy": [1.0, 1.0]}
    assert "pipeline" not in lines[1] and lines[1]["pp"] == 1
    assert line["host_syncs"] == lines[1]["host_syncs"]
    with pytest.raises(SystemExit, match="--pp is not ported"):
        server_cli.main([*run, "--pp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
            cli.serve(cli.build_parser().parse_args([*CPU_RUN, "--pp", "2"]))


@pytest.mark.parametrize("flag", ["--metrics-out", "--prom-out", "--trace-out",
                                  "--xprof-steps", "--sample-rss"])
def test_cli_observability_flags_do_their_work(flag, tmp_path, capsys):
    """Each observability flag, refused before the port carried it, now
    writes its file or its gauge (the serve CLI in-process, on the CPU)."""
    extra = {"--metrics-out": [flag, str(tmp_path / "m.json")],
             "--prom-out": [flag, str(tmp_path / "m.txt")],
             "--trace-out": [flag, str(tmp_path / "t.json")],
             "--xprof-steps": [flag, "2", "--xprof-skip", "1", "--xprof-dir", str(tmp_path)],
             "--sample-rss": [flag, "0", "--metrics-out", str(tmp_path / "m.json")]}[flag]
    line = cli.main(["--device", "cpu", *CPU_RUN, *extra])
    assert line["requests"] == 3
    if flag == "--metrics-out":
        got = json.loads((tmp_path / "m.json").read_text())
        assert got["metrics"]["counters"]["serving_tokens_generated_total"] == line["tokens_generated"]
        assert got["serving_stats"]["host_syncs"] == line["host_syncs"]
    elif flag == "--prom-out":
        text = (tmp_path / "m.txt").read_text()
        assert f"serving_tokens_generated_total {line['tokens_generated']}\n" in text
    elif flag == "--trace-out":
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        assert {e["name"] for e in events if e.get("ph") == "X" and e["pid"] == 2} >= {
            "mixed", "decode_chunk"}
    elif flag == "--xprof-steps":
        (trace,) = tmp_path.glob("steps_*.json")
        assert json.loads(trace.read_text())["traceEvents"]
        assert "profiler window steps 2-3" in capsys.readouterr().err
    else:
        gauges = json.loads((tmp_path / "m.json").read_text())["metrics"]["gauges"]
        assert gauges["host_rss_bytes"] > 0


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


def test_cli_scan_unroll_parses_as_the_jax_clis_and_the_generator_takes_only_1():
    """`--scan-unroll` parses as the JAX CLI's (int, default 1): 1 serves,
    and any other factor reaches the Generator, which refuses it in its
    own words (the port's layers are a Python loop, not a scan)."""
    assert cli.build_parser().parse_args([]).scan_unroll == 1
    args = cli.build_parser().parse_args(["--device", "cpu", *CPU_RUN, "--scan-unroll", "1"])
    _trace, _results, stats, _engine, _tok = cli.serve(args)
    assert stats.requests_finished == 3
    args = cli.build_parser().parse_args(["--device", "cpu", *CPU_RUN, "--scan-unroll", "2"])
    with pytest.raises(NotImplementedError,
                       match=r"Generator\(scan_unroll=2: the layers run as a Python loop\)"):
        cli.serve(args)


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
    hf = [
        (str(f.relative_to(ROOT)), name)
        for f in files for name in _imports(f)
        if str(f.relative_to(ROOT)) not in HF_LIBS.get(name.split(".")[0], (str(f.relative_to(ROOT)),))
    ]
    assert hf == []


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, mdi_llm_tpu_torch.cli.serve, mdi_llm_tpu_torch.serving.engine, "
            "mdi_llm_tpu_torch.cli.train, mdi_llm_tpu_torch.cli.profile_train, "
            "mdi_llm_tpu_torch.cli.chat, mdi_llm_tpu_torch.cli.prepare_model, "
            "mdi_llm_tpu_torch.cli.convert_to_hf, mdi_llm_tpu_torch.cli.inspect_ckpt, "
            "mdi_llm_tpu_torch.cli.model_surgery, mdi_llm_tpu_torch.cli.server, "
            "mdi_llm_tpu_torch.obs, mdi_llm_tpu_torch.obs.device, mdi_llm_tpu_torch.server, "
            "mdi_llm_tpu_torch.server.http, mdi_llm_tpu_torch.utils.profiling, "
            "mdi_llm_tpu_torch.serving.host_tier, mdi_llm_tpu_torch.ops.quant, "
            "mdi_llm_tpu_torch.serving.pipeline, mdi_llm_tpu_torch.cli.download_weights, "
            "mdi_llm_tpu_torch.cli.prepare_owt, mdi_llm_tpu_torch.utils.download; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'mdi_llm_tpu' for m in sys.modules); "
            "assert not {'huggingface_hub', 'datasets'} & set(sys.modules), 'HF imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# --ckpt, text prompts, chat and --init hf against the JAX package
# ---------------------------------------------------------------------------
