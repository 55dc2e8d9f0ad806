"""The port's node layer and pipeline CLIs, on the CPU.

- Both node schemas, and every config under `examples/node_configs/` and
  `examples/mesh_configs/`, parse to what the JAX package parses;
- `broadcast_run_spec` round-trips a spec and refuses one past
  `RUN_SPEC_BYTES`; the backend rule (NCCL only when every process has a
  card of its own) and the per-process device;
- two processes (`cli.starter` + `cli.secondary`) over gloo on localhost,
  each under its own subprocess time limit: the streams of the
  one-process ring and of one device, with 2 stages and with 4 (two per
  process, M = 2, refills); a mismatched `--seed` ends both processes
  with a non-zero exit, and so does a starter whose plan audit refuses the
  ring (`--hbm-gb` below the weights) through the abort sentinel;
- the CLI flags this slice ported, on `--device cpu`: `cli.sample
  --pipeline-stages` (with `--samples-per-slot`, `--overlap-chunks`,
  `--profile-dir`), `cli.chat --pipeline-stages` against the JAX ring's
  chat loop, `cli.starter` with `standalone.json` in one process (the
  tokens/time CSV named by its node count), `cli.prepare_model
  --n-stages` (stage checkpoints and a manifest byte-identical to the JAX
  package's), `cli.inspect_ckpt --n-stages`, `cli.plot_tok_time` and
  `cli.mem_monitor` (its GPU column says `absent` without a card); each
  raises without `--device cpu` on a machine with no GPU, and the starter
  takes the plan audit's flags (`--hbm-gb` refuses a plan over it,
  `--no-preflight` launches it anyway);
- importing the new modules loads no jax.
"""

import io
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.parallel import nodes as jnodes
from mdi_llm_tpu.parallel import partition as jpart
from mdi_llm_tpu_torch.cli import chat as chat_cli
from mdi_llm_tpu_torch.cli import inspect_ckpt, plot_tok_time, prepare_model
from mdi_llm_tpu_torch.cli import mem_monitor
from mdi_llm_tpu_torch.cli import sample as sample_cli
from mdi_llm_tpu_torch.cli import starter as starter_cli
from mdi_llm_tpu_torch.parallel import nodes as tnodes
from mdi_llm_tpu_torch.utils import checkpoint as ck
from tests.test_torch_cli_ckpt import CKPT_RUN, converted, hf_snapshot, jax_model  # noqa: F401

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples" / "node_configs").glob("*.json")) + sorted(
    (ROOT / "examples" / "mesh_configs").glob("*.json"))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
COMMON = ["--model", "pythia-14m", "--device", "cpu", "--greedy", "--n-tokens", "8",
          "--n-samples", "2", "--seed", "10137"]
PROC_TIMEOUT = 180


def _write(tmp_path, payload, name="nodes.json"):
    p = tmp_path / name
    p.write_text(json.dumps(payload))
    return p


def _fields(cfg):
    return (cfg.n_nodes, cfg.coordinator, cfg.pipeline_stages, cfg.tp_devices,
            [(n.addr, n.comm_port, n.device) for n in [cfg.starter, *cfg.secondary]])


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_example_configs_parse_as_in_jax(path):
    assert _fields(tnodes.parse_nodes_config(path)) == _fields(jnodes.parse_nodes_config(path))


def test_parse_reference_schema(tmp_path):
    p = _write(tmp_path, {"nodes": {
        "starter": {"addr": "10.0.0.1", "communication": {"port": 8088},
                    "inference": {"port_in": 8090, "port_out": 8091}, "device": "tpu"},
        "secondary": [
            {"addr": "10.0.0.2", "communication": {"starter_addr": "10.0.0.1", "port": 8089}},
            {"addr": "10.0.0.3", "communication": {"port": 8090}},
        ]}})
    cfg = tnodes.parse_nodes_config(p)
    assert (cfg.n_nodes, cfg.coordinator, cfg.starter.device, cfg.secondary[1].addr) == (
        3, "10.0.0.1:8088", "tpu", "10.0.0.3")
    assert _fields(cfg) == _fields(jnodes.parse_nodes_config(p))


@pytest.mark.parametrize("payload", [
    {"nodes": {"starter": {"addr": "127.0.0.1", "communication": {"port": 1}}, "secondary": []}},
    {"coordinator": "host0:8476", "num_processes": 2, "pipeline_stages": 16},
    {"coordinator": "h:1", "num_processes": 3, "tp_devices": 2},
], ids=["standalone", "mesh", "mesh-tp"])
def test_parse_schemas_match_jax(tmp_path, payload):
    p = _write(tmp_path, payload)
    assert _fields(tnodes.parse_nodes_config(p)) == _fields(jnodes.parse_nodes_config(p))


def test_bad_coordinator_is_refused(tmp_path):
    p = _write(tmp_path, {"coordinator": "nohostport"})
    with pytest.raises(SystemExit, match="host:port"):
        tnodes.parse_nodes_config(p)


def test_run_spec_round_trips_and_refuses_an_oversized_one():
    spec = dict(prompt_ids=[[1, 2, 3], [4]], n_tokens=8, stop_seqs=((5, 6),), seed=3)
    assert tnodes.broadcast_run_spec(spec, None) == spec
    buf = tnodes.pack_run_spec(spec)
    assert buf.shape == (tnodes.RUN_SPEC_BYTES,) == (jnodes.RUN_SPEC_BYTES,)
    assert tnodes.unpack_run_spec(buf) == spec
    with pytest.raises(ValueError, match="run spec too large"):
        tnodes.broadcast_run_spec({"prompt_ids": [list(range(300_000))]}, None)
    abort = {"abort": "refused"}
    assert tnodes.broadcast_run_spec(abort, None) == abort


def test_backend_follows_the_placement():
    assert tnodes.choose_backend(["h|cuda:0", "h|cuda:1"]) == "nccl"
    assert tnodes.choose_backend(["a|cuda:0", "b|cuda:0"]) == "nccl"
    assert tnodes.choose_backend(["h|cuda:0", "h|cuda:0"]) == "gloo"  # one shared card
    assert tnodes.choose_backend(["h|cpu", "h|cpu"]) == "gloo"
    assert tnodes.choose_backend(["h|cuda:0", "h|cpu"]) == "gloo"
    assert tnodes.node_device("cpu", 3) == torch.device("cpu")
    assert tnodes.init_distributed(tnodes.NodesConfig(tnodes.NodeInfo("x", 1)), 0) is None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_nodes(tmp_path):
    return _write(tmp_path, {"nodes": {
        "starter": {"addr": "127.0.0.1", "communication": {"port": _free_port()}},
        "secondary": [{"addr": "127.0.0.1", "communication": {"port": _free_port()}}]}})


def _samples(stdout):
    out, grab = [], False
    for line in stdout.splitlines():
        if line.startswith("--- sample"):
            grab = True
        elif grab and line.startswith("["):
            out.append([int(x) for x in re.findall(r"-?\d+", line)])
            grab = False
    return out


def _run_pair(cfg_path, starter_args, secondary_args):
    """The starter and the secondary as two processes, each under its own
    time limit (a hang fails the test); returns both CompletedProcess-like
    (returncode, stdout, stderr)."""
    sec = subprocess.Popen(
        [sys.executable, "-m", "mdi_llm_tpu_torch.cli.secondary", *secondary_args,
         "--nodes-config", str(cfg_path), "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
    try:
        sta = subprocess.run(
            [sys.executable, "-m", "mdi_llm_tpu_torch.cli.starter", *starter_args,
             "--nodes-config", str(cfg_path)],
            capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=PROC_TIMEOUT)
    finally:
        try:
            s_out, s_err = sec.communicate(timeout=PROC_TIMEOUT)
        except subprocess.TimeoutExpired:
            sec.kill()
            s_out, s_err = sec.communicate()
            raise AssertionError("the secondary hung: " + s_err[-2000:])
    return (sta.returncode, sta.stdout, sta.stderr), (sec.returncode, s_out, s_err)


def _sample(args):
    proc = subprocess.run([sys.executable, "-m", "mdi_llm_tpu_torch.cli.sample", *args],
                          capture_output=True, text=True, cwd=ROOT, env=ENV,
                          timeout=PROC_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


@pytest.mark.parametrize("extra", [
    [],
    ["--pipeline-stages", "4", "--samples-per-slot", "2", "--n-samples", "10"],
], ids=["2-stages", "4-stages-M2-refills"])
def test_two_process_ring_matches_one_process_and_one_device(tmp_path, extra):
    run = COMMON + extra
    one_device = _samples(_sample(run).stdout)
    stages = extra[extra.index("--pipeline-stages") + 1] if extra else "2"
    one_process = _samples(_sample(run + ["--pipeline-stages", stages]).stdout)
    (rc, out, err), (src, sout, serr) = _run_pair(_two_nodes(tmp_path), run, run)
    assert rc == 0, err[-2000:]
    assert src == 0, serr[-2000:]
    got = _samples(out)
    assert len(got) == (10 if extra else 2)
    assert got == one_process == one_device
    line = json.loads(next(ln for ln in err.splitlines() if ln.startswith("ring: "))[6:])
    assert line["backend"] == "gloo" and line["hops"] > 0
    assert f"2 node(s) / {stages} stage(s), gloo" in err
    sline = json.loads(next(ln for ln in serr.splitlines() if ln.startswith("ring: "))[6:])
    assert sline["stages"] == ([1] if not extra else [2, 3])


def test_mismatched_seed_ends_both_processes(tmp_path):
    other = [a if a != "10137" else "7" for a in COMMON]
    (rc, _, err), (src, _, serr) = _run_pair(_two_nodes(tmp_path), COMMON, other)
    assert rc != 0 and src != 0
    assert "parameter mismatch" in err and "parameter mismatch" in serr


def test_starter_refusal_ends_the_secondary(tmp_path):
    (rc, _, err), (src, _, serr) = _run_pair(_two_nodes(tmp_path),
                                             COMMON + ["--hbm-gb", "0.00001"], COMMON)
    assert rc != 0 and "preflight refused" in err and "hbm-over-budget" in err
    assert src != 0 and "starter aborted the job" in serr and "hbm-over-budget" in serr


def test_starter_standalone_and_the_tokens_time_files(tmp_path, capsys):
    cfg = ROOT / "examples" / "node_configs" / "standalone.json"
    logs = tmp_path / "logs"
    args = COMMON + ["--pipeline-stages", "2", "--samples-per-slot", "2",
                     "--nodes-config", str(cfg), "--logs-dir", str(logs), "--plots",
                     "--time-run", str(tmp_path / "runs.csv"), "--debug"]
    outs = starter_cli.main(args)
    want = sample_cli.main(COMMON)
    assert outs == want
    assert (logs / "tokens_time_samples_1nodes_pythia-14m_2samples.csv").exists()
    assert (logs / "tokens_time_samples_1nodes_pythia-14m_2samples.png").exists()
    assert (logs / "logs_starter.log").exists()
    assert "1 node(s) / 2 stage(s), one process" in capsys.readouterr().err
    png = plot_tok_time.main(["--model", "pythia-14m", "--logs-dir", str(logs)])
    assert png.exists() and png.name == "tok_time_overlay_pythia-14m.png"
    with pytest.raises(SystemExit, match="no CSVs"):
        plot_tok_time.main(["--model", "other", "--logs-dir", str(logs)])
    import logging

    log = logging.getLogger("mdi_llm_tpu_torch")
    for h in [h for h in log.handlers if isinstance(h, logging.FileHandler)]:
        h.close()
        log.removeHandler(h)


def test_starter_streams_sample_0_from_a_checkpoint(converted, capsys):  # noqa: F811
    """--stream prints sample 0's text as its tokens come around the ring;
    --chunk and --overlap-chunks change the calls, not the tokens."""
    port_dir, _ = converted
    cfg = ROOT / "examples" / "node_configs" / "standalone.json"
    run = ["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN, "--greedy",
           "--n-tokens", "10", "--prompt", "w5 w17 w33", "--nodes-config", str(cfg),
           "--pipeline-stages", "2"]
    outs = starter_cli.main(run + ["--stream", "--chunk", "2", "--overlap-chunks"])
    streamed = capsys.readouterr().out
    assert outs == starter_cli.main(run)
    assert outs == sample_cli.main(["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN,
                                    "--greedy", "--n-tokens", "10", "--prompt", "w5 w17 w33"])
    from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

    reply = Tokenizer(port_dir).decode(np.asarray(outs[0][6:]))
    assert reply and streamed.count(reply) == 2  # streamed live, then the sample print


@pytest.mark.parametrize("flags", [["--no-preflight"], ["--hbm-gb", "16"]])
def test_starter_refuses_the_preflight_flags(flags):
    """The plan audit's flags: a budget below the weights refuses the plan
    before the checkpoint load; with `--no-preflight` that plan runs, and
    under `--hbm-gb 16` the ring runs as without the flag."""
    cfg = ROOT / "examples" / "node_configs" / "standalone.json"
    over = COMMON + ["--nodes-config", str(cfg), "--hbm-gb", "0.00001"]
    with pytest.raises(SystemExit, match="preflight refused"):
        starter_cli.main(over)
    run = over + flags if flags == ["--no-preflight"] else (
        COMMON + ["--nodes-config", str(cfg), *flags])
    assert starter_cli.main(run) == sample_cli.main(COMMON)


@pytest.mark.parametrize("flags", [
    ["--pipeline-stages", "2"],
    ["--pipeline-stages", "2", "--samples-per-slot", "2", "--overlap-chunks", "--chunk", "4"],
], ids=["S2", "S2-M2-overlap"])
def test_sample_cli_pipeline_matches_one_device(flags, tmp_path):
    one = sample_cli.main(COMMON + ["--n-samples", "3"])
    ring = sample_cli.main(COMMON + ["--n-samples", "3", "--profile-dir", str(tmp_path / "p"),
                                     *flags])
    assert ring == one
    assert (tmp_path / "p" / "trace.json").exists()


def test_chat_cli_pipeline_matches_the_jax_rings_chat(converted, monkeypatch, capsys):  # noqa: F811
    from mdi_llm_tpu.parallel.mesh import pipeline_mesh as jmesh
    from mdi_llm_tpu.parallel.pipeline import PipelineEngine as JPipeline
    from mdi_llm_tpu.utils import checkpoint as jck

    port_dir, jax_dir = converted
    turns = ["w5 w6 w7 w8", "w9 w10"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(turns) + "\n"))
    history = chat_cli.main(["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN,
                             "--temperature", "0", "--n-tokens", "12", "--pipeline-stages", "2"])
    _gen, tok, style = jax_model(jax_dir)
    cfg, params = jck.load_checkpoint(jax_dir, dtype=jnp.float32)
    import jax

    ring = JPipeline(cfg, params, mesh=jmesh(2, jax.devices()[:2]), max_seq_length=64,
                     rotations_per_call=2)
    want, stop = [], style.stop_tokens(tok)
    for t in turns:
        context = want + tok.encode(style.apply(t)).tolist()
        outs, _ = ring.generate([context], 12, temperature=0.0, stop_sequences=stop)
        want = outs[0]
    assert history == want
    assert tok.decode(np.asarray(want[-3:])) in capsys.readouterr().out


def test_stage_partition_tools(converted, tmp_path, capsys):  # noqa: F811
    import shutil

    port_dir, _ = converted
    work = tmp_path / "ckpt"
    shutil.copytree(port_dir, work)
    prepare_model.main([str(work), "--n-stages", "2", "--quantize", "int8"])
    cfg, params = ck.load_checkpoint(work)
    for base, quant in ((work, "none"), (tmp_path / "ckpt-int8", "int8")):
        chunk = base / "chunks" / "2stages"
        _, s0 = ck.load_checkpoint(chunk / "stage_0")
        _, s1 = ck.load_checkpoint(chunk / "stage_1")
        assert "wte" in s0 and "wte" not in s1 and "blocks" in s1
        jdir = tmp_path / f"j-{quant}"
        jpart.save_stage_manifest(jdir, _jcfg(cfg), 2, quantize=quant)
        assert (chunk / "stage_map.json").read_bytes() == (jdir / "stage_map.json").read_bytes()
    assert s0["blocks"]["norm_1"]["weight"].shape[0] + s1["blocks"]["norm_1"]["weight"].shape[0] \
        == cfg.n_layer
    capsys.readouterr()
    inspect_ckpt.main(["--ckpt", str(work), "--n-stages", "2"])
    out = capsys.readouterr().out
    assert "# stage split over 2 stages: layers [1, 1]" in out
    assert "stage 0: 1 layers" in out and "extras=['wte', 'ln_f', 'lm_head']" in out


def _jcfg(tcfg):
    from mdi_llm_tpu.config import Config as JConfig

    return JConfig(**tcfg.asdict())


def test_mem_monitor_samples_a_command_and_says_when_no_card_answers(tmp_path, monkeypatch):
    out = tmp_path / "mem.csv"
    code = "import time; x = bytearray(64 << 20); time.sleep(1.2)"
    rc = mem_monitor.main(["-o", str(out), "--interval", "0.2", "--", sys.executable, "-c", code])
    assert rc == 0
    rows = list(csv_rows(out))
    assert rows[0] == ["time_s", "rss_bytes", "gpu_bytes", "card_bytes"] and len(rows) > 2
    assert max(int(r[1]) for r in rows[1:]) > 64 << 20
    if mem_monitor.gpu_apps() is None:
        assert {(r[2], r[3]) for r in rows[1:]} == {("absent", "absent")}
    monkeypatch.setattr(mem_monitor, "gpu_apps", lambda: {os.getpid(): 3 << 20})
    monkeypatch.setattr(mem_monitor, "card_used", lambda: 5 << 20)
    assert mem_monitor.sample_tree(os.getpid())[1:] == (3 << 20, 5 << 20)
    monkeypatch.setattr(mem_monitor, "gpu_apps", lambda: {1: 7 << 20})  # another pid
    assert mem_monitor.sample_tree(os.getpid())[1:] == ("none", 5 << 20)
    with pytest.raises(SystemExit, match="no command"):
        mem_monitor.main(["-o", str(out)])


def csv_rows(path):
    import csv

    with open(path) as f:
        yield from csv.reader(f)


@pytest.mark.parametrize("module,args", [
    ("sample", ["--model", "pythia-14m", "--pipeline-stages", "2", "--n-tokens", "4"]),
    ("chat", ["--model", "pythia-14m", "--pipeline-stages", "2"]),
    ("starter", ["--model", "pythia-14m", "--nodes-config",
                 str(ROOT / "examples" / "node_configs" / "standalone.json"), "--n-tokens", "4"]),
    ("secondary", ["--model", "pythia-14m", "--nodes-config",
                   str(ROOT / "examples" / "node_configs" / "localhost_3node.json"), "0"]),
])
def test_pipeline_entry_points_raise_without_a_gpu(module, args):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    proc = subprocess.run([sys.executable, "-m", f"mdi_llm_tpu_torch.cli.{module}", *args],
                          capture_output=True, text=True, cwd=ROOT, env=ENV,
                          timeout=PROC_TIMEOUT)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_importing_the_pipeline_modules_loads_no_jax():
    code = ("import sys, mdi_llm_tpu_torch.parallel.pipeline, mdi_llm_tpu_torch.parallel.nodes, "
            "mdi_llm_tpu_torch.parallel.mesh, mdi_llm_tpu_torch.parallel.partition, "
            "mdi_llm_tpu_torch.cli.starter, mdi_llm_tpu_torch.cli.secondary, "
            "mdi_llm_tpu_torch.cli.plot_tok_time, mdi_llm_tpu_torch.cli.mem_monitor; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'mdi_llm_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=ENV)
    assert proc.returncode == 0, proc.stderr
