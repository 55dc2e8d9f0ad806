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
  `tokenizers` (an AST scan); importing the CLIs leaves jax out of
  `sys.modules`;
- on a tiny llama HF snapshot with a word-level tokenizer, converted by
  each package: `cli.sample --ckpt` (text prompt, greedy), `cli.serve
  --ckpt` (text prompts) and `cli.chat --ckpt` (two stdin turns) give the
  JAX package's greedy tokens, `cli.train --init hf` takes a step from the
  converted weights, and each of them raises without `--device cpu` on a
  machine with no GPU; `prepare_model`, `convert_to_hf`, `inspect_ckpt`
  and `model_surgery` work on the converted checkpoint.
"""

import ast
import io
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu import generation as jgen
from mdi_llm_tpu.utils import checkpoint as jck
from mdi_llm_tpu.utils.prompts import style_for_model as jstyle_for_model
from mdi_llm_tpu.utils.tokenizer import Tokenizer as JTokenizer
from mdi_llm_tpu_torch.cli import chat as chat_cli
from mdi_llm_tpu_torch.cli import convert_to_hf, inspect_ckpt, model_surgery, prepare_model
from mdi_llm_tpu_torch.cli import sample as sample_cli
from mdi_llm_tpu_torch.cli import serve as cli
from mdi_llm_tpu_torch.cli import train as train_cli
from mdi_llm_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CPU_RUN = ["--model", "pythia-14m", "--synthetic", "3", "--max-batch", "2",
           "--n-tokens", "8", "--sequence-length", "128", "--block-size", "8"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "orbax", "yaml", "mdi_llm_tpu")
# the HF libraries: only the tokenizer's backend imports one
HF_LIBS = {"safetensors": (), "transformers": (),
           "tokenizers": ("mdi_llm_tpu_torch/utils/tokenizer.py",)}


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
    jax_proc = subprocess.run(
        [sys.executable, "-m", "mdi_llm_tpu.cli.serve", "--device", "cpu", *CPU_RUN, *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT)))
    assert jax_proc.returncode == 0, jax_proc.stderr
    proc = _run(["--device", "cpu", *CPU_RUN, *flags])
    assert proc.returncode == 0, proc.stderr
    jline = json.loads(jax_proc.stderr.strip().splitlines()[-1])
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
            "mdi_llm_tpu_torch.serving.pipeline; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'mdi_llm_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# --ckpt, text prompts, chat and --init hf against the JAX package
# ---------------------------------------------------------------------------

N_WORDS = 96  # the word-level vocabulary covers every model id


@pytest.fixture(scope="module")
def hf_snapshot(tmp_path_factory):
    """A tiny llama (GQA) written by `transformers`, with a word-level
    tokenizer.json ("<s>", "</s>", "w2" ... "w95") and its config."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    d = tmp_path_factory.mktemp("snapshot") / "hf"
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=N_WORDS, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False))
    model.save_pretrained(d)
    vocab = {"<s>": 0, "</s>": 1, **{f"w{i}": i for i in range(2, N_WORDS)}}
    tok = HFTok(WordLevel(vocab, unk_token="</s>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))
    return d


@pytest.fixture(scope="module")
def converted(hf_snapshot, tmp_path_factory):
    """(the port's checkpoint dir, the JAX package's one): each package
    converts its own copy of the snapshot in place."""
    root = tmp_path_factory.mktemp("converted")
    port_dir, jax_dir = root / "port", root / "jax"
    shutil.copytree(hf_snapshot, port_dir)
    shutil.copytree(hf_snapshot, jax_dir)
    jck.convert_hf_checkpoint(jax_dir, dtype=jnp.float32)
    prepare_model.main([str(port_dir), "--dtype", "float32"])
    return port_dir, jax_dir


def jax_model(jax_dir, max_seq_length=64):
    cfg, params = jck.load_checkpoint(jax_dir, dtype=jnp.float32)
    tok = JTokenizer(jax_dir)
    return jgen.Generator(cfg, params, max_seq_length=max_seq_length), tok, jstyle_for_model(cfg.name)


CKPT_RUN = ["--dtype", "float32", "--sequence-length", "64"]


def test_sample_cli_ckpt_text_prompt_gives_the_jax_greedy_tokens(converted, capsys):
    port_dir, jax_dir = converted
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(
        ["config.json", "generation_config.json", "model.safetensors", "model_config.yaml",
         "params.pt", "tokenizer.json", "tokenizer_config.json"])
    prompt = "w5 w17 w33 w2 w90"
    outs = sample_cli.main(["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN,
                            "--greedy", "--n-tokens", "10", "--prompt", prompt])
    gen, tok, style = jax_model(jax_dir)
    ids = tok.encode(style.apply(prompt)).tolist()
    assert ids[0] == tok.bos_id and len(ids) == 6
    want, _ = gen.generate([ids], 10, temperature=0.0, stop_sequences=style.stop_tokens(tok))
    assert outs == want
    assert tok.decode(np.asarray(want[0])) in capsys.readouterr().out


def test_serve_cli_ckpt_text_prompts_give_the_jax_engines_streams(converted, tmp_path, capsys):
    port_dir, jax_dir = converted
    texts = ["w5 w17 w33", "w40 w41 w42 w43 w44 w45 w46 w47 w48 w49 w50", "w9"]
    (tmp_path / "prompts.txt").write_text("\n".join(texts) + "\n\n")
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN, "--prompt-file",
         str(tmp_path / "prompts.txt"), "--n-tokens", "7", "--max-batch", "2",
         "--block-size", "8"])
    trace, results, stats, engine, tokenizer = cli.serve(args)
    gen, tok, _style = jax_model(jax_dir)
    engine = gen.serve(block_size=8, max_batch=2)
    for i, t in enumerate(texts):
        engine.add_request(f"req{i}", tok.encode(t).tolist(), 7)
    want, _ = engine.run()
    assert [rid for rid, _p, _n in trace] == ["req0", "req1", "req2"]
    assert {rid: list(v) for rid, v in results.items()} == {rid: list(v) for rid, v in want.items()}
    assert stats.tokens_generated == 21
    cli.main(["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN, "--prompt", texts[0],
              "--n-requests", "2", "--n-tokens", "7", "--max-batch", "2", "--block-size", "8"])
    assert capsys.readouterr().out.count(tok.decode(np.asarray(want["req0"]))) == 2


def test_chat_cli_two_turns_give_the_jax_chat_sessions_replies(converted, monkeypatch, capsys):
    port_dir, jax_dir = converted
    turns = ["w5 w6 w7 w8", "w9 w10"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(turns) + "\n"))
    session = chat_cli.main(["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN,
                             "--temperature", "0", "--n-tokens", "12"])
    gen, tok, style = jax_model(jax_dir)
    jsess = gen.chat_session()
    replies = []
    for t in turns:
        replies.append(list(jsess.send(tok.encode(style.apply(t)).tolist(), 12,
                                       temperature=0.0, stop_sequences=style.stop_tokens(tok))))
    assert session.history == jsess.history
    out = capsys.readouterr().out
    for r in replies:
        assert r and tok.decode(np.asarray(r)) in out


def test_chat_cli_sp_devices_gives_the_jax_chat_sessions_replies(converted, monkeypatch,
                                                                 capsys):
    """`cli.chat --sp-devices 2` (an `SPChatSession` over two ranks on the
    CPU, its sp flags set) keeps the JAX single-device session's
    conversation."""
    port_dir, jax_dir = converted
    turns = ["w5 w6 w7 w8", "w9 w10"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(turns) + "\n"))
    session = chat_cli.main(["--device", "cpu", "--ckpt", str(port_dir), *CKPT_RUN,
                             "--temperature", "0", "--n-tokens", "12", "--sp-devices", "2",
                             "--sp-flash", "--sp-chunk", "3"])
    assert type(session).__name__ == "SPChatSession" and session.gen.P == 2
    gen, tok, style = jax_model(jax_dir)
    jsess = gen.chat_session()
    for t in turns:
        list(jsess.send(tok.encode(style.apply(t)).tolist(), 12, temperature=0.0,
                        stop_sequences=style.stop_tokens(tok)))
    assert session.history == jsess.history


def test_train_cli_init_hf_steps_from_the_converted_weights(hf_snapshot, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(hf_snapshot, ckpt)
    ds = tmp_path / "data"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for name in ("train.bin", "val.bin"):
        rng.integers(0, N_WORDS, 4096).astype(np.uint16).tofile(ds / name)
    ref_cfg, ref = ck.load_checkpoint(
        ck.convert_hf_checkpoint(hf_snapshot, dtype=torch.float32, out_dir=tmp_path / "ref"))
    result, trainer = train_cli.main([
        "--device", "cpu", "--init", "hf", "--ckpt", str(ckpt), "--dataset", str(ds),
        "--dtype", "float32", "--batch-size", "2", "--block-size", "16", "--max-iters", "1",
        "--learning-rate", "1e-3", "--warmup-iters", "0", "--log-interval", "1",
        "--eval-iters", "1"])
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    assert result["iter_num"] == 1 and len(losses) == 1 and math.isfinite(losses[0])
    assert trainer.cfg == ref_cfg
    moved = 0
    for (name, a), b in zip(_leaves(trainer.params), _flat(ref)):
        step = (a.detach() - b).abs().max().item()
        assert step <= 2e-3, name  # one AdamW step at lr 1e-3 from the converted weights
        moved += step > 0
    assert moved > 0
    assert ck.has_checkpoint(ckpt)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def _flat(tree):
    return [t for _, t in _leaves(tree)]


@pytest.mark.parametrize("entry", ["sample", "serve", "chat", "train"])
def test_ckpt_entry_points_raise_without_a_gpu(converted, tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    port_dir, _ = converted
    run = {
        "sample": lambda: sample_cli.main(["--ckpt", str(port_dir), "--prompt", "w5"]),
        "serve": lambda: cli.serve(cli.build_parser().parse_args(
            ["--ckpt", str(port_dir), "--prompt", "w5"])),
        "chat": lambda: chat_cli.main(["--ckpt", str(port_dir)]),
        "train": lambda: train_cli.main(["--init", "hf", "--ckpt", str(port_dir),
                                         "--dataset", str(tmp_path)]),
    }[entry]
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        run()


def test_checkpoint_tools_on_the_converted_checkpoint(converted, tmp_path, capsys):
    """inspect_ckpt lists every leaf; convert_to_hf writes safetensors and
    .bin that `transformers` loads back to the original weights;
    model_surgery patches the config and drops a leaf; prepare_model
    refuses a hub name and writes the stage partition (`--n-stages`), which
    inspect_ckpt shows."""
    import transformers

    port_dir, _ = converted
    work = tmp_path / "ckpt"
    shutil.copytree(port_dir, work)
    total = inspect_ckpt.main(["--ckpt", str(work)])
    out = capsys.readouterr().out
    assert "blocks.attn.qkv.weight" in out and f"# total bytes: {total:,}" in out
    ref = transformers.LlamaForCausalLM.from_pretrained(port_dir).state_dict()
    for fmt in ("safetensors", "bin"):
        path = convert_to_hf.main(["--ckpt", str(work), "--out", str(tmp_path / fmt),
                                   "--format", fmt])
        shutil.copy(port_dir / "config.json", path.parent / "config.json")
        back = transformers.LlamaForCausalLM.from_pretrained(path.parent).state_dict()
        for k, v in ref.items():
            assert torch.equal(back[k], v), (fmt, k)
    model_surgery.main(["--ckpt", str(work), "--set", "block_size=64", "--set",
                        'name="patched"', "--drop", "lm_head", "--dry-run"])
    assert ck.load_checkpoint(work)[0].block_size == 128
    model_surgery.main(["--ckpt", str(work), "--set", "block_size=64", "--set",
                        'name="patched"', "--rename", "lm_head=head"])
    cfg, params = ck.load_checkpoint(work)
    assert (cfg.block_size, cfg.name) == (64, "patched")
    assert "head" in params and "lm_head" not in params
    with pytest.raises(SystemExit, match="downloads nothing"):
        prepare_model.main(["TinyLlama/TinyLlama-1.1B-Chat-v1.0"])
    prepare_model.main([str(work), "--n-stages", "2"])
    assert (work / "chunks" / "2stages" / "stage_map.json").exists()
    capsys.readouterr()
    inspect_ckpt.main(["--ckpt", str(work), "--n-stages", "2"])
    assert "# stage split over 2 stages" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--tp-devices", "--pipeline-stages", "--ep-devices",
                                  "--sp-devices"])
def test_chat_cli_refuses_unported_backends(flag):
    """Every backend is ported (ep since expert parallelism came): each
    one, like every chat, needs a checkpoint's tokenizer."""
    match = "needs a checkpoint with a tokenizer"
    with pytest.raises(SystemExit, match=match):
        chat_cli.main(["--device", "cpu", "--model", "pythia-14m", flag, "2"])
