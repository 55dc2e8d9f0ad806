"""The port's CLIs, their device rule and the port's import boundary.

- `python -m mdi_llm_tpu_torch.cli.serve --device cpu ...` serves a
  synthetic trace and prints the JSON stats line on stderr, over an fp,
  int8 or float8 pool and with speculative serving and a draft model;
- without `--device cpu` on a machine with no GPU it raises, and does not
  fall back to the CPU;
- every flag of a feature the port does not carry is refused;
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


@pytest.mark.parametrize("flags,match", [
    (["--host-pool-mib", "64"], "not ported"),
    (["--tp", "2"], "not ported"), (["--pp", "2"], "not ported"),
    (["--quantize", "int8"], "not ported"),
    # --ckpt is ported: a directory that is not there is refused by name
    (["--ckpt", "some/dir"], "some/dir: no such checkpoint directory"),
    (["--metrics-out", "m.json"], "not ported"), (["--prom-out", "m.txt"], "not ported"),
    (["--trace-out", "t.json"], "not ported"), (["--xprof-steps", "4"], "not ported"),
    (["--sample-rss", "0.5"], "not ported"),
], ids=["--host-pool-mib", "--tp", "--pp", "--quantize", "--ckpt", "--metrics-out",
        "--prom-out", "--trace-out", "--xprof-steps", "--sample-rss"])
def test_cli_refuses_unported_flags(flags, match):
    args = cli.build_parser().parse_args(["--device", "cpu", *CPU_RUN, *flags])
    with pytest.raises(SystemExit, match=match):
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
            "mdi_llm_tpu_torch.cli.model_surgery; "
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
    refuses a hub name and stage partitioning."""
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
    with pytest.raises(SystemExit, match="not ported"):
        prepare_model.main([str(work), "--n-stages", "3"])
    with pytest.raises(SystemExit, match="not ported"):
        inspect_ckpt.main(["--ckpt", str(work), "--n-stages", "2"])


@pytest.mark.parametrize("flag", ["--tp-devices", "--pipeline-stages", "--ep-devices",
                                  "--sp-devices"])
def test_chat_cli_refuses_unported_backends(flag):
    with pytest.raises(SystemExit, match="not ported"):
        chat_cli.main(["--device", "cpu", "--model", "pythia-14m", flag, "2"])
