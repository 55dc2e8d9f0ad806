"""The port's checkpoint CLIs on a converted HF snapshot, against the JAX
package's (split from `tests/test_torch_cli.py`, which keeps the serve
CLI and the import boundary).

- on a tiny llama HF snapshot with a word-level tokenizer, converted by
  each package: `cli.sample --ckpt` (text prompt, greedy), `cli.serve
  --ckpt` (text prompts) and `cli.chat --ckpt` (two stdin turns) give the
  JAX package's greedy tokens, `cli.train --init hf` takes a step from the
  converted weights, and each of them raises without `--device cpu` on a
  machine with no GPU; `prepare_model`, `convert_to_hf`, `inspect_ckpt`
  and `model_surgery` work on the converted checkpoint.
"""

import io
import json
import math
import shutil
import socket
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu import generation as jgen
from mdi_llm_tpu.cli import prepare_model as jprepare_model
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


def offline_hub(monkeypatch, root):
    """`huggingface_hub` offline in this process for the test: the
    variable and the constant it was read into, its cache and token under
    `root`, the HTTP sessions rebuilt, and a connection or name lookup for
    an outside host refused."""
    from huggingface_hub import constants
    from huggingface_hub.utils import reset_sessions

    def refuse(*args, **kwargs):
        raise AssertionError(f"a network connection was attempted: {args[:2]}")

    connect = socket.socket.connect

    def local_only(self, address):
        if self.family in (socket.AF_INET, socket.AF_INET6) and address[0] not in (
                "127.0.0.1", "::1", "localhost"):
            refuse(address)
        return connect(self, address)

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(constants, "HF_HUB_CACHE", str(root / "hf-home" / "hub"))
    monkeypatch.setattr(constants, "HF_TOKEN_PATH", str(root / "hf-home" / "token"))
    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    monkeypatch.setattr(socket.socket, "connect", local_only)
    reset_sessions()


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


def test_checkpoint_tools_on_the_converted_checkpoint(converted, tmp_path, capsys,
                                                      monkeypatch):
    """inspect_ckpt lists every leaf; convert_to_hf writes safetensors and
    .bin that `transformers` loads back to the original weights;
    model_surgery patches the config and drops a leaf; prepare_model
    sends a hub name to the hub download (offline: the JAX CLI's
    exception) and writes the stage partition (`--n-stages`), which
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
    # a hub id goes to the hub download, as in the JAX CLI: offline, on an
    # empty checkpoints dir, both packages raise the same exception
    offline_hub(monkeypatch, tmp_path)
    raised = []
    for main, root in ((prepare_model.main, "port"), (jprepare_model.main, "jax")):
        with pytest.raises(Exception) as e:
            main(["TinyLlama/TinyLlama-1.1B-Chat-v1.0", "--checkpoints-dir",
                  str(tmp_path / root)])
        raised.append(type(e.value))
    assert raised[0] is raised[1] and raised[0].__name__ == "LocalEntryNotFoundError"
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
