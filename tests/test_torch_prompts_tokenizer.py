"""The port's tokenizer, prompt styles, simple tokenizers and
`StreamPrinter` against the JAX package's, on the CPU.

- `Tokenizer`: the same ids, bos/eos, `use_bos` and decoded text as the
  JAX `Tokenizer` on the word-level fixture of
  `tests/test_prompts_tokenizer.py` and on a byte-level BPE trained here
  with `tokenizers` (bos/eos from `generation_config.json`); the
  sentencepiece backend's guarded import falls through the same way.
- Every registered `PromptStyle`: equal `apply` strings and `stop_tokens`;
  `style_for_model` over the whole registry, persistence and
  `get_user_prompt(custom_style=)` equal.
- `simple_tokenizers`: the round trips `tests/test_simple_tokenizers.py`
  requires, with the JAX package's ids.
- `StreamPrinter` prints the JAX one's text for a stream that ends in a
  stop sequence, through `push`/`finish` and through `emit`.
"""

import importlib.util
import io
import json

import numpy as np
import pytest
import torch

from mdi_llm_tpu import generation as jgen
from mdi_llm_tpu.utils import prompts as jprompts
from mdi_llm_tpu.utils import simple_tokenizers as jsimple
from mdi_llm_tpu.utils.tokenizer import Tokenizer as JTokenizer
from mdi_llm_tpu_torch import generation as tgen
from mdi_llm_tpu_torch.config import configs
from mdi_llm_tpu_torch.utils import prompts, simple_tokenizers
from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

torch.set_num_threads(1)
pytest.importorskip("tokenizers")

SPECIALS = ["<s>", "</s>", "<|eot_id|>", "<|SYSTEM|>", "<|USER|>", "<|ASSISTANT|>"]
TEXTS = ["hello world the cat", "the cat", "", "Once upon a time, the cat sat. ",
         "héllo wörld ©", "<|eot_id|> and <|USER|>"]


@pytest.fixture(scope="module")
def word_dir(tmp_path_factory):
    """The word-level tokenizer.json + tokenizer_config.json fixture of
    `tests/test_prompts_tokenizer.py`."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    d = tmp_path_factory.mktemp("word")
    vocab = {"<s>": 0, "</s>": 1, "hello": 2, "world": 3, "the": 4, "cat": 5}
    t = HFTok(WordLevel(vocab, unk_token="</s>"))
    t.pre_tokenizer = Whitespace()
    t.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True})
    )
    return d


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A byte-level BPE trained here; bos/eos only in generation_config."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers

    d = tmp_path_factory.mktemp("bpe")
    t = HFTok(models.BPE())
    t.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    t.decoder = decoders.ByteLevel()
    corpus = ["Once upon a time, the cat sat on the mat.",
              "Below is an instruction that describes a task.",
              "Write a response that appropriately completes the request.",
              "User: Answer: Question: Q: A: Label: héllo wörld"] * 20
    t.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=300, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    t.save(str(d / "tokenizer.json"))
    (d / "generation_config.json").write_text(
        json.dumps({"bos_token_id": 0, "eos_token_id": [1, 2]}))
    (d / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "LlamaTokenizer"}))
    return d


@pytest.mark.parametrize("fixture", ["word_dir", "bpe_dir"])
def test_tokenizer_matches_the_jax_package(fixture, request):
    d = request.getfixturevalue(fixture)
    tok, jtok = Tokenizer(d), JTokenizer(d)
    assert tok.backend == jtok.backend == "huggingface"
    assert (tok.bos_id, tok.eos_id, tok.use_bos, tok.vocab_size) == (
        jtok.bos_id, jtok.eos_id, jtok.use_bos, jtok.vocab_size)
    assert tok.bos_id == 0 and tok.eos_id == 1 and tok.use_bos
    for text in TEXTS:
        for kw in ({}, {"bos": False}, {"eos": True}, {"bos": False, "max_length": 2}):
            ids = tok.encode(text, **kw)
            assert ids.dtype == np.int32
            np.testing.assert_array_equal(ids, jtok.encode(text, **kw))
        assert tok.decode(ids) == jtok.decode(ids)
    for name in SPECIALS + ["missing-token"]:
        assert tok.token_to_id(name, missing_ok=True) == jtok.token_to_id(name, missing_ok=True)


def test_sentencepiece_import_is_guarded_as_in_the_jax_package(word_dir, tmp_path):
    if importlib.util.find_spec("sentencepiece") is not None:
        pytest.skip("sentencepiece is installed: the fall-through is not reached")
    for f in word_dir.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "tokenizer.model").write_bytes(b"not a model")
    assert Tokenizer(tmp_path).backend == JTokenizer(tmp_path).backend == "huggingface"
    for cls in (Tokenizer, JTokenizer):
        with pytest.raises(RuntimeError, match="sentencepiece"):
            cls(tmp_path, force_backend="sentencepiece")
    with pytest.raises(NotADirectoryError):
        Tokenizer(tmp_path / "missing")


@pytest.mark.parametrize("fixture", ["word_dir", "bpe_dir"])
def test_every_prompt_style_matches_the_jax_package(fixture, request):
    d = request.getfixturevalue(fixture)
    tok, jtok = Tokenizer(d), JTokenizer(d)
    assert sorted(prompts.styles) == sorted(jprompts.styles)
    for name, style in prompts.styles.items():
        jstyle = jprompts.styles[name]
        assert style.apply("Tell me about the cat.") == jstyle.apply("Tell me about the cat.")
        assert style.stop_tokens(tok) == jstyle.stop_tokens(jtok), name
    custom = prompts.styles["alpaca"]
    assert prompts.get_user_prompt("hi", 2, custom_style=custom) == jprompts.get_user_prompt(
        "hi", 2, custom_style=jprompts.styles["alpaca"])


def test_style_dispatch_and_persistence_match_the_jax_package(tmp_path):
    names = [c["name"] for c in configs] + [
        "Llama-3-8B-Instruct", "tiny-llama-1.1b-chat", "Mistral-7B-Instruct-v0.2",
        "falcon-7b-instruct", "Gemma-2b-it", "phi-2", "some-finetune"]
    for name in names:
        assert prompts.style_for_model(name).name == jprompts.style_for_model(name).name
    prompts.save_prompt_style("llama3", tmp_path / "port")
    jprompts.save_prompt_style("llama3", tmp_path / "jax")
    assert ((tmp_path / "port" / "prompt_style.yaml").read_text()
            == (tmp_path / "jax" / "prompt_style.yaml").read_text())
    assert prompts.has_prompt_style(tmp_path / "jax")
    assert prompts.load_prompt_style(tmp_path / "jax").name == "llama3"
    assert not prompts.has_prompt_style(tmp_path)
    with pytest.raises(ValueError):
        prompts.save_prompt_style("nope", tmp_path)


def test_simple_tokenizers_roundtrip_with_the_jax_packages_ids(tmp_path):
    text = "hello shakespeare!\nact one."
    char, jchar = simple_tokenizers.CharTokenizer().train(text), jsimple.CharTokenizer().train(text)
    ids = char.encode("hello one")
    np.testing.assert_array_equal(ids, jchar.encode("hello one"))
    assert char.decode(ids) == "hello one" and char.vocab_size == len(set(text))
    char.save(tmp_path / "char.json")
    np.testing.assert_array_equal(
        jsimple.CharTokenizer.load(tmp_path / "char.json").encode("hello"), ids[:5])

    corpus = "the quick brown fox jumps over the lazy dog " * 50
    bpe = simple_tokenizers.BPETokenizer().train(corpus, vocab_size=300)
    jbpe = jsimple.BPETokenizer().train(corpus, vocab_size=300)
    assert bpe.merges == jbpe.merges and 256 < bpe.vocab_size <= 300
    ids = bpe.encode("the quick brown fox")
    np.testing.assert_array_equal(ids, jbpe.encode("the quick brown fox"))
    assert bpe.decode(ids) == "the quick brown fox"
    assert len(ids) < len("the quick brown fox".encode())
    bpe.save(tmp_path / "bpe.json")
    back = simple_tokenizers.BPETokenizer.load(tmp_path / "bpe.json")
    np.testing.assert_array_equal(back.encode("lazy dog"), bpe.encode("lazy dog"))
    assert back.decode(back.encode("héllo wörld")) == "héllo wörld"
    small = simple_tokenizers.BPETokenizer().train("aaaa bbbb aaaa bbbb", vocab_size=260)
    assert small.decode(small.encode("zzz unseen ©")) == "zzz unseen ©"


@pytest.mark.parametrize("text", ["The cat sat on the mat: a task.",
                                  "The cat sat on the mat: héllo wörld ©."],
                         ids=["ascii", "multibyte"])
def test_stream_printer_prints_the_jax_packages_text(bpe_dir, text):
    """A reply that ends in a two-token stop sequence: the port's printer
    writes what the JAX one writes, live (`push`, then `finish` on the
    trimmed output) and pre-filtered (`emit`).  With byte-level tokens
    that split a character, the decoded prefix ends in U+FFFD, which the
    next decode does not extend, so both printers stop writing there."""
    tok, jtok = Tokenizer(bpe_dir), JTokenizer(bpe_dir)
    stop = [tok.encode("User:", bos=False).tolist(), [tok.eos_id]]
    assert len(stop[0]) >= 2
    reply = tok.encode(text, bos=False).tolist()
    stream = reply + stop[0] + tok.encode(" more", bos=False).tolist()
    trimmed = stream[: tgen.find_eot(stream, stop)]
    assert trimmed == reply
    outs = {}
    for name, mod, t in (("port", tgen, tok), ("jax", jgen, jtok)):
        live, filtered = io.StringIO(), io.StringIO()
        printer = mod.StreamPrinter(t, stop, out=live)
        for x in stream:
            printer.push(x)
        got = printer.finish(trimmed)
        pre = mod.StreamPrinter(t, stop, out=filtered)
        for x in tgen.stop_filtered_stream(iter(stream), stop):
            pre.emit(x)
        outs[name] = (live.getvalue(), got, filtered.getvalue(), pre.reply)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][2]
    assert outs["port"][1] == outs["port"][3] == reply
    if text.isascii():
        assert outs["port"][0] == text
