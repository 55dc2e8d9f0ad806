"""The port's hub download (`utils/download.py`, `cli/download_weights.py`,
`cli/prepare_model.py`'s hub route) and `cli/prepare_owt.py`, against the
JAX package's, on the CPU with no network.

- `huggingface_hub` runs offline (`HF_HUB_OFFLINE`, its cache and token
  under the test's directory, every HTTP session rebuilt, and any
  connection to an outside host refused): `snapshot_download` then
  returns a `local_dir` that already holds files, so both packages'
  `download_from_hub` run their real code on a tiny HF snapshot (llama
  with GQA, gpt_neox) placed in `<checkpoints>/<org>/<name>`, and the
  converted leaves are exactly equal (bfloat16 compared through float32);
  greedy `sample --ckpt` gives the JAX CLI's tokens.
- `--no-convert` and `--tokenizer-only` leave no `params.pt`; both
  packages ask the hub for the same file patterns; gated and missing
  repos give the JAX module's `RuntimeError` messages.
- `prepare_model <org>/<name> --n-stages 2 --quantize int8` writes the
  JAX CLI's stage manifests byte for byte and its leaves exactly.
- `prepare_owt` writes the JAX CLI's `train.bin` / `val.bin` byte for
  byte from a saved `Dataset`, a saved `DatasetDict`, with a vocabulary
  of 2^16 or more (uint32 bins) and with another text column.
"""

import json
import shutil
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.cli import prepare_model as jprepare_model
from mdi_llm_tpu.cli import prepare_owt as jprepare_owt
from mdi_llm_tpu.cli import sample as jsample
from mdi_llm_tpu.utils import checkpoint as jck
from mdi_llm_tpu.utils import download as jdl
from mdi_llm_tpu_torch.cli import download_weights, prepare_model, prepare_owt
from mdi_llm_tpu_torch.cli import sample as sample_cli
from mdi_llm_tpu_torch.utils import checkpoint as ck
from mdi_llm_tpu_torch.utils import download as dl

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")
pytest.importorskip("huggingface_hub")
pytest.importorskip("tokenizers")

N_WORDS = 96  # the word-level vocabulary covers every model id
# family -> (HF config class, model class, config kwargs)
FAMILIES = {
    "llama-gqa": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=N_WORDS, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False)),
    "neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(
        vocab_size=N_WORDS, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, rotary_pct=0.25, max_position_embeddings=128,
        use_parallel_residual=True)),
}


def word_tokenizer(d, n_words, add_bos=True):
    """A word-level tokenizer.json ("<s>", "</s>", "w2" ... ) and its
    tokenizer_config.json in `d`."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<s>": 0, "</s>": 1, **{f"w{i}": i for i in range(2, n_words)}}
    tok = HFTok(WordLevel(vocab, unk_token="</s>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": add_bos}))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """family -> a tiny HF snapshot written by `transformers`, with a
    word-level tokenizer."""
    out = {}
    for i, (family, (cfg_cls, model_cls, kw)) in enumerate(FAMILIES.items()):
        d = tmp_path_factory.mktemp(family) / "hf"
        torch.manual_seed(i)
        getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw)).save_pretrained(d)
        word_tokenizer(d, N_WORDS)
        out[family] = d
    return out


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """`huggingface_hub` offline in this process: the variable and the
    constant it was read into, its cache and token under `tmp_path`, every
    HTTP session rebuilt so the offline adapter is mounted, and a
    connection or name lookup for any outside host refused."""
    from huggingface_hub import constants
    from huggingface_hub.utils import reset_sessions

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf-home"))
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(constants, "HF_HUB_CACHE", str(tmp_path / "hf-home" / "hub"))
    monkeypatch.setattr(constants, "HF_TOKEN_PATH", str(tmp_path / "hf-home" / "token"))

    def refuse(*args, **kwargs):
        raise AssertionError(f"a network connection was attempted: {args[:2]}")

    connect = socket.socket.connect

    def local_only(self, address):
        if self.family in (socket.AF_INET, socket.AF_INET6) and address[0] not in (
                "127.0.0.1", "::1", "localhost"):
            refuse(address)
        return connect(self, address)

    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    monkeypatch.setattr(socket.socket, "connect", local_only)
    reset_sessions()
    yield
    reset_sessions()


def placed(snapshot, root, repo_id):
    """`snapshot` copied to `root/<org>/<name>`, as a finished download
    leaves it; returns `root`."""
    shutil.copytree(snapshot, root / repo_id)
    return root


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_same_checkpoint(port_dir, jax_dir):
    """The two checkpoints' configs agree and every leaf is exactly equal,
    dtype included (bfloat16 compared through float32)."""
    cfg, params = ck.load_checkpoint(port_dir)
    jcfg, jparams = jck.load_checkpoint(jax_dir)
    assert {**cfg.asdict(), "hf_config": None} == {**jcfg.asdict(), "hf_config": None}
    got, want = dict(leaves(params)), dict(leaves(jparams))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        assert str(t.dtype).replace("torch.", "") == w.dtype.name, name
        np.testing.assert_array_equal(_np(t), _np(w), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_download_from_hub_gives_the_jax_packages_leaves(snapshots, offline, tmp_path,
                                                         family, dtype):
    repo = f"tiny-org/{family}"
    jroot = placed(snapshots[family], tmp_path / "jax", repo)
    root = placed(snapshots[family], tmp_path / "port", repo)
    f32 = dtype == "float32"  # else each package's default, bfloat16
    jdir = jdl.download_from_hub(repo, jroot, dtype=jnp.float32 if f32 else None)
    got = dl.download_from_hub(repo, root, dtype=torch.float32 if f32 else None)
    assert got == root / repo and jdir == jroot / repo
    assert (got / "params.pt").exists() and (got / "model_config.yaml").exists()
    assert_same_checkpoint(got, jdir)
    assert ck.load_checkpoint(got)[1]["wte"]["weight"].dtype == getattr(torch, dtype)
    if f32:
        run = ["--greedy", "--n-tokens", "8", "--prompt", "w5 w17 w33 w2", "--sequence-length",
               "64", "--dtype", "float32"]
        want = jsample.main(["--ckpt", str(jdir), *run])
        outs = sample_cli.main(["--device", "cpu", "--ckpt", str(got), *run])
        assert outs == want and len(outs[0]) > 0


def test_download_weights_flags_leave_no_checkpoint(snapshots, offline, tmp_path, capsys):
    """`--no-convert` and `--tokenizer-only` download (here: find) the
    snapshot and convert nothing; without them the CLI converts."""
    repo = "tiny-org/llama-gqa"
    files = sorted(p.name for p in snapshots["llama-gqa"].iterdir())
    for flag in ("--no-convert", "--tokenizer-only", None):
        root = placed(snapshots["llama-gqa"], tmp_path / str(flag), repo)
        out = download_weights.main(
            [repo, "--checkpoints-dir", str(root)] + ([flag] if flag else []))
        assert out == root / repo and capsys.readouterr().out.strip() == str(out)
        names = sorted(p.name for p in out.iterdir())
        if flag:
            assert names == files and not ck.has_checkpoint(out)
        else:
            assert ck.has_checkpoint(out) and set(files) < set(names)


def test_download_asks_for_the_jax_modules_patterns(snapshots, offline, tmp_path, monkeypatch):
    """The weights and tokenizer-only pattern lists, as the real
    `snapshot_download` receives them from each package."""
    import huggingface_hub

    real, calls = huggingface_hub.snapshot_download, []

    def recording(repo_id, **kw):
        calls.append((repo_id, kw["allow_patterns"], kw["token"]))
        return real(repo_id, **kw)

    monkeypatch.setattr(huggingface_hub, "snapshot_download", recording)
    repo = "tiny-org/llama-gqa"
    for i, tokenizer_only in enumerate((False, True)):
        for j, mod in enumerate((jdl, dl)):
            root = placed(snapshots["llama-gqa"], tmp_path / f"{i}{j}", repo)
            mod.download_from_hub(repo, root, access_token="hf_x", tokenizer_only=tokenizer_only,
                                  convert=False)
    assert dl._WEIGHT_PATTERNS == jdl._WEIGHT_PATTERNS
    assert calls == [(repo, dl._WEIGHT_PATTERNS, "hf_x")] * 2 + [
        (repo, ["tokenizer*", "*.json", "*.model"], "hf_x")] * 2


@pytest.mark.parametrize("error", ["GatedRepoError", "RepositoryNotFoundError"])
def test_hub_errors_give_the_jax_modules_messages(monkeypatch, tmp_path, error):
    import huggingface_hub
    from huggingface_hub import utils

    def raising(repo_id, **kw):
        raise getattr(utils, error)(f"{error} for {repo_id}")

    monkeypatch.setattr(huggingface_hub, "snapshot_download", raising)
    messages = []
    for mod in (jdl, dl):
        with pytest.raises(RuntimeError) as e:
            mod.download_from_hub("tiny-org/gone", tmp_path)
        assert isinstance(e.value.__cause__, getattr(utils, error))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert ("is a gated repo" if error == "GatedRepoError" else "not found on the HF hub") \
        in messages[1]


def test_prepare_model_hub_route_writes_the_jax_clis_stages_and_quantized_copy(
        snapshots, offline, tmp_path):
    repo = "tiny-org/llama-gqa"
    jroot = placed(snapshots["llama-gqa"], tmp_path / "jax", repo)
    root = placed(snapshots["llama-gqa"], tmp_path / "port", repo)
    flags = ["--n-stages", "2", "--quantize", "int8", "--dtype", "float32"]
    jdir = jprepare_model.main([repo, "--checkpoints-dir", str(jroot), *flags])
    got = prepare_model.main([repo, "--checkpoints-dir", str(root), *flags])
    assert got == root / repo and jdir == jroot / repo
    for sub in ("", "-int8"):
        base, jbase = got.parent / f"{got.name}{sub}", jdir.parent / f"{jdir.name}{sub}"
        assert_same_checkpoint(base, jbase)
        chunk, jchunk = base / "chunks" / "2stages", jbase / "chunks" / "2stages"
        assert (chunk / "stage_map.json").read_bytes() == (jchunk / "stage_map.json").read_bytes()
        for i in range(2):
            assert_same_checkpoint(chunk / f"stage_{i}", jchunk / f"stage_{i}")


# ---------------------------------------------------------------------------
# prepare_owt
# ---------------------------------------------------------------------------


def _documents(n, n_words, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{i}" for i in rng.integers(2, n_words, rng.integers(1, 30)))
            for _ in range(n)]


@pytest.mark.parametrize("case", ["dataset", "datasetdict", "uint32", "text-column"])
def test_prepare_owt_bins_are_the_jax_clis_byte_for_byte(tmp_path, monkeypatch, case):
    datasets = pytest.importorskip("datasets")
    monkeypatch.setenv("HF_DATASETS_CACHE", str(tmp_path / "ds-cache"))
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", tmp_path / "ds-cache")
    n_words = 70000 if case == "uint32" else N_WORDS
    tok_dir = tmp_path / "tok"
    tok_dir.mkdir()
    word_tokenizer(tok_dir, n_words, add_bos=case != "datasetdict")
    column = "content" if case == "text-column" else "text"
    docs = _documents(60, n_words, seed=len(case))
    src = tmp_path / "src"
    if case == "datasetdict":
        datasets.DatasetDict({
            "train": datasets.Dataset.from_dict({column: docs[:45]}),
            "validation": datasets.Dataset.from_dict({column: docs[45:]}),
        }).save_to_disk(str(src))
    else:
        prepare_owt.save_documents(docs, src, text_column=column)
    flags = ["--ckpt", str(tok_dir), "--val-frac", "0.1", "--seed", "7", "--text-column", column]
    # each package maps its own copy: `datasets` writes its cache files
    # beside a dataset loaded from disk.  Both tokenize in this process:
    # `datasets` forks a pool of one for the JAX CLI's `num_proc=1` (a
    # fork of a process running JAX's threads), not for its 0
    shutil.copytree(src, tmp_path / "jsrc")
    jprepare_owt.main(["--dataset", str(tmp_path / "jsrc"), "--out", str(tmp_path / "jax"),
                       "--num-proc", "0", *flags])
    got = prepare_owt.main(["--dataset", str(src), "--out", str(tmp_path / "port"),
                            "--num-proc", "1", *flags])
    assert got == (tmp_path / "port" / "train.bin", tmp_path / "port" / "val.bin")
    dtype = np.uint32 if case == "uint32" else np.uint16
    n_tokens = 0
    for name in ("train.bin", "val.bin"):
        data = (tmp_path / "port" / name).read_bytes()
        assert data == (tmp_path / "jax" / name).read_bytes(), name
        ids = np.frombuffer(data, dtype)
        assert ids.size > 0 and ids[-1] == 1  # eos after every document
        n_tokens += ids.size
    # every document's words, its bos where the tokenizer adds one, its eos
    bos = 0 if case == "datasetdict" else 1
    assert n_tokens == sum(len(d.split()) + bos + 1 for d in docs)
    if case == "uint32":
        ids = np.fromfile(tmp_path / "port" / "train.bin", np.uint32)
        assert ids.max() >= 2**16
