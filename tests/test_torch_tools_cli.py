"""The port's console utilities (`utils/console.py`) and its
`cli.prepare_data` and `cli.evaluate` against the JAX package's, on the
CPU: the counterparts of `tests/test_tools_cli.py::test_console_utils`
and `::test_evaluate_cli`, plus

- the console functions' output equal to the JAX copies' on the same
  inputs;
- `cli.prepare_data`'s train.bin and val.bin byte-identical to the JAX
  CLI's, from one text file and one word-level tokenizer;
- `cli.evaluate`'s JSON line with the JAX CLI's keys and a loss within
  1e-4 of the JAX CLI's on the same float32 checkpoint and seed, and
  equal to `training.cross_entropy_loss` on the same batches; without
  `--device cpu` on a machine without a GPU it raises.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.models import init_params
from mdi_llm_tpu.utils import console as jconsole
from mdi_llm_tpu.utils.checkpoint import save_checkpoint as jsave
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.training import cross_entropy_loss
from mdi_llm_tpu_torch.utils import checkpoint as tck
from mdi_llm_tpu_torch.utils import console, data_loader

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(name="toy-llama", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=4,
           n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
           parallel_residual=False, bias=False, norm_class_name="RMSNorm",
           mlp_class_name="LLaMAMLP", intermediate_size=64)
N_WORDS = 96


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The JAX test's toy checkpoint, written by each package from the same
    float32 weights, and a word-level tokenizer beside it."""
    root = tmp_path_factory.mktemp("tools")
    jc = JConfig(**TOY)
    jp = init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    jdir, tdir = root / "jax", root / "port"
    jsave(jp, jc, jdir)
    tck.save_checkpoint(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)),
                        TConfig(**TOY), tdir)
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"w{i}": i for i in range(3, N_WORDS)}}
    tok = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
           "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
           "post_processor": None, "decoder": None,
           "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    for d in (jdir, tdir):
        (d / "tokenizer.json").write_text(json.dumps(tok))
        (d / "tokenizer_config.json").write_text(json.dumps(
            {"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))
    return jdir, tdir


def _bins(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    data_dir = tmp_path / "bins"
    data_dir.mkdir()
    for split, n in (("train", 4096), ("val", 2048)):
        rng.integers(0, 96, n).astype(np.uint16).tofile(data_dir / f"{split}.bin")
    return data_dir


def test_console_utils(capsys):
    assert console.loading_bar(0, 10) == "[" + " " * 20 + "]"
    assert console.loading_bar(10, 10) == "[" + "=" * 20 + "]"
    mid = console.loading_bar(5, 10)
    assert mid.count("=") == 9 and ">" in mid
    buf = io.StringIO()  # not a tty: the spinner stays silent
    with console.waiting_animation("busy", stream=buf):
        pass
    assert buf.getvalue() == ""
    small, big = console.get_obj_size([1]), console.get_obj_size([list(range(100)), "x" * 1000])
    assert big > small > 0


def test_console_utils_print_what_the_jax_copies_print():
    for args in [(0, 10), (10, 10), (5, 10), (3, 7, 30), (1, 0), (12, 10), (2, 9, 10, "#")]:
        assert console.loading_bar(*args) == jconsole.loading_bar(*args)
    for obj in ([1], {"a": [1, 2, (3, "x" * 50)]}, [list(range(100)), "x" * 1000]):
        assert console.get_obj_size(obj) == jconsole.get_obj_size(obj)

    class Tty(io.StringIO):
        def isatty(self):
            return True

    mine, theirs = Tty(), Tty()
    for mod, stream in ((console, mine), (jconsole, theirs)):
        with mod.waiting_animation("busy", stream=stream, interval=0.05):
            pass
    # the frames written before the stop are timing-dependent; the erase is not
    assert mine.getvalue().endswith("\r" + " " * 6 + "\r")
    assert theirs.getvalue().endswith("\r" + " " * 6 + "\r")


def test_prepare_data_bins_are_the_jax_clis_bytes(ckpts, tmp_path):
    from mdi_llm_tpu.cli.prepare_data import main as jmain
    from mdi_llm_tpu_torch.cli.prepare_data import main

    jdir, tdir = ckpts
    rng = np.random.default_rng(4)
    text = tmp_path / "input.txt"
    text.write_text("\n".join(" ".join(f"w{i}" for i in rng.integers(0, N_WORDS + 4, 13))
                              for _ in range(300)))
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jmain(["--dataset", str(text), "--ckpt", str(jdir), "--out", str(jout)])
    train_p, val_p = main(["--dataset", str(text), "--ckpt", str(tdir), "--out", str(tout),
                           "--frac-train", "0.9"])
    for split in ("train", "val"):
        mine, theirs = (tout / f"{split}.bin").read_bytes(), (jout / f"{split}.bin").read_bytes()
        assert mine == theirs and len(mine) > 0
    assert (train_p, val_p) == (tout / "train.bin", tout / "val.bin")
    # the default output directory is the text file's
    main(["--dataset", str(text), "--ckpt", str(tdir), "--frac-train", "0.5"])
    assert (tmp_path / "train.bin").stat().st_size == (tmp_path / "val.bin").stat().st_size


def test_evaluate_cli(ckpts, tmp_path, capsys):
    """The JAX test on the port's CLI: a JSON line with the JAX CLI's keys,
    a loss near ln(96) for random tokens."""
    from mdi_llm_tpu_torch.cli.evaluate import main

    _, tdir = ckpts
    data_dir = _bins(tmp_path)
    rc = main(["--ckpt", str(tdir), "--dataset", str(data_dir), "--split", "val",
               "--eval-iters", "2", "--batch-size", "2", "--block-size", "32",
               "--dtype", "float32", "--device", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert 2.0 < rec["loss"] < 8.0
    assert rec["perplexity"] > 1.0 and rec["split"] == "val"
    assert set(rec) == {"ckpt", "split", "tokens", "eval_iters", "loss", "perplexity"}


@pytest.mark.parametrize("split,block", [("val", 32), ("train", 64)])
def test_evaluate_cli_loss_matches_the_jax_cli(ckpts, tmp_path, capsys, split, block):
    from mdi_llm_tpu.cli.evaluate import main as jmain
    from mdi_llm_tpu_torch.cli.evaluate import main

    jdir, tdir = ckpts
    data_dir = _bins(tmp_path, seed=1)
    common = ["--dataset", str(data_dir), "--split", split, "--eval-iters", "3",
              "--batch-size", "2", "--block-size", str(block), "--dtype", "float32",
              "--seed", "7"]
    jmain(["--ckpt", str(jdir), "--device", "cpu", *common])
    theirs = json.loads(capsys.readouterr().out.strip())
    main(["--ckpt", str(tdir), "--device", "cpu", *common])
    mine = json.loads(capsys.readouterr().out.strip())
    assert abs(mine["loss"] - theirs["loss"]) <= 1e-4
    for k in ("split", "tokens", "eval_iters"):
        assert mine[k] == theirs[k]
    # the port's own loss on the same batches (the CLI rounds to 4 places)
    cfg, params = tck.load_checkpoint(tdir, dtype=torch.float32)
    data = data_loader.open_bin(data_dir / f"{split}.bin")
    rng = np.random.default_rng(7)
    with torch.no_grad():
        losses = [float(cross_entropy_loss(cfg, params, *(torch.from_numpy(a) for a in
                                                          data_loader.get_batch(data, 2, block, rng)),
                                           remat=False)) for _ in range(3)]
    assert abs(mine["loss"] - np.mean(losses)) <= 1e-4


def test_evaluate_cli_refuses_a_short_bin_and_needs_the_card(ckpts, tmp_path):
    from mdi_llm_tpu_torch.cli.evaluate import main

    _, tdir = ckpts
    data_dir = tmp_path / "short"
    data_dir.mkdir()
    np.arange(20, dtype=np.uint16).tofile(data_dir / "val.bin")
    with pytest.raises(SystemExit, match="need more than"):
        main(["--ckpt", str(tdir), "--dataset", str(data_dir), "--block-size", "32",
              "--device", "cpu", "--dtype", "float32"])
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "mdi_llm_tpu_torch.cli.evaluate", "--ckpt", str(tdir),
             "--dataset", str(_bins(tmp_path))],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)))
        assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
