"""The port's single-device training against the JAX package's, on the CPU.

- `get_lr` / `lr_schedule`, the AdamW decay mask, one AdamW update
  against optax, `cross_entropy_loss`, `count_params` / `cast_params`:
  equal to the JAX package's on the same params (`params_from_numpy`).
- `Trainer.train_step`: 3 optimizer steps of 2 micro-batches, float32, on
  `tests/test_model.tiny_config` (MHA) and a GQA variant, the port with
  remat off/on and `use_flash` off/on (on the CPU, K2-K4's plain versions
  through the autograd Function), all against the JAX Trainer without
  flash (Pallas does not run un-interpreted on the CPU) and without remat
  (the JAX package's remat changes no number).  Losses within 1e-5
  relative, params within `tests/test_training.py`'s mesh tolerances
  (rtol 2e-4, atol 2e-5).
- `fit` histories equal to the JAX Trainer's for the same seed; save and
  resume exact; the NumPy and native loaders give the JAX package's
  batches.
- The train CLI on the CPU, then `--init resume`; without a GPU it
  raises; `--mesh` and `--coordinator` are refused, `--init hf` without
  weights in `--ckpt` too, and the Trainer refuses meshes and MoE.
"""

import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.utils import data_loader as jdl
from mdi_llm_tpu.utils import native_loader as jnl
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.cli import train as train_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import flash as tflash
from mdi_llm_tpu_torch.utils import data_loader as tdl
from mdi_llm_tpu_torch.utils import native_loader as tnl
from tests.test_model import CONFIG_VARIANTS, tiny_config
from tests.test_training import small_tc, toy_data

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CONFIGS = {"mha": {}, "gqa": {"n_query_groups": 2}}
MODES = {  # port (remat, use_flash)
    "dense": (False, False), "remat": (True, False),
    "flash": (False, True), "remat-flash": (True, True),
}
N_STEPS = 3


def port_tc(**kw):
    return ttr.TrainingConfig(**asdict(small_tc(**kw)))


def port_cfg(jc):
    return TConfig(**jc.asdict())


def jax_params(jc, seed=0):
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def leaves_np(tree):
    return [x.detach().numpy() for x in ttf.tree_leaves(tree)]


def step_batches(seed=0):
    data = toy_data()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        xs = np.empty((2, 4, 16), np.int32)
        ys = np.empty_like(xs)
        for m in range(2):
            xs[m], ys[m] = jdl.get_batch(data, 4, 16, rng)
        out.append((xs, ys))
    return out


def test_lr_schedule_and_get_lr_match_jax():
    for kw in (dict(warmup_iters=10, lr_decay_iters=200), dict(warmup_iters=0),
               dict(decay_lr=False)):
        jt, tt = small_tc(**kw), port_tc(**kw)
        js, ts = jtr.lr_schedule(jt), ttr.lr_schedule(tt)
        for it in [0, 1, 5, 10, 50, 150, 200, 300]:
            assert ttr.get_lr(it, tt) == jtr.get_lr(it, jt), (kw, it)
            want = float(js(it)) if callable(js) else js
            got = float(ts(it)) if callable(ts) else ts
            assert np.isclose(got, want, rtol=1e-6, atol=0), (kw, it)


@pytest.mark.parametrize("variant", ["llama", "neox", "gpt2"])
def test_decay_mask_matches_jax(variant):
    """The JAX mask read off an update with zero gradients: only decayed
    leaves move."""
    jc = tiny_config(**CONFIG_VARIANTS[variant])
    jp, tp = jax_params(jc)
    opt = jtr.make_optimizer(jtr.TrainingConfig(decay_lr=False, learning_rate=1.0))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    upd, _ = opt.update(zeros, opt.init(jp), jp)
    want = jax.tree_util.tree_map(lambda u: bool(np.any(np.asarray(u) != 0)), upd)
    assert ttr.decay_mask(tp) == want


@pytest.mark.parametrize("clip", [0.05, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_optax(clip):
    jc = tiny_config(n_layer=2)
    jp, tp = jax_params(jc)
    kw = dict(grad_clip=clip, warmup_iters=1, lr_decay_iters=10, learning_rate=1e-2)
    opt = jtr.make_optimizer(small_tc(**kw))
    state = opt.init(jp)
    mine = ttr.AdamW(port_tc(**kw), tp)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.01, jp)
        upd, state = opt.update(g, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        mine.update(ttf.tree_leaves(tp), [torch.from_numpy(x) for x in
                                          jax.tree_util.tree_leaves(g)])
    for a, b in zip(jax.tree_util.tree_leaves(jp), leaves_np(tp)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("remat,use_flash", [(False, False), (True, True)],
                         ids=["dense", "remat-flash"])
def test_cross_entropy_matches_jax(remat, use_flash):
    jc = tiny_config(n_query_groups=2)
    jp, tp = jax_params(jc)
    rng = np.random.default_rng(3)
    x, y = jdl.get_batch(toy_data(), 3, 24, rng)
    want = float(jtr.cross_entropy_loss(jc, jp, jnp.asarray(x), jnp.asarray(y)))
    got = ttr.cross_entropy_loss(port_cfg(jc), tp, torch.from_numpy(x),
                                 torch.from_numpy(y), remat=remat, use_flash=use_flash)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_count_and_cast_params_match_jax():
    jc = tiny_config(**CONFIG_VARIANTS["neox"])
    jp, tp = jax_params(jc)
    assert ttf.count_params(tp) == jtf.count_params(jp)
    cast = ttf.cast_params(tp, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in ttf.tree_leaves(cast))
    jcast = jtf.cast_params(jp, jnp.bfloat16)
    for a, b in zip(jax.tree_util.tree_leaves(jcast), ttf.tree_leaves(cast)):
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    """The JAX Trainer's losses and final params over the shared batches."""
    jc = tiny_config(block_size=32, **CONFIGS[request.param])
    jp, tp = jax_params(jc)
    tr = jtr.Trainer(jc, small_tc(use_flash=False), params=jp)
    losses = [tr.train_step(xs, ys) for xs, ys in step_batches()]
    params = [np.asarray(x) for x in jax.tree_util.tree_leaves(tr.params)]
    return jc, tp, losses, params


@pytest.mark.parametrize("mode", list(MODES))
def test_train_steps_match_jax(jax_run, mode):
    jc, tp, want_losses, want_params = jax_run
    remat, use_flash = MODES[mode]
    tr = ttr.Trainer(port_cfg(jc), port_tc(remat=remat, use_flash=use_flash),
                     params=tp, device="cpu")
    assert tr.use_flash is use_flash
    calls = tflash.flash_dq_plain.calls, tflash.flash_dkv_plain.calls
    losses = [tr.train_step(xs, ys) for xs, ys in step_batches()]
    n_bwd = jc.n_layer * 2 * N_STEPS if use_flash else 0
    assert (tflash.flash_dq_plain.calls - calls[0],
            tflash.flash_dkv_plain.calls - calls[1]) == (n_bwd, n_bwd)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for got, want in zip(leaves_np(tr.params), want_params):
        np.testing.assert_allclose(got, want, **PARAM_TOL)
    # the caller's params are not updated in place
    assert all(np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(ttf.tree_leaves(tp), ttf.tree_leaves(jax_params(jc)[1])))


def test_fit_history_matches_jax():
    jc = tiny_config(block_size=16, n_layer=2)
    kw = dict(max_iters=12, ckpt_interval=5, grad_acc_steps=1, patience=50)
    jp, tp = jax_params(jc)
    train, val = jdl.split_dataset(toy_data(2048))
    want = jtr.Trainer(jc, small_tc(**kw), params=jp).fit(train, val)
    got = ttr.Trainer(port_cfg(jc), port_tc(**kw), params=tp, device="cpu").fit(train, val)
    assert got["iter_num"] == want["iter_num"] == 12
    assert [sorted(h) for h in got["history"]] == [sorted(h) for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        assert g["iter"] == w["iter"]
        for key in ("loss", "val_loss"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=LOSS_RTOL)


def test_save_resume_exact(tmp_path):
    cfg = port_cfg(tiny_config(block_size=16, n_layer=2))
    data = toy_data(1024)
    tc = port_tc(grad_acc_steps=1)
    tr = ttr.Trainer(cfg, tc, out_dir=tmp_path / "run", device="cpu")
    rng = np.random.default_rng(2)

    def batch():
        x, y = tdl.get_batch(data, tc.batch_size, tc.block_size, rng)
        return x[None], y[None]

    for _ in range(3):
        tr.train_step(*batch())
    tr.save(tmp_path / "run")
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "model_config.yaml", "opt_state.pt", "params.pt", "train_state.json"]
    state = json.loads((tmp_path / "run" / "train_state.json").read_text())
    assert sorted(state) == ["best_val_loss", "iter_num", "training_config"]
    b4, b5 = batch(), batch()
    tr.train_step(*b4)
    l5_orig = tr.train_step(*b5)

    tr2 = ttr.Trainer.resume(tmp_path / "run", device="cpu")
    assert tr2.iter_num == 3 and tr2.optimizer.count == 3
    assert tr2.cfg.asdict() | {"hf_config": None} == cfg.asdict() | {"hf_config": None}
    tr2.train_step(*b4)
    l5_res = tr2.train_step(*b5)
    assert np.isclose(l5_orig, l5_res, rtol=1e-6)
    for a, b in zip(leaves_np(tr.params), leaves_np(tr2.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_data_loader_matches_jax(tmp_path):
    class FakeTok:
        def encode(self, text, bos=False):
            return np.asarray([ord(c) % 256 for c in text], np.int32)

    data = toy_data(4096)
    for seed in (0, 1):
        want = jdl.get_batch(data, 3, 8, np.random.default_rng(seed))
        got = tdl.get_batch(data, 3, 8, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(tdl.split_dataset(data, 0.8), jdl.split_dataset(data, 0.8)):
        np.testing.assert_array_equal(g, w)
    src = tmp_path / "corpus.txt"
    src.write_text("hello world " * 300)
    paths = (tdl.prepare_bin(src, tmp_path / "t", FakeTok()),
             jdl.prepare_bin(src, tmp_path / "j", FakeTok()))
    for tp, jp in zip(*paths):
        assert tp.read_bytes() == jp.read_bytes()
        np.testing.assert_array_equal(tdl.open_bin(tp), jdl.open_bin(jp))


@pytest.fixture(scope="module")
def native_ok():
    if not (tnl.is_available() and jnl.is_available()):
        pytest.skip("no C++ toolchain / native build failed")


def test_native_loader_matches_jax(tmp_path, native_ok):
    p = tmp_path / "train.bin"
    toy_data(5000).tofile(p)
    mine, ref = tnl.NativeBinDataset(p, seed=42), jnl.NativeBinDataset(p, seed=42)
    assert len(mine) == len(ref) == 5000
    np.testing.assert_array_equal(mine.read(100, 50), ref.read(100, 50))
    for _ in range(3):
        for g, w in zip(mine.get_batch(4, 16), ref.get_batch(4, 16)):
            np.testing.assert_array_equal(g, w)
    mine.close()
    ref.close()


def _dataset(tmp_path):
    ds = tmp_path / "data"
    ds.mkdir()
    train, val = jdl.split_dataset(toy_data(4096))
    train.tofile(ds / "train.bin")
    val.tofile(ds / "val.bin")
    return ds


CLI_RUN = ["--model", "pythia-14m", "--dtype", "float32", "--batch-size", "2",
           "--block-size", "32", "--warmup-iters", "0", "--learning-rate", "1e-3",
           "--log-interval", "1", "--eval-iters", "1", "--ckpt-interval", "1"]


def test_train_cli_on_cpu_then_resume(tmp_path):
    ds, ck = _dataset(tmp_path), tmp_path / "ckpt"
    argv = [*CLI_RUN, "--dataset", str(ds), "--ckpt", str(ck), "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "mdi_llm_tpu_torch.cli.train", *argv, "--max-iters", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [ln["iter"] for ln in lines if "loss" in ln] == [1, 2]
    assert all(np.isfinite(ln["loss"]) for ln in lines)
    assert "finished at iter 2" in proc.stdout
    assert (ck / "params.pt").exists() and (ck / "model_config.yaml").exists()
    result, trainer = train_cli.main([*argv, "--init", "resume", "--max-iters", "3"])
    assert result["iter_num"] == 3 and trainer.optimizer.count == 3
    # resumed at iter 2: evaluated (ckpt_interval 1), then one step
    assert [h["iter"] for h in result["history"] if "val_loss" in h] == [2]
    assert [h["iter"] for h in result["history"] if "loss" in h] == [3]


def test_train_cli_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    argv = [*CLI_RUN, "--dataset", str(_dataset(tmp_path)), "--ckpt", str(tmp_path / "c")]
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        train_cli.main([*argv, "--max-iters", "1"])


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh", "dp=2"], SystemExit, "not ported"),
    # --init hf is ported: a --ckpt with neither params.pt nor HF weights
    # is refused before any work
    (["--init", "hf"], FileNotFoundError, r"no \*.safetensors or \*.bin weights"),
    (["--coordinator", "localhost:1234"], SystemExit, "not ported"),
], ids=["--mesh", "--init", "--coordinator"])
def test_train_cli_refuses_unported_flags(tmp_path, flags, error, match):
    argv = [*CLI_RUN, "--dataset", str(tmp_path), "--device", "cpu",
            "--ckpt", str(tmp_path), *flags]
    with pytest.raises(error, match=match):
        train_cli.main(argv)


def test_trainer_refuses_meshes_and_moe():
    cfg = port_cfg(tiny_config())
    with pytest.raises(NotImplementedError, match="mesh"):
        ttr.Trainer(cfg, port_tc(), mesh={"dp": 2}, device="cpu")
    moe = port_cfg(tiny_config(**CONFIG_VARIANTS["moe"]))
    with pytest.raises(ValueError, match="not ported"):
        ttr.Trainer(moe, port_tc(), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        ttr.Trainer(cfg, port_tc(moe_aux_weight=0.0), device="cpu")
    # the flash gate: CUDA and block_size >= 2048 only, unless asked for
    assert ttr.Trainer(cfg, port_tc(block_size=16), device="cpu").use_flash is False
    assert ttr.Trainer(cfg, port_tc(use_flash=True), device="cpu").use_flash is True
