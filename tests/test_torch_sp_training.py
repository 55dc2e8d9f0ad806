"""The port's sequence-parallel and expert-parallel Trainers against the
JAX package's, on the CPU, in float32 (`tests/test_ring_attention.py`'s
and `tests/test_expert.py`'s training cases).

- `Trainer(mesh=make_mesh({"dp": 2, "sp": 4}))` and `{"dp": 2, "sp": 2,
  "tp": 2}` (each sp rank its chunk of every row, attention on the ring
  over the sp ranks, tp ranks inside each sp rank): three steps from the
  same weights on the same batches give the JAX sp Trainer's losses
  within rtol 2e-4 and its parameters within rtol 3e-4 / atol 3e-5, and
  the port's unmeshed Trainer's.  The JAX Trainer runs them on its dense
  route; the port runs its dense route and its flash route, which on the
  CPU sends every ring block through K2-K4's plain versions: K2 2 P^2,
  K3 and K4 P^2 calls per layer, tp rank and dp row group (remat).
- The MoE aux on a (dp, sp) mesh is the whole batch's: the router stats
  summed over dp and sp before the aux is formed.
- pp x sp and ep x sp are refused in the JAX package's words (sp and ep
  over processes: `tests/test_torch_sp_ep_training_procs.py`).
- `train --mesh dp=2,sp=2` and `dp=2,ep=2` on a converted tiny Mixtral
  (`--init hf`): the JAX CLI's loss lines.
"""

import shutil
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu.utils import data_loader as jdl
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import flash as tflash
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config
from tests.test_model import tiny_config
from tests.test_torch_expert import mixtral_ckpt  # noqa: F401  (a fixture)
from tests.test_training import small_tc, toy_data

torch.set_num_threads(1)
SP_MESHES = {"dp2-sp4": {"dp": 2, "sp": 4}, "dp2-sp2-tp2": {"dp": 2, "sp": 2, "tp": 2}}
ROUTES = {"dense": dict(use_flash=False, remat=False), "flash": dict(use_flash=True, remat=True)}
N_STEPS = 3


def batches(T=32, B=4, seed=3):
    data = toy_data(1024)
    rng = np.random.default_rng(seed)
    return [tuple(a[None] for a in jdl.get_batch(data, B, T, rng)) for _ in range(N_STEPS)]


def tcs(**kw):
    jt = small_tc(grad_acc_steps=1, block_size=32, batch_size=4, **kw)
    return jt, ttr.TrainingConfig(**asdict(jt))


def jax_params(jc):
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def port_run(jc, tp, tc, mesh, data):
    tr = ttr.Trainer(TConfig(**jc.asdict()), tc, mesh=mesh, params=tp, device="cpu")
    losses = [tr.train_step(x, y) for x, y in data]
    return losses, [x.detach().numpy() for x in ttf.tree_leaves(tr._standard_params())], tr


@pytest.fixture(scope="module", params=list(SP_MESHES))
def jax_sp_run(request, devices):
    """The JAX sp Trainer's losses and params, and the port's unmeshed run's."""
    axes = SP_MESHES[request.param]
    jc = tiny_config(block_size=32, n_layer=2)
    jp, tp = jax_params(jc)
    jt, tc = tcs(use_flash=False)
    tr = jtr.Trainer(jc, jt, mesh=jmesh.make_mesh(axes, devices), params=jp)
    losses = [tr.train_step(x, y) for x, y in batches()]
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.params)]
    single = port_run(jc, tp, tc, None, batches())
    return axes, jc, tp, losses, want, single


@pytest.mark.parametrize("route", list(ROUTES))
def test_sp_training_matches_jax_and_single_device(jax_sp_run, route):
    axes, jc, tp, want_losses, want, (single_losses, single, _) = jax_sp_run
    _, tc = tcs(**ROUTES[route])
    calls = lambda: np.array([tflash.flash_attention_plain.calls,  # noqa: E731
                              tflash.flash_dq_plain.calls, tflash.flash_dkv_plain.calls])
    before = calls()
    losses, got, tr = port_run(jc, tp, tc, make_mesh(axes, ["cpu"]), batches())
    P, tp_n = axes["sp"], axes.get("tp", 1)
    runs = N_STEPS * axes["dp"] * jc.n_layer * P * P * tp_n
    assert tr.layer_runs == runs
    want_calls = (2 * runs, runs, runs) if route == "flash" else (0, 0, 0)
    assert tuple(calls() - before) == want_calls
    for ref_losses, ref in ((want_losses, want), (single_losses, single)):
        np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5)


def test_sp_moe_training_aux_matches_single_device(devices):
    """MoE training on a (dp, sp) mesh applies the aux exactly (router
    stats summed over the mesh before the formula): the parameters after
    3 steps equal the JAX sp Trainer's and the port's unmeshed Trainer's
    at the same aux weight."""
    jc = moe_config(E=4, k=2, n_layer=2, block_size=32)
    jp, tp = jax_params(jc)
    rng = np.random.default_rng(21)
    data = rng.integers(0, jc.vocab_size, 2048).astype(np.int32)
    r = np.random.default_rng(2)
    steps = []
    for _ in range(3):
        i = r.integers(0, len(data) - 17, 4)
        steps.append((np.stack([data[j:j + 16] for j in i])[None],
                      np.stack([data[j + 1:j + 17] for j in i])[None]))
    kw = dict(batch_size=4, block_size=16, max_iters=3, dtype="float32", warmup_iters=1,
              moe_aux_weight=0.05, remat=True)
    jt = jtr.TrainingConfig(**kw)
    jtrainer = jtr.Trainer(jc, jt, mesh=jmesh.make_mesh({"dp": 2, "sp": 4}, devices), params=jp)
    for x, y in steps:
        jtrainer.train_step(x, y)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtrainer.params)]
    tc = ttr.TrainingConfig(**asdict(jt))
    _, single, _ = port_run(jc, tp, tc, None, steps)
    losses, got, tr = port_run(jc, tp, tc, make_mesh({"dp": 2, "sp": 4}, ["cpu"]), steps)
    assert tr.moe_aux_weight == 0.05
    for ref in (want, single):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_sp_eval_is_pure_cross_entropy():
    """An sp Trainer's eval leaves the MoE aux out, as the JAX Trainer's."""
    jc = tiny_config(block_size=32, n_layer=2, mlp_class_name="LLaMAMoE", n_expert=4,
                     n_expert_per_token=2)
    _, tp = jax_params(jc)
    _, tc = tcs()
    x, y = (a[0] for a in batches()[0])
    want = ttr.Trainer(TConfig(**jc.asdict()), tc, params=tp, device="cpu").eval_loss(x, y)
    tr = ttr.Trainer(TConfig(**jc.asdict()), tc, mesh=make_mesh({"dp": 2, "sp": 2}, ["cpu"]),
                     params=tp, device="cpu")
    assert tr.moe_aux_weight == 0.01
    np.testing.assert_allclose(tr.eval_loss(x, y), want, rtol=1e-5)


def test_pp_sp_and_ep_sp_refused_in_the_jax_words():
    cfg = TConfig(**tiny_config(block_size=32, n_layer=4).asdict())
    moe = TConfig(**moe_config(E=4, block_size=32).asdict())
    _, tc = tcs()
    cases = [(cfg, {"dp": 1, "pp": 2, "sp": 2}, r"pp composes with dp/tp only \(pp×sp"),
             (moe, {"dp": 1, "sp": 2, "ep": 2}, r"ep composes with dp only \(ep×sp/pp"),
             (cfg, {"dp": 1, "sp": 3}, "block_size 32 must divide by sp=3")]
    for c, axes, match in cases:
        with pytest.raises(ValueError, match=match):
            ttr.Trainer(c, tc, mesh=make_mesh(axes, ["cpu"]), device="cpu")
    jc = tiny_config(block_size=32, n_layer=4)
    with pytest.raises(ValueError, match=r"pp composes with dp/tp only \(pp×sp"):
        jtr.Trainer(jc, tcs()[0], mesh=jmesh.make_mesh({"dp": 1, "pp": 2, "sp": 2},
                                                       jax.devices()[:4]))


@pytest.mark.parametrize("mesh", ["dp=2,sp=2", "dp=2,ep=2", "ep=2,tp=2"])
def test_train_cli_sp_and_ep_loss_lines_equal_the_jax_clis(mixtral_ckpt, tmp_path, mesh,
                                                           capsys):
    """`train --init hf --mesh ...` on the same converted weights and
    dataset: the JAX CLI's loss lines (an MoE config: the sp aux and the
    ep dispatch both apply; ep beside tp reaches the Trainer with no
    other flag)."""
    from mdi_llm_tpu.cli import train as jcli
    from mdi_llm_tpu_torch.cli import train as tcli

    port_src, jax_src = mixtral_ckpt
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(port_src, port_dir)
    shutil.copytree(jax_src, jax_dir)
    ds = tmp_path / "data"
    ds.mkdir()
    np.random.default_rng(0).integers(0, 96, 4096).astype(np.uint16).tofile(ds / "train.bin")
    flags = ["--device", "cpu", "--init", "hf", "--dataset", str(ds), "--dtype", "float32",
             "--batch-size", "4", "--block-size", "16", "--max-iters", "3",
             "--learning-rate", "1e-3", "--warmup-iters", "0", "--log-interval", "1",
             "--mesh", mesh]
    want = jcli.main(flags + ["--ckpt", str(jax_dir)])
    result, trainer = tcli.main(flags + ["--ckpt", str(port_dir)])
    assert trainer.layout.sp * trainer.layout.ep == 2
    got = [h["loss"] for h in result["history"] if "loss" in h]
    assert len(got) == 3
    np.testing.assert_allclose(got, [h["loss"] for h in want["history"] if "loss" in h],
                               rtol=2e-4)
    capsys.readouterr()
