"""The port's meshed Trainer against the JAX package's, on the CPU.

- `Trainer(mesh=make_mesh(axes, ["cpu"]))` for dp, tp and dp x tp on a
  2-layer config and GPipe pp, dp x pp and dp x pp x tp on a 5-layer one
  (the cases of `tests/test_training.py`): three float32 optimizer steps
  on the same batches from the same weights (`params_from_numpy`) give
  the JAX meshed Trainer's parameters in the standard layout within that
  file's tolerance (rtol 2e-4, atol 2e-5), and its losses within 1e-5.
  The JAX Trainer runs its meshes on the dense route (it refuses flash on
  dp/tp/pp); the port runs both its dense route and `use_flash=True`,
  which on the CPU sends every rank's attention through K2-K4's plain
  versions inside the autograd Function, with remat (K2 twice per layer
  run): the plain versions' calls equal the Trainer's `layer_runs`.
- Clipping engaged (`grad_clip` 0.05, far below the first gradient's
  norm) on tp and dp x tp, and the tiny MoE config at tp 2 with its aux
  weight; the port's eval is pure cross-entropy, as the JAX Trainer's.
- The guards: batch divisibility (dp, and dp x pp), tp divisibility, an
  ep mesh on a dense config (the JAX package's words; sp and ep run in
  tests/test_torch_sp_training.py and test_torch_expert.py), a mesh over
  processes that splits a pp group.  Save and resume on a pp mesh, from a mesh to none and from
  none to a mesh: the next loss equal.
- `make_mesh` over processes: each owns a contiguous block of positions;
  the Generator refuses such a mesh (item 14's next part).
"""

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
from tests.test_model import CONFIG_VARIANTS, tiny_config
from tests.test_training import small_tc, toy_data

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
N_STEPS = 3
CLIP = 0.05

# id: (config overrides, mesh axes, batch size, grad_clip)
CASES = {
    "dp4": (dict(n_layer=2), {"dp": 4}, 4, 1.0),
    "tp2": (dict(n_layer=2), {"tp": 2}, 4, 1.0),
    "dp2-tp2": (dict(n_layer=2), {"dp": 2, "tp": 2}, 4, 1.0),
    "pp2": (dict(n_layer=5), {"dp": 1, "pp": 2}, 4, 1.0),
    "dp2-pp4": (dict(n_layer=5), {"dp": 2, "pp": 4}, 8, 1.0),
    "dp2-pp2-tp2": (dict(n_layer=5), {"dp": 2, "pp": 2, "tp": 2}, 8, 1.0),
    "tp2-clipped": (dict(n_layer=2), {"tp": 2}, 4, CLIP),
    "dp2-tp2-clipped": (dict(n_layer=2), {"dp": 2, "tp": 2}, 4, CLIP),
    "moe-tp2": (dict(n_layer=2, **CONFIG_VARIANTS["moe"]), {"tp": 2}, 4, 1.0),
}
ROUTES = {"dense": dict(use_flash=False, remat=False), "flash": dict(use_flash=True, remat=True)}


def batches(batch, seed=1):
    data = toy_data(1024)
    rng = np.random.default_rng(seed)
    return [tuple(a[None] for a in jdl.get_batch(data, batch, 16, rng)) for _ in range(N_STEPS)]


def tcs(batch, clip, **kw):
    jt = small_tc(grad_acc_steps=1, batch_size=batch, grad_clip=clip, **kw)
    return jt, ttr.TrainingConfig(**asdict(jt))


def jax_params(jc):
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module", params=list(CASES))
def jax_mesh_run(request, devices):
    """The JAX meshed Trainer's losses and standard-layout params."""
    over, axes, batch, clip = CASES[request.param]
    jc = tiny_config(block_size=16, **over)
    jp, tp = jax_params(jc)
    n = int(np.prod(list(axes.values())))
    jt, _ = tcs(batch, clip, use_flash=False)
    tr = jtr.Trainer(jc, jt, mesh=jmesh.make_mesh(axes, devices[:n]), params=jp)
    losses = [tr.train_step(x, y) for x, y in batches(batch)]
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr._standard_params())]
    return request.param, jc, tp, losses, want


@pytest.mark.parametrize("route", list(ROUTES))
def test_mesh_train_steps_match_jax(jax_mesh_run, route):
    case, jc, tp, want_losses, want = jax_mesh_run
    _, axes, batch, clip = CASES[case]
    _, tc = tcs(batch, clip, **ROUTES[route])
    cfg = TConfig(**jc.asdict())
    tr = ttr.Trainer(cfg, tc, mesh=make_mesh(axes, ["cpu"]), params=tp, device="cpu")
    assert tr.use_flash is ROUTES[route]["use_flash"]
    before = (tflash.flash_attention_plain.calls, tflash.flash_dq_plain.calls,
              tflash.flash_dkv_plain.calls)
    losses = [tr.train_step(x, y) for x, y in batches(batch)]
    got_calls = np.subtract((tflash.flash_attention_plain.calls, tflash.flash_dq_plain.calls,
                             tflash.flash_dkv_plain.calls), before)
    # every rank runs every layer once per micro-batch: a pp ring runs S
    # micro-batches per dp shard
    runs = tr.layer_runs
    assert runs == N_STEPS * jc.n_layer * int(np.prod(list(axes.values())))
    want_calls = (2 * runs, runs, runs) if route == "flash" else (0, 0, 0)
    assert tuple(got_calls) == want_calls
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    got = [x.detach().numpy() for x in ttf.tree_leaves(tr._standard_params())]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PARAM_TOL)


def test_clipping_engages_in_the_clipped_cases():
    """The first step's gradient norm is far above `CLIP`, so the clipped
    cases of `test_mesh_train_steps_match_jax` scale every gradient: a
    replicated leaf counted twice in the norm would move them all."""
    jc = tiny_config(block_size=16, n_layer=2)
    _, tp = jax_params(jc)
    tp = ttf.tree_map(lambda x: x.requires_grad_(True), tp)
    x, y = (torch.from_numpy(a[0]).long() for a in batches(4)[0])
    loss = ttr.cross_entropy_loss(TConfig(**jc.asdict()), tp, x, y, remat=False)
    grads = torch.autograd.grad(loss, ttf.tree_leaves(tp))
    norm = float(torch.stack([g.square().sum() for g in grads]).sum().sqrt())
    assert norm > 10 * CLIP


def test_layer_runs_count_micro_batches_and_remat_launches():
    """dp 2 with 2 micro-batches runs every layer 2 x 2 times a step; with
    remat and the flash route each run calls K2's plain version twice and
    K3's and K4's once (on the card: the kernels, `chip_smoke.py`
    mesh-train)."""
    jc = tiny_config(block_size=16, n_layer=2)
    _, tp = jax_params(jc)
    tc = ttr.TrainingConfig(**asdict(small_tc(grad_acc_steps=2, use_flash=True, remat=True)))
    tr = ttr.Trainer(TConfig(**jc.asdict()), tc, mesh=make_mesh({"dp": 2}, ["cpu"]),
                     params=tp, device="cpu")
    xs = np.stack([b[0][0] for b in batches(4)[:2]])
    ys = np.stack([b[1][0] for b in batches(4)[:2]])
    k2 = tflash.flash_attention_plain.calls
    tr.train_step(xs, ys)
    assert tr.layer_runs == 2 * 2 * 2
    assert tflash.flash_attention_plain.calls - k2 == 2 * tr.layer_runs


def test_eval_is_pure_cross_entropy_as_jax():
    """An MoE config's eval loss leaves the aux out, on a mesh and off it,
    as the JAX Trainer's eval does."""
    jc = tiny_config(block_size=16, n_layer=2, **CONFIG_VARIANTS["moe"])
    jp, tp = jax_params(jc)
    jt, tc = tcs(4, 1.0)
    x, y = (a[0] for a in batches(4)[0])
    ref = jtr.Trainer(jc, jt, params=jp)
    want = float(ref._eval(ref.params, x, y))
    for mesh in (None, make_mesh({"dp": 2, "tp": 2}, ["cpu"])):
        tr = ttr.Trainer(TConfig(**jc.asdict()), tc, mesh=mesh, params=tp, device="cpu")
        assert tr.moe_aux_weight == 0.01
        np.testing.assert_allclose(tr.eval_loss(x, y), want, rtol=LOSS_RTOL)


def test_mesh_guards():
    cfg = TConfig(**tiny_config(block_size=16, n_layer=4).asdict())
    cpu = ["cpu"]
    with pytest.raises(ValueError, match="divide"):  # the JAX pp guard
        ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc(batch_size=5))),
                    mesh=make_mesh({"dp": 1, "pp": 2}, cpu), device="cpu")
    with pytest.raises(ValueError, match="divide by dp=2"):
        ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc(batch_size=5))),
                    mesh=make_mesh({"dp": 2}, cpu), device="cpu")
    with pytest.raises(ValueError, match="tp=3 does not divide"):
        ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc())),
                    mesh=make_mesh({"tp": 3}, cpu), device="cpu")
    # sp meshes are ported; ep needs an MoE config, in the JAX words
    assert ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc())),
                       mesh=make_mesh({"dp": 1, "sp": 2}, cpu), device="cpu").layout.sp == 2
    with pytest.raises(ValueError, match="'ep' mesh axis needs an MoE config"):
        ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc())),
                    mesh=make_mesh({"dp": 2, "ep": 2}, cpu), device="cpu")
    with pytest.raises(ValueError, match="axes"):
        ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc())),
                    mesh=make_mesh({"rows": 2}, cpu), device="cpu")
    with pytest.raises(ValueError, match="order dp, pp, tp"):
        # process 0 of 2 would hold stage 0 of both replicas
        ttr.MeshLayout(make_mesh({"pp": 2, "dp": 2}, cpu, process_id=0, num_processes=2))
    with pytest.raises(ValueError, match="whole tp group"):
        # each process would hold one stage's half of its tp group
        ttr.MeshLayout(make_mesh({"pp": 2, "tp": 2}, cpu, process_id=0, num_processes=4))
    with pytest.raises(ValueError, match="not the mesh's device"):
        ttr.Trainer(cfg, ttr.TrainingConfig(**asdict(small_tc())),
                    mesh=make_mesh({"dp": 2}, ["meta"]), device="cpu")


@pytest.mark.parametrize("first,then", [
    ({"dp": 1, "pp": 2}, {"dp": 1, "pp": 2}),
    ({"dp": 2, "pp": 2, "tp": 2}, None),
    (None, {"dp": 2, "tp": 2}),
], ids=["pp-to-pp", "mesh-to-none", "none-to-mesh"])
def test_save_resume_across_layouts(tmp_path, first, then):
    """A checkpoint written on one layout resumes on another with the same
    next loss and parameters: on disk everything is the standard layout."""
    jc = tiny_config(block_size=16, n_layer=4)
    _, tp = jax_params(jc)
    cfg = TConfig(**jc.asdict())
    _, tc = tcs(8, CLIP)
    mk = lambda axes: None if axes is None else make_mesh(axes, ["cpu"])  # noqa: E731
    tr = ttr.Trainer(cfg, tc, mesh=mk(first), params=tp, out_dir=tmp_path, device="cpu")
    (x1, y1), (x2, y2), _ = batches(8, seed=3)
    tr.train_step(x1, y1)
    tr.save(tmp_path)
    _, on_disk = ttr.load_checkpoint(tmp_path)
    assert on_disk["blocks"]["attn"]["qkv"]["weight"].shape[0] == cfg.n_layer
    want = tr.train_step(x2, y2)
    tr2 = ttr.Trainer.resume(tmp_path, mesh=mk(then), device="cpu")
    assert tr2.iter_num == 1 and tr2.optimizer.count == 1
    got = tr2.train_step(x2, y2)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for a, b in zip(ttf.tree_leaves(tr._standard_params()),
                    ttf.tree_leaves(tr2._standard_params())):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **PARAM_TOL)


def test_make_mesh_over_processes():
    """Each of P processes owns n / P contiguous positions, process-major,
    all on its one device; a Generator's processes split its tp and ep
    axes only, so a dp axis split over processes is refused (the
    two-process tp Generator is tests/test_torch_inference_procs.py's)."""
    from mdi_llm_tpu_torch.generation import Generator

    m = make_mesh({"dp": 2, "tp": 2}, ["cpu"], process_id=1, num_processes=2)
    assert (m.size, list(m.owned()), list(m.owned(0))) == (4, [2, 3], [0, 1])
    assert {str(d) for d in m.device_list()} == {"cpu"}
    for kw, match in ((dict(num_processes=3), "multiple"),
                      (dict(process_id=2, num_processes=2), "out of range")):
        with pytest.raises(ValueError, match=match):
            make_mesh({"dp": 2, "tp": 2}, ["cpu"], **kw)
    with pytest.raises(ValueError, match="one device"):
        make_mesh({"dp": 2}, ["cpu", "cpu"], process_id=0, num_processes=2)
    cfg = TConfig(**tiny_config(block_size=16, n_layer=2).asdict())
    params = ttf.init_params(cfg, 0)
    with pytest.raises(ValueError, match="split the tp and ep axes only"):
        Generator(cfg, params, max_seq_length=16, device="cpu", mesh=m)
