"""Expert parallelism beside tp in the port's Trainer, against the JAX
package's, on the CPU, in float32.

- Three steps on {"ep": 2, "tp": 2} and {"dp": 2, "ep": 2, "tp": 2} with
  the aux weighted, at exact capacity and at capacity factor 0.5: the JAX
  Trainer's losses (rtol 1e-5) and parameters (rtol 2e-4, atol 2e-5),
  `layer_runs` counting each dp row's tp ranks' layers;
- the first step's gradients through the ep x tp route equal the dense
  (unmeshed) ones at exact capacity, the router's and the experts' once;
- what stays refused: ep beside sp or pp (the JAX Trainer's words); ep
  beside tp over two processes lays out one ep rank with its tp group, or
  one tp rank with every expert, per process (the runs are
  tests/test_torch_ep_beside_procs.py's).
"""

from dataclasses import asdict
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config
from tests.test_training import small_tc

torch.set_num_threads(1)
MESHES = {"ep2-tp2": {"ep": 2, "tp": 2}, "dp2-ep2-tp2": {"dp": 2, "ep": 2, "tp": 2}}


def _tcs(**kw):
    jt = small_tc(grad_acc_steps=1, **kw)
    return jt, ttr.TrainingConfig(**asdict(jt))


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_ep_tp_trainer_steps_equal_the_jax_trainers(devices, mesh_id, cf):
    axes = MESHES[mesh_id]
    cfg = moe_config(E=8, k=2, n_layer=2)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(9))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jt, tc = _tcs(batch_size=4, block_size=16, moe_aux_weight=0.05, moe_capacity_factor=cf,
                  use_flash=False, remat=False)
    rng = np.random.default_rng(9)
    batches = [tuple(rng.integers(0, cfg.vocab_size, (1, 4, 16)).astype(np.int32)
                     for _ in range(2)) for _ in range(3)]
    n = int(np.prod(list(axes.values())))
    jtrainer = jtr.Trainer(cfg, jt, mesh=jmesh.make_mesh(axes, devices[:n]), params=jp)
    want = [jtrainer.train_step(x, y) for x, y in batches]
    tr = ttr.Trainer(TConfig(**cfg.asdict()), tc, mesh=make_mesh(axes, ["cpu"]), params=tp,
                     device="cpu")
    got = [tr.train_step(x, y) for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(ttf.tree_leaves(tr._standard_params()),
                    jax.tree_util.tree_leaves(jtrainer.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    # each step: every dp row's tp ranks run every layer once
    assert tr.layer_runs == 3 * cfg.n_layer * axes["tp"] * axes.get("dp", 1)


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_ep_tp_first_step_gradients_equal_the_dense_ones(mesh_id, remat):
    """The loss and the gradient of every leaf through the ep x tp route
    (the dispatch at exact capacity inside each dp row's tp ranks) equal
    the unmeshed dense formulation's, with the aux weighted: the router
    and the experts get the whole batch's gradient once."""
    cfg = TConfig(**moe_config(E=4, k=2, n_layer=2).asdict())
    params = ttf.init_params(cfg, 3, dtype=torch.float32)
    _, tc = _tcs(batch_size=4, block_size=16, moe_aux_weight=0.05, use_flash=False,
                 remat=remat)
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))) for _ in range(2))
    grads = {}
    for name, mesh in (("dense", None), ("mesh", make_mesh(MESHES[mesh_id], ["cpu"]))):
        tr = ttr.Trainer(cfg, tc, mesh=mesh, params=params, device="cpu")
        leaves = ttf.tree_leaves(tr.params)
        loss = tr._loss(x, y, remat)
        grads[name] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(grads["mesh"][0], grads["dense"][0], rtol=1e-5)
    for a, b in zip(grads["mesh"][1], grads["dense"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)


def test_ep_beside_sp_pp_and_over_processes_stay_refused():
    moe = TConfig(**moe_config(E=4).asdict())
    _, tc = _tcs()
    for axes in ({"dp": 1, "sp": 2, "ep": 2, "tp": 2}, {"dp": 1, "pp": 2, "ep": 2, "tp": 2}):
        with pytest.raises(ValueError, match=r"ep composes with dp only \(ep×sp/pp"):
            ttr.Trainer(moe, tc, mesh=make_mesh(axes, ["cpu"]), device="cpu")
    # over two processes: the groups each layout splits
    for axes, split, spans in (({"ep": 2, "tp": 2}, "ep", (0, 2, 1, 1)),
                               ({"tp": 2, "ep": 2}, "tp", (1, 1, 0, 2))):
        with mock.patch("mdi_llm_tpu_torch.training.CommGroup") as group:
            lay = ttr.MeshLayout(make_mesh(axes, ["cpu"], process_id=1, num_processes=2))
        group.assert_called_once_with([0, 1])
        assert (lay.tp_start, lay.tp_local, lay.ep_start, lay.ep_local) == spans
        assert {k: getattr(lay, k + "_group") for k in ("tp", "ep", "dp")} == {
            k: group.return_value if k == split else None for k in ("tp", "ep", "dp")}
    with pytest.raises(ValueError, match=r"ep composes with dp only \(ep×sp/pp"):
        jtr.Trainer(moe_config(E=4), _tcs()[0],
                    mesh=jmesh.make_mesh({"dp": 1, "sp": 2, "ep": 2}, jax.devices()[:4]))
