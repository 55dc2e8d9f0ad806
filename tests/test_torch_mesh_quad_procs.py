"""Training layouts over four processes (gloo on the CPU), in float32,
every job of the module in one set of four processes (the `ENTRY` of
`tests/test_torch_ep_beside_procs.py`, each job on its own port), each
process under its own subprocess time limit; the references are computed
in this process while the four run:

- {"dp": 2, "ep": 2} on a tiny Mixtral, one (dp, ep) position per
  process: each holds one dp row and one ep rank's experts, the tokens
  split over dp x ep as the JAX dispatch's `dp_axis` splits them, the
  exchange within each dp row, the gradients summed over the dp group;
  at exact capacity and at capacity factor 0.5 (the JAX drops, which
  depend on every row), the aux weighted, clipping engaged;
- {"dp": 1, "sp": 2, "tp": 2} on pythia-14m, one (sp, tp) position per
  process: the ring runs per tp rank over its sp group, the tp partial
  sums meet in the tp group, the K/V gather's backward sums every
  process's cotangent; on the dense route and on the flash route (K2's,
  K3's and K4's plain versions, each process's rank running P of the
  ring's P^2 blocks per layer);
- {"ep": 2, "tp": 2} on the tiny Mixtral, one (ep, tp) position per
  process, at capacity factor 0.5: the experts split over the ep group,
  the Megatron leaves over the tp group, a process past the first of both
  counting no leaf in the clip's norm.

Three steps give the one-process port's losses (rtol 1e-5) and
parameters (rtol 2e-4, atol 2e-5) on the same mesh, and the JAX meshed
Trainer's (the sp mesh's parameters at the sp Trainer tests' rtol 3e-4,
atol 3e-5; the flash route, which the JAX Trainer refuses on a mesh, only
its losses against the JAX dense route's, at rtol 2e-4); every process holds the global loss; at exact capacity (and on the
sp mesh) the first step's gradients equal the dense (unmeshed) run's
within `grad_limit`.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config
from tests.test_torch_ep_beside_procs import (
    B,
    TOL,
    T,
    collect,
    grads_within_limit,
    jax_trainer_run,
    port_trainer_run,
    spawn,
    trainer_case,
)
from tests.test_torch_mesh_training_procs import _free_port

torch.set_num_threads(1)
MESHES = {"dp2-ep2": {"dp": 2, "ep": 2}, "sp2-tp2": {"dp": 1, "sp": 2, "tp": 2},
          "ep2-tp2": {"ep": 2, "tp": 2}}
# (mesh id, capacity factor, flash route)
JOBS = [("dp2-ep2", None, False), ("dp2-ep2", 0.5, False), ("sp2-tp2", None, False),
        ("sp2-tp2", None, True), ("ep2-tp2", 0.5, False)]
SP_T = 32  # the sp Trainer's block: a chunk of 16 per sp rank
SP_TOL = dict(rtol=3e-4, atol=3e-5)  # tests/test_torch_sp_training.py's, against JAX


def _config(m):
    if m == "sp2-tp2":
        return JConfig.from_name("pythia-14m", block_size=SP_T, n_layer=2)
    return moe_config(E=4, k=2, n_layer=2, block_size=T)


@pytest.fixture(scope="module")
def quad(tmp_path_factory, devices):
    tmp = tmp_path_factory.mktemp("quad-procs")
    train, cases = [], {}
    for i, (m, cf, flash) in enumerate(JOBS):
        cfg = _config(m)
        kw = dict(use_flash=True, remat=True) if flash else {}
        case = cases[(m, cf, flash)] = trainer_case(cfg, 5, cf, block=cfg.block_size, **kw)
        jp, tp, jt, tc, x, y = case
        torch.save(tp, tmp / f"job-{i}-params.pt")
        np.savez(tmp / f"job-{i}-batches.npz", x=x, y=y)
        train.append({"cfg": cfg.asdict(), "tc": asdict(tc), "axes": MESHES[m],
                      "params": str(tmp / f"job-{i}-params.pt"),
                      "batches": str(tmp / f"job-{i}-batches.npz"),
                      "out": str(tmp / f"job-{i}-out.pt"),
                      "grads": None if cf else str(tmp / f"job-{i}-grads.pt"),
                      "port": _free_port()})
    spec = {"gen": [], "train": train}
    procs = spawn(spec, 4)
    try:
        refs = {}
        for m, cf, flash in JOBS:
            cfg = _config(m)
            jp, tp, jt, tc, x, y = cases[(m, cf, flash)]
            # the JAX Trainer runs its dense route (it refuses the flash one on
            # a mesh): the flash job's reference is the dense job's
            jax_ref = None if flash else jax_trainer_run(cfg, jp, jt, MESHES[m], x, y)
            refs[(m, cf, flash)] = (
                jax_ref, port_trainer_run(cfg, tp, tc, make_mesh(MESHES[m], ["cpu"]), x, y),
                None if cf else port_trainer_run(cfg, tp, tc, None, x, y))
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return tmp, collect(procs, spec), refs


@pytest.mark.parametrize("job", JOBS, ids=[f"{m}-cf{cf}-{'flash' if f else 'dense'}"
                                           for m, cf, f in JOBS])
def test_trainer_over_four_processes_matches_jax_and_one_process(quad, job):
    tmp, recs, refs = quad
    m, cf, flash = job
    i = JOBS.index(job)
    jax_ref, (one_losses, one, one_grads), dense = refs[job]
    if flash:
        jax_ref = refs[(m, cf, False)][0]
    got_recs = [r["TRAIN"][i] for r in recs]
    assert all(r["losses"] == got_recs[0]["losses"] for r in got_recs)  # the global loss
    got = [t.detach().numpy() for t in ttf.tree_leaves(torch.load(tmp / f"job-{i}-out.pt"))]
    np.testing.assert_allclose(got_recs[0]["losses"], one_losses, rtol=1e-5)
    np.testing.assert_allclose(got_recs[0]["losses"], jax_ref[0],
                               rtol=2e-4 if flash else 1e-5)
    # the JAX sp Trainer is held at tests/test_torch_sp_training.py's sp
    # tolerance: the one-process port on this mesh differs from it by
    # 1.02x TOL at one embedding entry (2.46e-5 after three AdamW steps)
    refs = [(one, TOL)] + ([] if flash else [(jax_ref[1], SP_TOL if m == "sp2-tp2" else TOL)])
    for ref, tol in refs:
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **tol)
    # the groups: dp x ep splits the dp rows (dp group) and each row's ep
    # ranks (ep group); sp x tp each tp rank's sp group (the ring, and the
    # gradients' sum: the dp group holds the other sp chunks) and each sp
    # rank's tp group; ep x tp each tp rank's ep group and each ep rank's
    # tp group
    want = {"dp2-ep2": {"dp": [[0, 2], [1, 3]], "ep": [[0, 1], [2, 3]]},
            "sp2-tp2": {"dp": [[0, 2], [1, 3]], "sp": [[0, 2], [1, 3]], "tp": [[0, 1], [2, 3]]},
            "ep2-tp2": {"ep": [[0, 2], [1, 3]], "tp": [[0, 1], [2, 3]]}}[m]
    for p, r in enumerate(got_recs):
        for k in ("tp", "ep", "dp", "sp"):
            assert r["groups"][k] == (next(g for g in want[k] if p in g) if k in want
                                      else None)
    n_layer = _config(m).n_layer
    # per process and step: its one dp row's layers (dp x ep), or its
    # rank's P = 2 ring blocks per layer (sp x tp); K2 twice with remat
    runs = 3 * n_layer * (2 if m == "sp2-tp2" else 1)
    assert [r["layer_runs"] for r in got_recs] == [runs] * 4
    assert [r["plain"] for r in got_recs] == [[2 * runs, runs, runs] if flash else [0] * 3] * 4
    if cf is None:  # the first step's gradients: the dense run's, summed once
        grads = torch.load(tmp / f"job-{i}-grads.pt")
        n_terms = B * _config(m).block_size
        grads_within_limit(grads, dense[2], n_terms)
        grads_within_limit(grads, one_grads, n_terms)
