"""Sequence- and expert-parallel training over two processes (gloo on the
CPU), every job of the module in one pair of processes (`ENTRY`: each job
of its own on its own port), each process under its own subprocess time
limit:

- `cli.train --coordinator ... --mesh sp=2` (pythia-14m, float32, the
  dense route and `--use-flash on`, one sp rank per process) and `--mesh
  dp=1,ep=2` on a tiny Mixtral (one ep rank and its experts per
  process), clipping engaged: the loss lines equal the one-process run's
  on the same mesh, and the checkpoint process 0 writes (params and
  AdamW moments, the experts gathered) holds the one-process run's
  within tests/test_training.py's mesh tolerance.  The flash run calls
  K2's, K3's and K4's plain versions in each process as the plan says:
  each process's rank runs P of the ring's P^2 blocks per layer.
- `training.Trainer` on `{"dp": 1, "sp": 2}` (an MoE config with the aux
  weighted: its assignments summed over the sp processes) and on `{"dp":
  1, "ep": 2}` at exact capacity and at a capacity factor that drops
  assignments: three steps from the JAX package's weights on the same
  batches give the JAX meshed Trainer's losses and parameters, and the
  port's one-process Trainer's.
- Layouts that split over four processes build every group in one order
  on every process (their runs are tests/test_torch_mesh_quad_procs.py's).
"""

import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.cli import train as train_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.models.transformer import tree_leaves
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config
from tests.test_torch_mesh_training_procs import _free_port, _lines, dataset  # noqa: F401
from tests.test_training import small_tc

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
PROC_TIMEOUT = 300
TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_training.py's mesh tolerance
RUN = ["--dtype", "float32", "--batch-size", "4", "--block-size", "32", "--warmup-iters", "0",
       "--learning-rate", "1e-3", "--log-interval", "1", "--eval-iters", "1",
       "--ckpt-interval", "1000", "--grad-clip", "0.05", "--device", "cpu", "--max-iters", "3"]
TINY_MOE = ["--model", "Mixtral-8x7B-v0.1", "--override", "n_layer=2", "--override",
            "n_embd=64", "--override", "n_head=4", "--override", "n_query_groups=2",
            "--override", "intermediate_size=128"]
CLI = {"sp": ["--model", "pythia-14m", "--mesh", "sp=2"],
       "sp-flash": ["--model", "pythia-14m", "--mesh", "sp=2", "--use-flash", "on"],
       "ep": TINY_MOE + ["--mesh", "dp=1,ep=2", "--moe-aux-weight", "0.05"]}
LIB = {"sp": ({"dp": 1, "sp": 2}, None), "ep": ({"dp": 1, "ep": 2}, None),
       "ep-drop": ({"dp": 1, "ep": 2}, 0.5)}  # mesh, capacity factor

# one process of the job: the train CLI runs of the spec, then the
# Trainer runs (each from the saved weights over the saved batches; the
# standard-layout params written by process 0), each a job of its own
ENTRY = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from mdi_llm_tpu_torch import training
from mdi_llm_tpu_torch.cli import train
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.ops import flash
from mdi_llm_tpu_torch.parallel.mesh import make_mesh

spec = json.loads(sys.argv[1])
me = spec["process_id"]
for argv, port in spec["cli"]:
    calls = [flash.flash_attention_plain.calls, flash.flash_dq_plain.calls,
             flash.flash_dkv_plain.calls]
    _, tr = train.main(argv + ["--coordinator", "127.0.0.1:%d" % port,
                               "--num-processes", "2", "--process-id", str(me)])
    now = [flash.flash_attention_plain.calls, flash.flash_dq_plain.calls,
           flash.flash_dkv_plain.calls]
    print("CLI " + json.dumps({"plain": [b - a for a, b in zip(calls, now)],
                               "layer_runs": tr.layer_runs}), flush=True)
for job, port in spec["lib"]:
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, rank=me,
                            world_size=2)
    tr = training.Trainer(Config(**job["cfg"]), training.TrainingConfig(**job["tc"]),
                          mesh=make_mesh(job["axes"], ["cpu"], me, 2),
                          params=torch.load(job["params"]), device="cpu")
    data = np.load(job["batches"])
    losses = [tr.train_step(x, y) for x, y in zip(data["x"], data["y"])]
    params = tr._standard_params()
    if me == 0:
        torch.save(params, job["out"])
    print("LIB " + json.dumps({"losses": losses, "layer_runs": tr.layer_runs}), flush=True)
    dist.destroy_process_group()
"""


def _pair(cli, lib):
    """The CLI runs and the Trainer jobs as processes 0 and 1 of one job
    each: per process ([each CLI run's record], [each Trainer job's])."""
    spec = {"cli": [(argv, _free_port()) for argv in cli],
            "lib": [(job, _free_port()) for job in lib]}
    procs = [subprocess.Popen(
        [sys.executable, "-c", ENTRY, json.dumps(dict(spec, process_id=i))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
        for i in range(2)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=PROC_TIMEOUT)
            assert p.returncode == 0, e[-3000:]
            recs = {k: [json.loads(ln[len(k) + 1:]) for ln in o.splitlines()
                        if ln.startswith(k + " ")] for k in ("CLI", "LIB")}
            assert len(recs["CLI"]) == len(cli) and len(recs["LIB"]) == len(lib), e[-3000:]
            out.append((o, recs))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a process of the job hung past {PROC_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _lib_case(name):
    """(JAX config, JAX params, the port's params, JAX and port
    TrainingConfigs, three steps' batches) of a Trainer job."""
    axes, cf = LIB[name]
    jc = moe_config(E=4, k=2, n_layer=2, block_size=16)
    jp = jtf.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jt = small_tc(batch_size=4, block_size=16, grad_acc_steps=1, moe_aux_weight=0.05,
                  moe_capacity_factor=cf, use_flash=False, remat=name == "sp", grad_clip=0.05)
    rng = np.random.default_rng(11)
    x, y = (rng.integers(0, jc.vocab_size, (3, 1, 4, 16)).astype(np.int32) for _ in range(2))
    return jc, jp, tp, jt, ttr.TrainingConfig(**asdict(jt)), x, y


@pytest.fixture(scope="module")
def pair(dataset, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("sp-ep-procs")
    cli = [RUN + CLI[k] + ["--dataset", str(dataset), "--ckpt", str(tmp / f"two-{k}")]
           for k in CLI]
    lib = []
    for k in LIB:
        jc, _, tp, _, tc, x, y = _lib_case(k)
        torch.save(tp, tmp / f"{k}-params.pt")
        np.savez(tmp / f"{k}-batches.npz", x=x, y=y)
        lib.append({"cfg": jc.asdict(), "tc": asdict(tc), "axes": LIB[k][0],
                    "params": str(tmp / f"{k}-params.pt"),
                    "batches": str(tmp / f"{k}-batches.npz"), "out": str(tmp / f"{k}-out.pt")})
    (out0, recs0), (out1, recs1) = _pair(cli, lib)
    return tmp, cli, (out0, out1), (recs0, recs1)


def _one_process(pair, k, capsys):
    """The one-process run of CLI run `k` on its mesh: (loss lines, ckpt)."""
    tmp, cli = pair[0], pair[1]
    argv = cli[list(CLI).index(k)]
    one = tmp / f"one-{k}"
    train_cli.main(argv[:-1] + [str(one)])
    return _lines(capsys.readouterr().out, "loss"), one


@pytest.mark.parametrize("k", list(CLI))
def test_train_cli_over_two_processes_equals_one_process(pair, k, capsys):
    want, one = _one_process(pair, k, capsys)
    i = list(CLI).index(k)
    out0, out1 = pair[2]
    got = [ln for ln in _lines(out0, "loss")][i * 3:(i + 1) * 3]
    assert len(want) == 3 and len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert _lines(out1, "loss") == []  # process 1 prints none
    two = pair[0] / f"two-{k}"
    for f in ("params.pt", "opt_state.pt"):
        a, b = torch.load(one / f), torch.load(two / f)
        la = tree_leaves(a) if f == "params.pt" else a["mu"] + a["nu"]
        lb = tree_leaves(b) if f == "params.pt" else b["mu"] + b["nu"]
        assert len(la) == len(lb) and [x.shape for x in la] == [x.shape for x in lb]
        for x, y in zip(la, lb):
            np.testing.assert_allclose(y.numpy(), x.numpy(), **TOL)


def test_sp_flash_calls_per_process_follow_the_plan(pair):
    """Each process's rank runs P = 2 of the ring's P^2 blocks per layer and
    micro-batch: K2's plain version twice (remat), K3's and K4's once."""
    n_layer = TConfig.from_name("pythia-14m").n_layer
    i = list(CLI).index("sp-flash")
    for recs in pair[3]:
        rec = recs["CLI"][i]
        runs = 3 * n_layer * 2  # steps x layers x the rank's blocks
        assert rec["layer_runs"] == runs
        assert rec["plain"] == [2 * runs, runs, runs]
        assert recs["CLI"][list(CLI).index("sp")]["plain"] == [0, 0, 0]


@pytest.mark.parametrize("k", list(LIB))
def test_trainer_over_two_processes_matches_jax_and_one_process(pair, devices, k):
    jc, jp, tp, jt, tc, x, y = _lib_case(k)
    axes = LIB[k][0]
    jtrainer = jtr.Trainer(jc, jt, mesh=jmesh.make_mesh(axes, devices[:2]), params=jp)
    want_losses = [jtrainer.train_step(a, b) for a, b in zip(x, y)]
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtrainer.params)]
    one = ttr.Trainer(TConfig(**jc.asdict()), tc, mesh=make_mesh(axes, ["cpu"]), params=tp,
                      device="cpu")
    one_losses = [one.train_step(a, b) for a, b in zip(x, y)]
    single = [t.detach().numpy() for t in tree_leaves(one._standard_params())]
    j = list(LIB).index(k)
    recs = [r["LIB"][j] for r in pair[3]]
    assert recs[0]["losses"] == recs[1]["losses"]  # every process holds the global loss
    got = [t.detach().numpy() for t in tree_leaves(torch.load(pair[0] / f"{k}-out.pt"))]
    for ref_losses, ref in ((want_losses, want), (one_losses, single)):
        np.testing.assert_allclose(recs[0]["losses"], ref_losses, rtol=2e-4)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("axes,spans,groups", [
    ({"dp": 2, "ep": 2}, [((p // 2,), 0, 0, p % 2) for p in range(4)],
     [[0, 2], [1, 3], [0, 1], [2, 3]]),
    ({"dp": 1, "sp": 2, "tp": 2}, [((0,), p % 2, p // 2, 0) for p in range(4)],
     [[0, 1], [2, 3], [0, 2], [1, 3], [0, 2], [1, 3]]),
], ids=["ep-beside-dp", "sp-with-part-of-tp"])
def test_layouts_that_do_not_split_are_refused(axes, spans, groups):
    """These layouts split over four processes now, one position each (the
    runs are tests/test_torch_mesh_quad_procs.py's): ep beside dp (each
    process one dp row and one ep rank: the dp and ep groups) and sp beside
    a split tp group (each process one (sp, tp) position: the tp groups,
    the dp groups of the other sp chunks, the sp groups of the ring).
    Every process builds every group, in one order."""
    for p in range(4):
        with mock.patch("mdi_llm_tpu_torch.training.CommGroup") as group:
            lay = ttr.MeshLayout(make_mesh(axes, ["cpu"], process_id=p, num_processes=4))
        assert [c.args[0] for c in group.call_args_list] == groups
        assert (lay.dp_coords, lay.tp_start, lay.sp_start, lay.ep_start) == spans[p]
