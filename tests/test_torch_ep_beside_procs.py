"""Expert parallelism beside tp and dp over two processes (gloo on the
CPU), in float32, every job of the module in one pair of processes
(`ENTRY`: each job on its own port), each process under its own
subprocess time limit; the references are computed in this process while
the pair runs:

- the `Generator` through the API (the sample CLI's `--ep-devices` stands
  alone, as the JAX CLI's does) on {"ep": 2, "tp": 2} (one ep rank with
  its whole tp group per process), {"tp": 2, "ep": 2} (one tp rank with
  every expert), {"ep": 2, "dp": 2} and {"ep": 2, "dp": 2, "tp": 2} (one
  ep rank with every dp replica): greedy streams equal the JAX
  Generator's on the same mesh and the port's one-process run's, over the
  float tree, an int8 tree (experts split, every other leaf whole: the
  JAX `_place_ep_quantized`) and, on ep 2 x dp 2, at capacity factor 0.5
  (one dispatch over every replica's rows drops what the JAX one drops);
- the `Trainer` on {"ep": 2, "tp": 2}, {"tp": 2, "ep": 2}, {"ep": 2, "dp":
  2} (one ep rank with both dp rows per process) and {"dp": 2, "ep": 2}
  (one dp row with every ep rank), the aux weighted, clipping engaged, at
  exact capacity and at capacity factor 0.5: three steps give the JAX
  meshed Trainer's losses (rtol 1e-5) and parameters (rtol 2e-4, atol
  2e-5) and the one-process port's; every process holds the global loss;
  at exact capacity the first step's gradients (summed over the
  processes, before the clip) equal the dense (unmeshed) run's within
  `grad_limit`.
"""

import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config
from tests.test_torch_mesh_training_procs import _free_port
from tests.test_training import small_tc

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
PROC_TIMEOUT = 300
TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_training.py's mesh tolerance
PROMPTS = [[3, 7, 11, 2], [5, 1, 9, 13, 4]]
# four prompts on which capacity factor 0.5 drops assignments that move
# the greedy streams (tests/test_torch_ep_beside.py's)
CF_PROMPTS = (lambda rng: [[int(t) for t in rng.integers(0, 128, int(rng.integers(5, 14)))]
                           for _ in range(4)])(np.random.default_rng(1))
N_NEW = 10
GEN_MESHES = {"ep2-tp2": {"ep": 2, "tp": 2}, "tp2-ep2": {"tp": 2, "ep": 2},
              "ep2-dp2": {"ep": 2, "dp": 2}, "ep2-dp2-tp2": {"ep": 2, "dp": 2, "tp": 2}}
# (mesh id, quantize, capacity factor): every mesh on the float and int8
# trees, ep 2 x dp 2 at cf 0.5 on CF_PROMPTS
GEN_JOBS = ([(m, None, None) for m in GEN_MESHES] + [(m, "int8", None) for m in GEN_MESHES]
            + [("ep2-dp2", None, 0.5)])
TRAIN_MESHES = {"ep2-tp2": {"ep": 2, "tp": 2}, "tp2-ep2": {"tp": 2, "ep": 2},
                "ep2-dp2": {"ep": 2, "dp": 2}, "dp2-ep2": {"dp": 2, "ep": 2}}
TRAIN_JOBS = [(m, cf) for m in TRAIN_MESHES for cf in (None, 0.5)]
B, T = 4, 16  # the Trainer's batch


def grad_limit(n_terms: int) -> float:
    """`chip_smoke.grad_limit`: two float32 gradients of one loss summed
    in other orders differ by at most n_terms * 2^-24 of a leaf's
    largest entry."""
    return n_terms * 2.0 ** -24


# one process of a job of `n` processes: the Generator jobs, then the
# Trainer jobs, each its own process group on its own port.  A Trainer
# job's process 0 writes the standard-layout params after three steps
# and, where asked, the first step's gradients (gathered, before the clip)
ENTRY = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from mdi_llm_tpu_torch import training
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.ops import flash
from mdi_llm_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
me, n = spec["process_id"], spec["n"]


def join(port):
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, rank=me,
                            world_size=n)


for job in spec["gen"]:
    join(job["port"])
    gen = Generator(Config(**job["cfg"]), torch.load(job["params"]), max_seq_length=64,
                    device="cpu", quantize=job["q"], moe_capacity_factor=job["cf"],
                    mesh=make_mesh(job["axes"], ["cpu"], me, n))
    streams = gen.generate(job["prompts"], job["n_new"], temperature=0.0)[0]
    print("GEN " + json.dumps({"streams": streams, "tp_group": gen._group is not None,
                               "ep_group": gen._ep_group is not None,
                               "graphs": gen._graphs}), flush=True)
    dist.destroy_process_group()
for job in spec["train"]:
    join(job["port"])
    tr = training.Trainer(Config(**job["cfg"]), training.TrainingConfig(**job["tc"]),
                          mesh=make_mesh(job["axes"], ["cpu"], me, n),
                          params=torch.load(job["params"]), device="cpu")
    kept, update = [], tr.optimizer.update

    def keeping(params, grads, norm=None):
        if not kept:
            kept.append([g.detach().clone() for g in grads])
        return update(params, grads, norm=norm)

    tr.optimizer.update = keeping
    data = np.load(job["batches"])
    calls = [flash.flash_attention_plain.calls, flash.flash_dq_plain.calls,
             flash.flash_dkv_plain.calls]
    losses = [tr.train_step(x, y) for x, y in zip(data["x"], data["y"])]
    plain = [flash.flash_attention_plain.calls, flash.flash_dq_plain.calls,
             flash.flash_dkv_plain.calls]
    params = tr._standard_params()
    grads = tr._whole(kept[0], torch.float32) if job["grads"] else None
    if me == 0:
        torch.save(params, job["out"])
        if grads is not None:
            torch.save(grads, job["grads"])
    groups = {k: getattr(tr.layout, k + "_group") for k in ("tp", "ep", "dp", "sp")}
    print("TRAIN " + json.dumps({
        "losses": losses, "layer_runs": tr.layer_runs,
        "plain": [b - a for a, b in zip(calls, plain)],
        "groups": {k: None if g is None else g.ranks for k, g in groups.items()}}), flush=True)
    dist.destroy_process_group()
"""


def spawn(spec, n):
    """`ENTRY` on `spec` as processes 0..n-1, started: the caller computes
    its references while they run (`collect`)."""
    return [subprocess.Popen(
        [sys.executable, "-c", ENTRY, json.dumps(dict(spec, process_id=i, n=n))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
        for i in range(n)]


def collect(procs, spec):
    """Per process {"GEN": [each Generator job's record], "TRAIN": [each
    Trainer job's]}, each process under its own time limit."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=PROC_TIMEOUT)
            assert p.returncode == 0, e[-3000:]
            recs = {k: [json.loads(ln[len(k) + 1:]) for ln in o.splitlines()
                        if ln.startswith(k + " ")] for k in ("GEN", "TRAIN")}
            assert [len(recs["GEN"]), len(recs["TRAIN"])] == [len(spec["gen"]),
                                                              len(spec["train"])], e[-3000:]
            out.append(recs)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a process of the job hung past {PROC_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def jax_mesh(axes):
    return jmesh.make_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])


def trainer_case(cfg, key, cf, seed=11, block=T, **kw):
    """(JAX params, the port's, JAX and port TrainingConfigs, three steps'
    batches (3, 1, B, block)) of a Trainer job: the aux weighted, clipping
    engaged; `kw` overrides the route (use_flash, remat)."""
    jp = jtf.init_params(cfg, jax.random.PRNGKey(key))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jt = small_tc(**{**dict(batch_size=B, block_size=block, grad_acc_steps=1,
                            moe_aux_weight=0.05, moe_capacity_factor=cf, use_flash=False,
                            remat=False, grad_clip=0.05), **kw})
    rng = np.random.default_rng(seed)
    x, y = (rng.integers(0, cfg.vocab_size, (3, 1, B, block)).astype(np.int32)
            for _ in range(2))
    return jp, tp, jt, ttr.TrainingConfig(**asdict(jt)), x, y


def jax_trainer_run(cfg, jp, jt, axes, x, y):
    """The JAX meshed Trainer's losses and parameters over the batches."""
    tr = jtr.Trainer(cfg, jt, mesh=jax_mesh(axes), params=jp)
    losses = [tr.train_step(a, b) for a, b in zip(x, y)]
    return losses, [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.params)]


def port_trainer_run(cfg, tp, tc, mesh, x, y):
    """(losses, standard-layout params, first-step gradients) of the port's
    Trainer in this process."""
    tr = ttr.Trainer(TConfig(**cfg.asdict()), tc, mesh=mesh, params=tp, device="cpu")
    kept, update = [], tr.optimizer.update

    def keeping(params, grads, norm=None):
        if not kept:
            kept.append([g.detach().clone() for g in grads])
        return update(params, grads, norm=norm)

    tr.optimizer.update = keeping
    losses = [tr.train_step(a, b) for a, b in zip(x, y)]
    params = [t.detach().numpy() for t in ttf.tree_leaves(tr._standard_params())]
    return losses, params, kept[0]


def grads_within_limit(got, want, n_terms) -> float:
    """The largest |got - want| over every leaf relative to the leaf's
    largest |want|, asserted within `grad_limit(n_terms)`."""
    rel = 0.0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(float(b.abs().max()), 1e-30)
        rel = max(rel, float((a - b).abs().max()) / scale)
    assert rel <= grad_limit(n_terms), rel
    return rel


@pytest.fixture(scope="module")
def pair(tmp_path_factory, devices):
    """The pair's records, the JAX references and the one-process port's,
    each computed once for the module (the references while the pair
    runs)."""
    tmp = tmp_path_factory.mktemp("ep-beside-procs")
    gcfg = moe_config()
    gjp = jtf.init_params(gcfg, jax.random.PRNGKey(1))
    gtp = params_from_numpy(jax.tree_util.tree_map(np.asarray, gjp))
    torch.save(gtp, tmp / "gen-params.pt")
    gen = [{"cfg": gcfg.asdict(), "params": str(tmp / "gen-params.pt"),
            "axes": GEN_MESHES[m], "q": q, "cf": cf,
            "prompts": CF_PROMPTS if cf else PROMPTS, "n_new": N_NEW, "port": _free_port()}
           for m, q, cf in GEN_JOBS]
    tcfg = moe_config(E=4, k=2, n_layer=2, block_size=T)
    train, cases = [], {}
    for i, (m, cf) in enumerate(TRAIN_JOBS):
        jp, tp, jt, tc, x, y = cases[(m, cf)] = trainer_case(tcfg, 3, cf)
        torch.save(tp, tmp / f"train-{i}-params.pt")
        np.savez(tmp / f"train-{i}-batches.npz", x=x, y=y)
        train.append({"cfg": tcfg.asdict(), "tc": asdict(tc), "axes": TRAIN_MESHES[m],
                      "params": str(tmp / f"train-{i}-params.pt"),
                      "batches": str(tmp / f"train-{i}-batches.npz"),
                      "out": str(tmp / f"train-{i}-out.pt"),
                      "grads": None if cf else str(tmp / f"train-{i}-grads.pt"),
                      "port": _free_port()})
    spec = {"gen": gen, "train": train}
    procs = spawn(spec, 2)
    try:
        refs = {"gen": {}, "train": {}}
        for m, q, cf in GEN_JOBS:
            prompts = CF_PROMPTS if cf else PROMPTS
            one = Generator(TConfig(**gcfg.asdict()), gtp, max_seq_length=64, device="cpu",
                            quantize=q, moe_capacity_factor=cf,
                            mesh=make_mesh(GEN_MESHES[m], ["cpu"]))
            want = None
            if q is None or m == "ep2-tp2":  # int8 on the other meshes: one process
                want = JGenerator(gcfg, gjp, max_seq_length=64, quantize=q,
                                  moe_capacity_factor=cf, mesh=jax_mesh(GEN_MESHES[m])
                                  ).generate(prompts, N_NEW, temperature=0.0)[0]
            refs["gen"][(m, q, cf)] = (want, one.generate(prompts, N_NEW, temperature=0.0)[0])
        for m, cf in TRAIN_JOBS:
            jp, tp, jt, tc, x, y = cases[(m, cf)]
            refs["train"][(m, cf)] = (
                jax_trainer_run(tcfg, jp, jt, TRAIN_MESHES[m], x, y),
                port_trainer_run(tcfg, tp, tc, make_mesh(TRAIN_MESHES[m], ["cpu"]), x, y))
        dense = port_trainer_run(tcfg, cases[TRAIN_JOBS[0]][1], cases[TRAIN_JOBS[0]][3], None,
                                 *cases[TRAIN_JOBS[0]][4:])
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return tmp, collect(procs, spec), refs, dense


@pytest.mark.parametrize("job", GEN_JOBS, ids=[f"{m}-{q or 'fp'}-cf{cf}" for m, q, cf in GEN_JOBS])
def test_generator_over_two_processes_equals_jax_and_one_process(pair, job):
    _tmp, recs, refs, _dense = pair
    m, q, cf = job
    i = GEN_JOBS.index(job)
    jax_want, one = refs["gen"][job]
    got = [r["GEN"][i] for r in recs]
    assert got[0]["streams"] == got[1]["streams"] == one
    if jax_want is not None:
        assert one == jax_want
    axes = GEN_MESHES[m]
    # the groups each layout splits: tp over the processes where each holds
    # one tp rank, ep where each holds one ep rank (an int8 tree keeps
    # every leaf but the experts whole: no tp group); eager decode
    tp_split = list(axes)[0] == "tp" and q is None
    assert [(g["tp_group"], g["ep_group"], g["graphs"]) for g in got] == [
        (tp_split, list(axes)[0] == "ep", False)] * 2


def test_capacity_drops_over_processes_move_the_streams(pair):
    """At capacity factor 0.5 the ep 2 x dp 2 streams over two processes
    (the JAX Generator's) differ from the exact ones on the same prompts:
    the drops act."""
    recs = pair[1]
    i = GEN_JOBS.index(("ep2-dp2", None, 0.5))
    exact = Generator(TConfig(**moe_config().asdict()), torch.load(pair[0] / "gen-params.pt"),
                      max_seq_length=64, device="cpu", mesh=make_mesh({"ep": 2}, ["cpu"]))
    assert recs[0]["GEN"][i]["streams"] != exact.generate(CF_PROMPTS, N_NEW,
                                                          temperature=0.0)[0]


@pytest.mark.parametrize("job", TRAIN_JOBS, ids=[f"{m}-cf{cf}" for m, cf in TRAIN_JOBS])
def test_trainer_over_two_processes_matches_jax_and_one_process(pair, job):
    tmp, recs, refs, dense = pair
    m, cf = job
    i = TRAIN_JOBS.index(job)
    (want_losses, want), (one_losses, one, one_grads) = refs["train"][job]
    got_recs = [r["TRAIN"][i] for r in recs]
    assert got_recs[0]["losses"] == got_recs[1]["losses"]  # every process: the global loss
    got = [t.detach().numpy() for t in ttf.tree_leaves(torch.load(tmp / f"train-{i}-out.pt"))]
    np.testing.assert_allclose(got_recs[0]["losses"], want_losses, rtol=1e-5)
    np.testing.assert_allclose(got_recs[0]["losses"], one_losses, rtol=1e-5)
    for ref in (want, one):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **TOL)
    axes = TRAIN_MESHES[m]
    # each process's layer runs: its dp rows' tp ranks, every layer, 3 steps
    rows = axes.get("dp", 1) if list(axes)[0] == "ep" else 1
    tp_local = axes.get("tp", 1) if list(axes)[0] == "ep" else 1
    assert [r["layer_runs"] for r in got_recs] == [3 * 2 * rows * tp_local] * 2
    split = {"ep2-tp2": "ep", "tp2-ep2": "tp", "ep2-dp2": "ep", "dp2-ep2": "dp"}[m]
    assert [r["groups"][split] for r in got_recs] == [[0, 1]] * 2
    assert all(g is None for r in got_recs for k, g in r["groups"].items() if k != split)
    if cf is None:  # the first step's gradients: the dense run's, summed once
        grads = torch.load(tmp / f"train-{i}-grads.pt")
        grads_within_limit(grads, dense[2], B * T)
        grads_within_limit(grads, one_grads, B * T)
