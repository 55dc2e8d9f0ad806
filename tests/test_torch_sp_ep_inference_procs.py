"""Sequence- and expert-parallel inference over two processes (gloo on the
CPU), every job of the module in one pair of processes (`ENTRY`: each job
a `cli.sample` run of its own on its own port, then the collectives'
unit cases), each process under its own subprocess time limit:

- `cli.sample --coordinator ... --sp-devices 2` (pythia-14m, float32,
  random weights from `--seed`, one sp rank per process): greedy, both
  processes print the JAX `SPGenerator`'s streams on 2 virtual devices
  with the same weights and the port's one-process `--sp-devices 2`
  run's; at temperature 0.8 both processes draw the same tokens;
  `--sp-flash` with the prefill gate lowered to the local chunk's length,
  so each process calls K2's plain version (P^2 / 2 blocks per layer
  each) and still prints the greedy streams.
- `cli.sample --coordinator ... --ep-devices 2` on the converted tiny
  Mixtral of `tests/test_torch_expert.py` (one ep rank, 2 of its 4
  experts, per process), at exact capacity and at a capacity factor
  that drops assignments: the JAX CLI's `--ep-devices 2` streams (its
  `Generator` on an ep mesh) and the port's one-process run's.
- one MoE layer of `tests/test_expert.py`'s config through
  `ep_moe_forward(group=...)`, each process holding its rank's experts,
  at a capacity factor that drops assignments: the one-process ep
  layer's output and aux, not the exact ones.
- `collectives.gather_summed`: its backward is the sum of the
  processes' cotangent slices; `collectives.all_to_all(group=...)` over
  2 x 2 ranks equals the one-process exchange of the four parts, and
  its backward is the reverse exchange (the one-process gradients).
"""

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
from mdi_llm_tpu.parallel.sp_inference import SPGenerator as JSPGenerator
from mdi_llm_tpu_torch.cli import sample as sample_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.parallel.collectives import all_to_all
from mdi_llm_tpu_torch.parallel.expert import ep_moe_forward
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config
from tests.test_torch_expert import mixtral_ckpt  # noqa: F401  (a fixture)
from tests.test_torch_mesh_training_procs import _free_port

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
PROC_TIMEOUT = 300
SP = ["--model", "pythia-14m", "--device", "cpu", "--dtype", "float32", "--seed", "10137",
      "--n-tokens", "8", "--n-samples", "2", "--sp-devices", "2"]
SAMPLED = ["--temperature", "0.8", "--top-k", "20"]
EP = ["--device", "cpu", "--dtype", "float32", "--sequence-length", "64", "--greedy",
      "--n-tokens", "8", "--prompt", "w5 w17 w33 w2 w9 w40 w3 w11 w7", "--ep-devices", "2"]
DROP = ["--moe-capacity-factor", "0.25"]  # one slot per expert and source rank
LAYER_CF = 0.5  # the layer case's capacity factor: it drops assignments
FLASH_MIN_LEN = 4  # the 8-token prompts' local chunk at sp 2
A2A_SHAPE = (4, 3, 2)  # each rank's part: 4 chunks of (1, 3, 2)

# one process of the job: the sample CLI runs of the spec, each a job of
# its own on its own port (the sp prefill's K2 gate lowered to the local
# chunk), then the collectives' unit cases on one more port
ENTRY = """
import json, sys
import torch
import torch.distributed as dist
from mdi_llm_tpu_torch.cli import sample
from mdi_llm_tpu_torch.ops import flash
from mdi_llm_tpu_torch.parallel import sp_inference
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.parallel.collectives import CommGroup, all_to_all, gather_summed
from mdi_llm_tpu_torch.parallel.expert import ep_moe_forward
from mdi_llm_tpu_torch.parallel.mesh import make_mesh

spec = json.loads(sys.argv[1])
me = spec["process_id"]
init = sp_inference.SPGenerator.__init__
sp_inference.SPGenerator.__init__ = lambda self, *a, **k: init(
    self, *a, **dict(k, flash_min_len=spec["flash_min_len"]))
for argv, port in zip(spec["runs"], spec["ports"]):
    calls = flash.flash_attention_plain.calls
    outs = sample.main(argv + ["--coordinator", "127.0.0.1:%d" % port,
                               "--num-processes", "2", "--process-id", str(me)])
    print("JOB " + json.dumps({"outs": outs, "k2_plain": flash.flash_attention_plain.calls
                                                         - calls}), flush=True)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % spec["unit_port"],
                        rank=me, world_size=2)
group = CommGroup([0, 1])
# gather_summed: each process's cotangent differs; x's gradient is the sum
# of both processes' slices at its rows
x = (torch.arange(6.0).reshape(2, 3) + 10 * me).requires_grad_(True)
w = torch.arange(12.0).reshape(4, 3) * (me + 1)
y = gather_summed(x, 0, group)
(y * w).sum().backward()
# all_to_all over 2 processes x 2 ranks: parts drawn from the global rank
parts = [torch.randn(*spec["a2a_shape"], generator=torch.Generator().manual_seed(2 * me + i))
         .requires_grad_(True) for i in range(2)]
out = all_to_all(parts, 0, 1, group)
sum(((o * (j + 1 + 2 * me)).sum() for j, o in enumerate(out))).backward()
calls = group.calls
# one MoE layer, this process's rank's experts only
cfg = Config(**spec["moe_cfg"])
p = transformer.tree_map(lambda a: a[0], transformer.init_params(cfg, 0)["blocks"]["mlp"])
n = cfg.n_expert // 2
p["experts"] = transformer.tree_map(lambda a: a.narrow(0, me * n, n).clone(), p["experts"])
h = torch.randn(2, 8, cfg.n_embd, generator=torch.Generator().manual_seed(7))
with torch.no_grad():
    moe, aux = ep_moe_forward(cfg, p, h, make_mesh({"ep": 2}, ["cpu"], me, 2),
                              capacity_factor=spec["layer_cf"], with_aux=True, group=group)
print("UNIT " + json.dumps({"gathered": y.tolist(), "x_grad": x.grad.tolist(),
                            "w": w.tolist(), "a2a": [o.tolist() for o in out],
                            "a2a_grads": [p.grad.tolist() for p in parts],
                            "calls": calls, "moe": moe.tolist(), "aux": float(aux)}),
      flush=True)
dist.destroy_process_group()
"""


def _pair(runs):
    """The runs (sample argv lists) and the unit cases as processes 0 and 1
    of one job each: per process ([each run's {"outs", "k2_plain"}], the
    unit record)."""
    spec = {"runs": runs, "ports": [_free_port() for _ in runs], "unit_port": _free_port(),
            "flash_min_len": FLASH_MIN_LEN, "a2a_shape": list(A2A_SHAPE),
            "moe_cfg": moe_config(E=4, k=2).asdict(), "layer_cf": LAYER_CF}
    procs = [subprocess.Popen(
        [sys.executable, "-c", ENTRY, json.dumps(dict(spec, process_id=i))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
        for i in range(2)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=PROC_TIMEOUT)
            assert p.returncode == 0, e[-3000:]
            jobs = [json.loads(ln[4:]) for ln in o.splitlines() if ln.startswith("JOB ")]
            unit = [json.loads(ln[5:]) for ln in o.splitlines() if ln.startswith("UNIT ")]
            assert len(jobs) == len(runs) and len(unit) == 1, e[-3000:]
            out.append((jobs, unit[0]))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a process of the job hung past {PROC_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


RUNS = {"sp-greedy": SP + ["--greedy"], "sp-sampled": SP + SAMPLED,
        "sp-flash": SP + ["--greedy", "--sp-flash"], "ep-exact": EP, "ep-drop": EP + DROP}


@pytest.fixture(scope="module")
def pair(mixtral_ckpt):  # noqa: F811
    port_dir, _ = mixtral_ckpt
    runs = {k: v + (["--ckpt", str(port_dir)] if k.startswith("ep") else [])
            for k, v in RUNS.items()}
    (jobs0, unit0), (jobs1, unit1) = _pair(list(runs.values()))
    return {k: (a, b) for k, a, b in zip(runs, jobs0, jobs1)}, (unit0, unit1), runs


def test_sp_greedy_over_two_processes_equals_jax_and_one_process(pair, devices, capsys):
    p0, p1 = pair[0]["sp-greedy"]
    runs = pair[2]
    assert p0["outs"] == p1["outs"] and len(p0["outs"]) == 2
    assert all(len(s) == 16 for s in p0["outs"])
    assert p0["k2_plain"] == p1["k2_plain"] == 0
    assert sample_cli.main(runs["sp-greedy"]) == p0["outs"]
    capsys.readouterr()
    # the JAX SPGenerator on 2 virtual devices, on the CLI's --seed weights
    cfg = TConfig.from_name("pythia-14m")
    params = ttf.init_params(cfg, 10137, dtype=torch.float32)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jgen = JSPGenerator(JConfig.from_name("pythia-14m"), jparams, devices=devices[:2],
                        cache_dtype=jnp.float32)
    prompts = [s[:8] for s in p0["outs"]]
    rng = np.random.default_rng(10137)
    assert prompts == [rng.integers(1, cfg.vocab_size, 8).tolist() for _ in range(2)]
    want, _ = jgen.generate(prompts, 8, temperature=0.0)
    assert p0["outs"] == [list(map(int, w)) for w in want]


def test_sp_sampled_draws_alike_on_both_processes(pair):
    p0, p1 = pair[0]["sp-sampled"]
    assert p0["outs"] == p1["outs"]
    assert p0["outs"] != pair[0]["sp-greedy"][0]["outs"]


def test_sp_flash_calls_the_plain_k2_in_each_process(pair):
    """With the prefill gate at the local chunk, each process runs K2's
    plain version over its rank's blocks, the diagonal and one rotated
    chunk per layer (P^2 = 4 per layer over the pair); the streams stay
    greedy's."""
    p0, p1 = pair[0]["sp-flash"]
    n_layer = TConfig.from_name("pythia-14m").n_layer
    assert p0["k2_plain"] == p1["k2_plain"] == 2 * n_layer
    assert p0["outs"] == p1["outs"] == pair[0]["sp-greedy"][0]["outs"]


@pytest.mark.parametrize("run", ["ep-exact", "ep-drop"])
def test_ep_over_two_processes_equals_jax_and_one_process(pair, mixtral_ckpt,  # noqa: F811
                                                          devices, run, capsys):
    from mdi_llm_tpu.cli import sample as jsample

    p0, p1 = pair[0][run]
    assert p0["outs"] == p1["outs"] and len(p0["outs"]) == 1
    _, jax_dir = mixtral_ckpt
    argv = pair[2][run]
    assert sample_cli.main(argv) == p0["outs"]
    jargv = [a if a != argv[argv.index("--ckpt") + 1] else str(jax_dir) for a in argv]
    assert jsample.main(jargv) == p0["outs"]
    capsys.readouterr()


def test_gather_summed_backward_sums_the_processes_slices(pair):
    u0, u1 = pair[1]
    x = [np.arange(6.0).reshape(2, 3) + 10 * p for p in range(2)]
    np.testing.assert_array_equal(u0["gathered"], np.concatenate(x))
    np.testing.assert_array_equal(u1["gathered"], np.concatenate(x))
    w = [np.asarray(u["w"]) for u in (u0, u1)]
    for p, u in enumerate((u0, u1)):
        rows = slice(2 * p, 2 * p + 2)
        # not this process's cotangent alone: the sum of both processes'
        np.testing.assert_array_equal(u["x_grad"], w[0][rows] + w[1][rows])
    # the gather and its backward, the exchange and its backward
    assert u0["calls"] == u1["calls"] == 4


def test_all_to_all_over_processes_equals_one_process_and_reverses(pair):
    u0, u1 = pair[1]
    parts = [torch.randn(*A2A_SHAPE, generator=torch.Generator().manual_seed(r))
             .requires_grad_(True) for r in range(4)]
    want = all_to_all(parts, 0, 1)
    sum(((o * (j + 1)).sum() for j, o in enumerate(want))).backward()
    for p, u in enumerate((u0, u1)):
        for i in range(2):
            r = 2 * p + i
            np.testing.assert_array_equal(u["a2a"][i], want[r].detach().numpy())
            np.testing.assert_array_equal(u["a2a_grads"][i], parts[r].grad.numpy())


def test_ep_layer_over_processes_drops_as_one_process(pair):
    u0, u1 = pair[1]
    cfg = TConfig(**moe_config(E=4, k=2).asdict())
    p = ttf.tree_map(lambda a: a[0], ttf.init_params(cfg, 0)["blocks"]["mlp"])
    h = torch.randn(2, 8, cfg.n_embd, generator=torch.Generator().manual_seed(7))
    mesh = make_mesh({"ep": 2}, ["cpu"])
    with torch.no_grad():
        want, aux = ep_moe_forward(cfg, p, h, mesh, capacity_factor=LAYER_CF, with_aux=True)
        exact = ep_moe_forward(cfg, p, h, mesh)
    assert not torch.allclose(want, exact, rtol=1e-3, atol=1e-6)  # assignments were dropped
    for u in (u0, u1):
        np.testing.assert_allclose(u["moe"], want.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(u["aux"], float(aux), rtol=1e-6)
