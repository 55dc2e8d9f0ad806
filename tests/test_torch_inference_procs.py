"""Inference over two processes (gloo on the CPU), each under its own
subprocess time limit; one process pair per case, shared by every
assertion on it:

- `cli.sample --device cpu --coordinator ... --tp-devices 2` (pythia-14m,
  float32, random weights from `--seed`, one tp rank per process), run
  twice in the same two processes (`ENTRY`: a second job on a second
  port): greedy, its streams equal the JAX `Generator(mesh=make_mesh({"tp":
  2}))`'s on the same weights and the port's one-process `--tp-devices 2`
  run's, both processes printing them; at temperature 0.8 both processes
  print the same draws (each samples the gathered logits from its own
  generator, seeded alike).
- `cli.starter` / `cli.secondary` with a node config of `tp_devices: 2`
  (each process one stage of two tp ranks): the streams of the
  one-process pipe x tp ring (`cli.sample --pipeline-stages 2
  --tp-devices 2`), the ring lines saying tp 2.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.parallel.mesh import make_mesh as jmake_mesh
from mdi_llm_tpu_torch.cli import sample as sample_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.models import transformer as ttf
from tests.test_torch_mesh_training_procs import _free_port, _job
from tests.test_torch_nodes import _run_pair, _samples, _write

torch.set_num_threads(1)
RUN = ["--model", "pythia-14m", "--device", "cpu", "--dtype", "float32", "--seed", "10137",
       "--n-tokens", "8", "--n-samples", "2"]

# one process of the job: the sample CLI greedy on the job's port, then
# sampled on the port after --second-port (a second job of the same two
# processes); a "RUN" line heads each run's output
ENTRY = (
    "import sys\n"
    "from mdi_llm_tpu_torch.cli import sample\n"
    "argv = sys.argv[1:]\n"
    "i = argv.index('--second-port')\n"
    "port = argv[i + 1]\n"
    "del argv[i:i + 2]\n"
    "c = argv.index('--coordinator') + 1\n"
    "for extra in (['--greedy'], ['--temperature', '0.8', '--top-k', '20']):\n"
    "    print('RUN', flush=True)\n"
    "    sample.main(argv + extra)\n"
    "    argv[c] = '127.0.0.1:' + port\n"
)


def _runs(stdout):
    return [_samples(part) for part in stdout.split("RUN\n")[1:]]


def test_sample_tp_over_two_processes(capsys):
    jobs = _job(RUN + ["--tp-devices", "2", "--second-port", str(_free_port())],
                cmd=("-c", ENTRY))
    for rc, _, err in jobs:
        assert rc == 0, err[-3000:]
    (_, out0, err0), (_, out1, _) = jobs
    assert "2 node(s)" in err0 and "gloo" in err0
    greedy0, sampled0 = _runs(out0)
    greedy1, sampled1 = _runs(out1)
    assert len(greedy0) == 2 and all(len(s) == 16 for s in greedy0)
    # every process prints the streams, and draws the same tokens
    assert greedy1 == greedy0
    assert sampled1 == sampled0 and sampled0 != greedy0
    # the port in one process, tp 2 on the CPU
    one = sample_cli.main(RUN + ["--tp-devices", "2", "--greedy"])
    capsys.readouterr()
    assert one == greedy0
    # the JAX tp Generator on the same weights (the CLI's --seed draw)
    cfg = TConfig.from_name("pythia-14m")
    params = ttf.init_params(cfg, 10137, dtype=torch.float32)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jgen = JGenerator(JConfig.from_name("pythia-14m"), jparams, cache_dtype=jnp.float32,
                      mesh=jmake_mesh({"tp": 2}, jax.devices()[:2]))
    prompts = [s[:8] for s in greedy0]
    rng = np.random.default_rng(10137)
    assert prompts == [rng.integers(1, cfg.vocab_size, 8).tolist() for _ in range(2)]
    want, _ = jgen.generate(prompts, 8, temperature=0.0)
    assert greedy0 == [list(map(int, w)) for w in want]


def test_starter_secondary_with_tp_devices(tmp_path, capsys):
    cfg = _write(tmp_path, {"nodes": {
        "starter": {"addr": "127.0.0.1", "communication": {"port": _free_port()}},
        "secondary": [{"addr": "127.0.0.1", "communication": {"port": _free_port()}}]},
        "tp_devices": 2})
    run = RUN[:-1] + ["4", "--greedy", "--samples-per-slot", "2"]
    (rc, out, err), (src, _, serr) = _run_pair(cfg, run, run)
    assert rc == 0, err[-3000:]
    assert src == 0, serr[-3000:]
    rings = [json.loads(next(ln for ln in e.splitlines() if ln.startswith("ring: "))[6:])
             for e in (err, serr)]
    assert [(r["stages"], r["tp"], r["backend"]) for r in rings] == [
        ([0], 2, "gloo"), ([1], 2, "gloo")]
    one = sample_cli.main(run + ["--pipeline-stages", "2", "--tp-devices", "2"])
    capsys.readouterr()
    assert _samples(out) == one and len(one) == 4
