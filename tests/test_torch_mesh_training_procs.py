"""The train CLI over two processes (`--coordinator`), on the CPU.

- `cli.train --device cpu --coordinator 127.0.0.1:<free port>` as two gloo
  processes, each under its own subprocess time limit, for `--mesh dp=2`
  (each process one replica: the gradient all-reduce) and `--mesh tp=2`
  (each process one rank: the Megatron collectives under autograd), with
  clipping engaged (`--grad-clip 0.05`: the tp run's norm must count each
  replicated leaf once): the loss lines equal the single-process run's
  on the same mesh within 1e-5 (relative), and its best val loss, process
  1 prints none, and the checkpoint process 0 writes holds the
  single-process run's parameters in the standard layout; the two
  processes resume it with the single-process resume's next loss.
- The same for `--mesh pp=2` and `--mesh pp=2,tp=2` (each process one
  stage, with its whole tp group: the stage hop a point-to-point send and
  receive, the gradients of the received activations sent back), and for
  pp=2 with tied embeddings (the two stages' gradients of the shared
  leaf summed).
- A process whose peer never joins fails within the join's timeout
  (`parallel.nodes.init_distributed(timeout_s=)`, as the CLI calls it).
- `--coordinator` without `--num-processes`, or without `--mesh`, is
  refused.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mdi_llm_tpu.utils import data_loader as jdl
from mdi_llm_tpu_torch.cli import train as train_cli
from mdi_llm_tpu_torch.models.transformer import tree_leaves
from tests.test_training import toy_data

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
PROC_TIMEOUT = 180
LOSS_RTOL = 1e-5
RUN = ["--model", "pythia-14m", "--dtype", "float32", "--batch-size", "4",
       "--block-size", "32", "--warmup-iters", "0", "--learning-rate", "1e-3",
       "--log-interval", "1", "--eval-iters", "1", "--ckpt-interval", "2",
       "--grad-clip", "0.05", "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ds = tmp_path_factory.mktemp("data")
    train, val = jdl.split_dataset(toy_data(4096))
    train.tofile(ds / "train.bin")
    val.tofile(ds / "val.bin")
    return ds


def _job(argv, n=2, timeout=PROC_TIMEOUT, cmd=("-m", "mdi_llm_tpu_torch.cli.train")):
    """`cli.train argv` (or `python *cmd argv`) as processes 0..n-1 of one
    job on a free port, each under its own time limit (a hang fails the
    test): [(returncode, stdout, stderr)] in process order."""
    return _collect(_spawn(argv, n, cmd), timeout)


def _spawn(argv, n=2, cmd=("-m", "mdi_llm_tpu_torch.cli.train")):
    """`_job`'s processes, started: the caller goes on (a single-process
    reference run in this process) while they import and join."""
    coord = ["--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", str(n)]
    return [subprocess.Popen(
        [sys.executable, *cmd, *argv, *coord, "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
        for i in range(n)]


def _collect(procs, timeout=PROC_TIMEOUT):
    """The [(returncode, stdout, stderr)] of `_spawn`'s processes."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a process of the job hung past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _lines(stdout, key):
    return [json.loads(ln)[key] for ln in stdout.splitlines()
            if ln.startswith("{") and key in json.loads(ln)]


@pytest.mark.parametrize("mesh", ["dp=2", "tp=2", "pp=2", "pp=2,tp=2"])
def test_two_processes_match_one(tmp_path, dataset, mesh, capsys):
    argv = [*RUN, "--dataset", str(dataset), "--mesh", mesh]
    one, two = tmp_path / "one", tmp_path / "two"
    procs = _spawn([*argv, "--ckpt", str(two), "--max-iters", "3"])
    _, single = train_cli.main([*argv, "--ckpt", str(one), "--max-iters", "3"])
    printed = capsys.readouterr().out
    jobs = _collect(procs)
    for rc, _, err in jobs:
        assert rc == 0, err[-3000:]
    (_, out0, _), (_, out1, _) = jobs
    assert _lines(out1, "loss") == [] and "finished" not in out1
    want, got = _lines(printed, "loss"), _lines(out0, "loss")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the eval at iter 2 (ckpt_interval 2), printed to 4 places
    finished = [ln for ln in printed.splitlines() if ln.startswith("finished")]
    assert [ln.split("→")[0] for ln in out0.splitlines() if ln.startswith("finished")] == [
        finished[0].split("→")[0]]
    for x, y in zip(single.optimizer.mu, torch.load(two / "opt_state.pt")["mu"]):
        assert x.shape == y.shape  # the standard layout on disk
    for x, y in zip(tree_leaves(torch.load(one / "params.pt")),
                    tree_leaves(torch.load(two / "params.pt"))):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-4, atol=2e-5)

    # both resume: the two processes from their checkpoint, one from its own
    more = ["--init", "resume", "--max-iters", "4"]
    procs = _spawn([*argv, "--ckpt", str(two), *more])
    _ = train_cli.main([*argv, "--ckpt", str(one), *more])
    want = _lines(capsys.readouterr().out, "loss")
    jobs = _collect(procs)
    assert all(rc == 0 for rc, _, _ in jobs), jobs[0][2][-3000:]
    got = _lines(jobs[0][1], "loss")
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_two_process_stages_sum_the_tied_embedding(tmp_path, dataset, capsys):
    """pp=2 over two processes with tied embeddings (stage 0 embeds, the
    last stage's head reads the same leaf): the two stages' gradients of
    it are summed before the clip and the update, so the loss lines and
    the checkpoint are one process's."""
    argv = [*RUN, "--dataset", str(dataset), "--mesh", "pp=2", "--max-iters", "3",
            "--override", "tie_embeddings=true"]
    one, two = tmp_path / "one", tmp_path / "two"
    procs = _spawn([*argv, "--ckpt", str(two)])
    train_cli.main([*argv, "--ckpt", str(one)])
    want = _lines(capsys.readouterr().out, "loss")
    jobs = _collect(procs)
    for rc, _, err in jobs:
        assert rc == 0, err[-3000:]
    got = _lines(jobs[0][1], "loss")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    a, b = torch.load(one / "params.pt"), torch.load(two / "params.pt")
    assert "weight" not in a.get("lm_head", {}) and sorted(a) == sorted(b)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-4, atol=2e-5)


# the train CLI's join, with the wait cut from `nodes.TIMEOUT_S` to 3 s
JOIN_ALONE = (
    "import sys\n"
    "from mdi_llm_tpu_torch.parallel import nodes\n"
    "nodes.init_distributed(nodes.coordinator_config(sys.argv[1], 2), 0, device='cpu',\n"
    "                       timeout_s=3)\n"
)


def test_a_peer_that_never_joins_fails_the_job():
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", JOIN_ALONE, f"127.0.0.1:{_free_port()}"],
                          capture_output=True, text=True, cwd=ROOT, env=ENV,
                          timeout=PROC_TIMEOUT)
    assert proc.returncode != 0
    assert time.perf_counter() - t0 < 60  # start-up and the 3 s wait, not a hang
    assert "timeout" in proc.stderr.lower() or "timed out" in proc.stderr.lower(), \
        proc.stderr[-2000:]


@pytest.mark.parametrize("flags,match", [
    (["--coordinator", "127.0.0.1:1234", "--mesh", "dp=2"], "go together"),
    (["--coordinator", "127.0.0.1:1234", "--process-id", "0", "--num-processes", "2"],
     "give --mesh"),
], ids=["no-num-processes", "no-mesh"])
def test_coordinator_flags_are_checked(tmp_path, flags, match):
    argv = [*RUN, "--dataset", str(tmp_path), "--ckpt", str(tmp_path / "c"), *flags]
    with pytest.raises(SystemExit, match=match):
        train_cli.main(argv)
