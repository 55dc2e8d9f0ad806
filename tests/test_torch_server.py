"""The port's open-system server (`mdi_llm_tpu_torch/server/`,
`cli/server.py`) on the CPU, the patterns of tests/test_server.py and
tests/test_explorer.py.

- the acceptance contract: greedy streams through `ServingFrontend`, every
  request submitted before `start()`, equal the offline `engine.run()` and
  the JAX engine's on the same weights, with the same host_syncs, under
  every policy; with the engine's steps "captured" (a stand-in for the
  CUDA graph, as in tests/test_torch_graphs.py) the captures guard sees
  no capture after warm-up, the engine thread only replaying;
- open arrivals, 429 backpressure (`QueueFullError`, the rejected
  counter), 400 for infeasible requests, drain/stop/cancel;
- HTTP end to end on localhost: SSE and JSON completions equal the
  offline streams, `/healthz`, `/v1/stats`, `/metrics` (its
  `serving_tokens_generated_total` equals `/v1/stats`' tokens), 400, 429
  with Retry-After, text prompts through a tokenizer, graceful drain;
  and `python -m mdi_llm_tpu_torch.cli.server` as a subprocess, drained by
  SIGTERM;
- `loadgen`: Poisson and replayed arrivals equal the JAX package's for
  the same seed, `OpenLoopRunner` and `sweep_offered_load` on a fake
  clock report what the JAX package's report, and an open-loop run over a
  live frontend completes every request;
- the schedule explorer: determinism per seed, one installation at a
  time, 200 seeded pre-start interleavings with offline parity, live
  adversarial episodes with cancels and racing drains, the drain-window
  seeds, a planted lost update it must catch, and `doctor_burst`.
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.server import loadgen as jloadgen
from mdi_llm_tpu_torch.cli import server as server_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.config import ServingConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.obs import ServingObserver
from mdi_llm_tpu_torch.serving.engine import ServingEngine
from mdi_llm_tpu_torch.server import (
    FrontendClosedError,
    QueueFullError,
    ScheduleExplorer,
    ServingFrontend,
    doctor_burst,
    loadgen,
    run_episode,
)
from mdi_llm_tpu_torch.server import frontend as frontend_mod
from mdi_llm_tpu_torch.server.http import ServingHTTPServer
from mdi_llm_tpu_torch.serving.policy import make_policy
from mdi_llm_tpu_torch.utils import step_graph
from mdi_llm_tpu_torch.utils.profiling import CompileGuard

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)
KNOBS = dict(block_size=4, max_batch=3, prefill_chunk=8)

#: the explorer's acceptance criterion: >= 200 seeded interleavings
PARITY_SEEDS = range(200)
ADVERSARIAL_SEEDS = range(24)
DRAIN_REGRESSION_SEEDS = (20, 21, 24, 26, 31, 39, 44, 45, 56, 58)
DETECTOR_SEEDS = range(6)


@pytest.fixture(scope="module")
def served():
    """Both packages on the same float32 weights, and each package's
    offline streams of the trace."""
    jc, tc = JConfig(**TINY), TConfig(**TINY)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jgen = JGenerator(jc, jp, cache_dtype=jnp.float32)
    tgen = TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu")
    trace = _trace()
    offline = tgen.serve(**KNOBS)
    jengine = jgen.serve(**KNOBS)
    for rid, p, m in trace:
        offline.add_request(rid, p, m)
        jengine.add_request(rid, p, m)
    want, stats = offline.run()
    jwant, _ = jengine.run()
    return {"gen": tgen, "params": tp, "trace": trace, "want": want, "stats": stats,
            "jwant": jwant}


def _trace(lengths=(3, 9, 17, 5), news=(8, 12, 6, 10), seed=5):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, TINY["vocab_size"], int(n)).tolist() for n in lengths]
    return list(zip([f"r{i}" for i in range(len(prompts))], prompts, list(news)))


def _engine(served, obs=None, policy=None, **kw):
    return served["gen"].serve(serving=ServingConfig(**{**KNOBS, **kw}), obs=obs, policy=policy)


def _fake_graph_class():
    """A stand-in for `step_graph.CudaGraph`: a capture records the body,
    a replay runs it with the kernel counters held (a replay runs no
    Python on the card)."""

    class FakeGraph:
        def __init__(self, generators=()):
            self.generators = list(generators)

        def _held(self, fn):
            states = [g.get_state() for g in self.generators]
            out = fn()
            for g, s in zip(self.generators, states):
                g.set_state(s)
            return out

        def warm_up(self, fn):
            self._held(fn)

        def capture(self, fn):
            self.fn = fn
            self.outputs = self._held(fn)
            return self.outputs

        def replay(self):
            counters = step_graph.kernel_counters()
            counts = [getattr(o, a) for o, a in counters]
            new = self.fn()
            for (o, a), v in zip(counters, counts):
                setattr(o, a, v)
            outs = self.outputs if isinstance(self.outputs, tuple) else (self.outputs,)
            news = new if isinstance(new, tuple) else (new,)
            for o, n in zip(outs, news):
                o.copy_(n)

    return FakeGraph


# ---------------------------------------------------------------------------
# the acceptance contract: frontend == offline engine, zero interference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [None, "priority", "fair", "deadline"])
def test_frontend_streams_match_offline_engine(served, policy, monkeypatch):
    """All submitted before the engine thread starts: every stream, the
    host_syncs and the token count equal the offline run's (and the JAX
    engine's streams); the engine was captured when built and the engine
    thread captures nothing."""
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class())
    want, stats_off = served["want"], served["stats"]
    assert want == served["jwant"]
    guard = CompileGuard(label="server-overhead")
    with guard:
        obs = ServingObserver()
        engine = ServingEngine(served["gen"], ServingConfig(**KNOBS), obs=obs,
                               policy=make_policy(policy), _graphs=True)
        assert engine.graph_stats()["captures"] == 2
        guard.mark_warm()  # every step is built and captured before start()
        front = ServingFrontend(engine)
        handles = {rid: front.submit(p, m, rid=rid) for rid, p, m in served["trace"]}
        front.start()
        assert front.drain(timeout=300.0), "drain timed out"
        front.stop()
    guard.expect_clean()
    for rid, p, _m in served["trace"]:
        assert handles[rid].result == want[rid], f"{rid} diverged under policy={policy}"
        assert handles[rid].tokens == want[rid][len(p):], f"{rid} streamed tokens diverged"
    assert engine.stats.host_syncs == stats_off.host_syncs, "the front-end changed the syncs"
    assert engine.stats.tokens_generated == stats_off.tokens_generated
    assert engine.graph_stats()["replays"] > 0
    c = obs.metrics.to_dict()["counters"]
    assert c["serving_tokens_generated_total"] == stats_off.tokens_generated
    assert c["graph_captures_total"] == 0


def test_frontend_open_arrivals_complete(served):
    """Requests submitted WHILE the engine runs are admitted at the
    step_hook seam and complete with the offline streams."""
    engine = _engine(served)
    front = ServingFrontend(engine).start()
    handles = {}
    for rid, p, m in served["trace"]:
        handles[rid] = front.submit(p, m, rid=rid)
        handles[rid].done.wait(timeout=0.02)  # stagger arrivals
    assert front.drain(timeout=300.0)
    front.stop()
    for rid, _p, _m in served["trace"]:
        assert handles[rid].result == served["want"][rid], f"{rid} diverged (open)"
    assert front.idle


def test_frontend_backpressure_and_stats(served):
    """Arrivals past the admission bound raise QueueFullError; the
    rejection lands in the stats and the observer counter; an infeasible
    request is a ValueError (HTTP 400), not a 429."""
    obs = ServingObserver()
    engine = _engine(served, obs=obs)
    front = ServingFrontend(engine, max_queue=2)  # engine NOT started
    p = [1, 2, 3]
    front.submit(p, 4, rid="a")
    front.submit(p, 4, rid="b")
    with pytest.raises(QueueFullError):
        front.submit(p, 4, rid="c")
    assert engine.stats.requests_rejected == 1
    assert engine.stats.offered_qps > 0.0
    d = engine.stats.to_dict()
    assert d["requests_rejected"] == 1 and d["offered_qps"] > 0.0
    assert obs.metrics.to_dict()["counters"]["serving_requests_rejected_total"] == 1
    with pytest.raises(ValueError, match="exceeds max_seq_length"):
        front.submit([1] * 100, 100, rid="huge")
    with pytest.raises(ValueError, match="must be >= 1"):
        ServingFrontend(engine, max_queue=0)
    front.start()
    assert front.drain(timeout=300.0)
    front.stop()
    assert engine.stats.requests_finished == 2


def test_frontend_rejects_after_drain_and_cancel(served):
    engine = _engine(served)
    front = ServingFrontend(engine).start()
    h = front.submit([5, 6, 7], 12, rid="long")
    assert front.cancel("long") is True
    assert front.cancel("nope") is False
    assert h.done.wait(timeout=60.0)
    assert (h.cancelled and h.result is None) or h.result is not None
    front.drain(timeout=60.0)
    with pytest.raises(FrontendClosedError):
        front.submit([1, 2], 2, rid="late")
    front.stop()


def test_queue_depth_peak_rides_replay_stats(served):
    engine = _engine(served, max_batch=1)
    for rid, p, m in served["trace"]:
        engine.add_request(rid, p, m)
    _results, stats = engine.run()
    assert stats.queue_depth_peak >= 1
    assert stats.to_dict()["queue_depth_peak"] == stats.queue_depth_peak
    assert stats.to_dict()["offered_qps"] == 0.0


# ---------------------------------------------------------------------------
# HTTP end to end on localhost
# ---------------------------------------------------------------------------


def _http(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _sse_events(raw: bytes):
    events = []
    for block in raw.decode().split("\n\n"):
        if not block.strip():
            continue
        ev = {}
        for line in block.splitlines():
            k, _, v = line.partition(": ")
            ev[k] = v
        if "data" in ev:
            ev["data"] = json.loads(ev["data"])
        events.append(ev)
    return events


def _prometheus(text: str) -> dict:
    """Sample lines of a Prometheus text exposition as {name: value}."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            out[name] = float(value)
    return out


class WordTokenizer:
    """Token i <-> the word "w{i}"."""

    def encode(self, text):
        return np.asarray([int(w[1:]) for w in text.split()], np.int64)

    def decode(self, ids):
        return " ".join(f"w{int(i)}" for i in np.asarray(ids).reshape(-1))


def test_http_server_e2e(served):
    """SSE and JSON completions equal the offline streams; health, stats,
    metrics, 400s; a text prompt through the tokenizer; graceful drain."""
    trace, want = served["trace"], served["want"]
    obs = ServingObserver()
    front = ServingFrontend(_engine(served, obs=obs), max_queue=16)
    srv = ServingHTTPServer(front, port=0, tokenizer=WordTokenizer(), drain_timeout_s=120.0)
    results = {}

    async def drive():
        await srv.start()
        loop = asyncio.get_running_loop()

        def call(*a, **kw):
            return loop.run_in_executor(None, lambda: _http(*a, **kw))

        st, _h, body = await call(srv.port, "GET", "/healthz")
        results["health"] = (st, json.loads(body))
        rid, prompt, new = trace[0]
        st, hdrs, raw = await call(srv.port, "POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": new, "stream": True}))
        results["sse"] = (st, hdrs, _sse_events(raw))
        rid2, prompt2, new2 = trace[1]
        st, _h, body = await call(srv.port, "POST", "/v1/completions", json.dumps(
            {"prompt": prompt2, "max_tokens": new2}))
        results["json"] = (st, json.loads(body))
        rid3, prompt3, new3 = trace[2]
        st, _h, body = await call(srv.port, "POST", "/v1/completions", json.dumps(
            {"prompt": " ".join(f"w{t}" for t in prompt3), "max_tokens": new3}))
        results["text"] = (st, json.loads(body))
        results["bad"] = [
            (await call(srv.port, "POST", "/v1/completions", body))[0]
            for body in ("{not json", json.dumps({"prompt": 5}),
                         json.dumps({"prompt": [1] * 200, "max_tokens": 8}))]
        results["404"] = (await call(srv.port, "GET", "/nope"))[0]
        st, _h, body = await call(srv.port, "GET", "/v1/stats")
        results["stats"] = (st, json.loads(body))
        st, hdrs, body = await call(srv.port, "GET", "/metrics")
        results["metrics"] = (st, hdrs, body.decode())
        await srv.shutdown()

    asyncio.run(drive())

    st, health = results["health"]
    assert st == 200 and health["status"] == "ok" and health["queue_bound"] == 16
    st, hdrs, events = results["sse"]
    rid, prompt, _new = trace[0]
    assert st == 200 and hdrs.get("Content-Type") == "text/event-stream"
    tokens = [e["data"]["token"] for e in events if e.get("event") == "token"]
    assert tokens == want[rid][len(prompt):]
    assert all(e["data"]["text"] == f"w{e['data']['token']}"
               for e in events if e.get("event") == "token")
    (done,) = [e for e in events if e.get("event") == "done"]
    assert done["data"]["tokens"] == tokens and done["data"]["n_generated"] == len(tokens)
    st, body = results["json"]
    rid2, prompt2, _ = trace[1]
    assert st == 200 and body["tokens"] == want[rid2][len(prompt2):]
    st, body = results["text"]
    rid3, prompt3, _ = trace[2]
    assert st == 200 and body["tokens"] == want[rid3][len(prompt3):]
    assert body["text"] == " ".join(f"w{t}" for t in body["tokens"])
    assert results["bad"] == [400, 400, 400] and results["404"] == 404
    st, stats = results["stats"]
    assert st == 200 and stats["requests"] == 3 and stats["latency"]["ttft_s"]["count"] == 3
    st, hdrs, text = results["metrics"]
    assert st == 200 and hdrs["Content-Type"].startswith("text/plain")
    samples = _prometheus(text)
    assert samples["serving_tokens_generated_total"] == stats["tokens_generated"]
    assert samples['serving_request_ttft_seconds_bucket{le="+Inf"}'] == 3
    assert front.idle


def test_http_backpressure_429(served):
    """With the engine thread NOT consuming, an arrival past the bound gets
    429 + Retry-After while the earlier one is still queued."""
    engine = _engine(served)
    front = ServingFrontend(engine, max_queue=1)
    srv = ServingHTTPServer(front, port=0)
    results = {}

    async def drive():
        srv._loop = asyncio.get_running_loop()
        srv._server = await asyncio.start_server(srv._handle_conn, srv.host, srv.port)
        srv.port = srv._server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()
        front.submit([1, 2, 3], 4, rid="parked")
        results["second"] = await loop.run_in_executor(None, lambda: _http(
            srv.port, "POST", "/v1/completions",
            json.dumps({"prompt": [4, 5, 6], "max_tokens": 4})))
        results["text"] = await loop.run_in_executor(None, lambda: _http(
            srv.port, "POST", "/v1/completions", json.dumps({"prompt": "w1 w2"})))
        srv._server.close()
        await srv._server.wait_closed()

    asyncio.run(drive())
    st, hdrs, body = results["second"]
    assert st == 429 and hdrs.get("Retry-After") == "1"
    assert "admission queue full" in json.loads(body)["error"]
    assert engine.stats.requests_rejected == 1
    st, _h, body = results["text"]  # no tokenizer: text prompts are a 400
    assert st == 400 and "tokenizer" in json.loads(body)["error"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_cli_subprocess_serves_and_drains_on_sigterm(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mdi_llm_tpu_torch.cli.server", "--device", "cpu",
         "--model", "pythia-14m", "--max-batch", "2", "--sequence-length", "128",
         "--block-size", "8", "--port", str(port), "--metrics-out", str(tmp_path / "m.json")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)),
    )
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                st, _h, body = _http(port, "GET", "/healthz", timeout=5)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, "server never came up"
                time.sleep(0.25)
        assert st == 200 and json.loads(body)["status"] == "ok"
        st, _h, body = _http(port, "POST", "/v1/completions",
                             json.dumps({"prompt": [3, 14, 159], "max_tokens": 6}))
        assert st == 200 and len(json.loads(body)["tokens"]) == 6
        st, _h, raw = _http(port, "POST", "/v1/completions",
                            json.dumps({"prompt": [3, 14, 159], "max_tokens": 6, "stream": True}))
        sse = [e["data"]["token"] for e in _sse_events(raw) if e.get("event") == "token"]
        assert sse == json.loads(body)["tokens"]  # greedy: the same stream
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "draining" in err
    line = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    assert line["requests"] == 2 and line["tokens_generated"] == 12
    assert line["latency"]["tpot_s"]["count"] == 2 and line["device"]["type"] == "cpu"
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert metrics["metrics"]["counters"]["serving_tokens_generated_total"] == 12


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--pp", "2"], ["--host-pool-mib", "64"]],
                         ids=["--tp", "--pp", "--host-pool-mib"])
def test_server_cli_refuses_unported_flags(flags):
    """`--host-pool-mib` and `--tp` are ported: the server's flags build an
    engine with the host tier, or over two tensor-parallel ranks (the
    listener is not started here); `--pp` is still refused."""
    argv = ["--device", "cpu", "--model", "pythia-14m", *flags]
    if "--pp" not in flags:
        args = server_cli.build_parser().parse_args(argv + ["--no-device-obs"])
        engine, _tok = server_cli.serve_cli.build_engine(args, need_tokenizer=False,
                                                         origin="cli.server")
        if "--tp" in flags:
            assert engine.gen.tp == 2 and sorted(engine._kv) == [0, 1]
        else:
            assert engine.host_tier.store.num_slots > 0 and engine.cfg.host_pool_mib == 64
        return
    with pytest.raises(SystemExit, match="not ported"):
        server_cli.main(argv)


def test_server_cli_help_covers_its_flags():
    help_text = " ".join(server_cli.build_parser().format_help().split())
    for flag in ("--host", "--port", "--admission-queue", "--drain-timeout", "--policy",
                 "--spec-k", "--temperature", "--draft-model", "--metrics-out"):
        assert flag in help_text, f"{flag} missing from cli.server --help"
    assert "429" in help_text


# ---------------------------------------------------------------------------
# loadgen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qps", [0.5, 4.0, 64.0])
def test_poisson_and_replay_arrivals_equal_jax(qps):
    trace = _trace(lengths=(3, 4, 5, 6, 7, 8), news=(2,) * 6)
    for seed in (10137, 1):
        got = loadgen.poisson_arrivals(trace, qps, seed=seed)
        want = jloadgen.poisson_arrivals(trace, qps, seed=seed)
        assert [vars(a) for a in got] == [vars(a) for a in want]
    timed = [(rid, p, n, 0.5 * i) for i, (rid, p, n) in enumerate(trace)]
    assert ([vars(a) for a in loadgen.replay_arrivals(timed, speed=qps)]
            == [vars(a) for a in jloadgen.replay_arrivals(timed, speed=qps)])
    with pytest.raises(ValueError):
        loadgen.poisson_arrivals(trace, 0.0)


class StubFrontend:
    """Accepts the first `bound` submissions, rejects the rest; every
    accepted handle completes at once."""

    def __init__(self, mod, bound):
        import threading

        self.mod, self.bound, self.n, self.threading = mod, bound, 0, threading

    def submit(self, prompt, max_new, rid=None, **kw):
        self.n += 1
        if self.n > self.bound:
            raise self.mod.QueueFullError("full")

        class H:
            pass

        h = H()
        h.done, h.error, h.cancelled = self.threading.Event(), None, False
        h.done.set()
        return h


def test_open_loop_runner_and_sweep_on_a_fake_clock_equal_jax():
    from mdi_llm_tpu.server import frontend as jfrontend

    trace = _trace(lengths=(3,) * 8, news=(2,) * 8)
    reports = []
    for mod, lg in ((frontend_mod, loadgen), (jfrontend, jloadgen)):
        now = [0.0]
        runner = lg.OpenLoopRunner(
            StubFrontend(mod, bound=5), lg.poisson_arrivals(trace, 4.0, seed=3),
            clock=lambda: now[0], sleep=lambda dt: now.__setitem__(0, now[0] + dt))
        reports.append(runner.run().to_dict())
    assert reports[0] == reports[1]
    assert reports[0]["accepted"] == 5 and reports[0]["rejected"] == 3

    def measure(qps):  # a synthetic queue: latency grows with load
        return {"ttft_p99_s": 0.05 * qps, "tpot_p99_s": 0.01 * qps,
                "rejected": int(qps > 30)}

    slo = {"ttft_p99_s": 1.0, "tpot_p99_s": 0.3}
    grid = [1, 2, 4, 8, 16, 32, 64]
    assert (loadgen.sweep_offered_load(measure, grid, slo)
            == jloadgen.sweep_offered_load(measure, grid, slo))
    out = loadgen.sweep_offered_load(measure, grid, slo, stop_after_misses=len(grid))
    assert out["max_qps_ok"] == 16 and out["knee_qps"] == 32 and len(out["rows"]) == 7


def test_open_loop_run_over_a_live_frontend(served):
    obs = ServingObserver()
    front = ServingFrontend(_engine(served, obs=obs)).start()
    arrivals = loadgen.poisson_arrivals(served["trace"], 200.0, seed=7)
    rep = loadgen.OpenLoopRunner(front, arrivals, drain_timeout_s=120.0).run()
    front.drain(timeout=60.0)
    front.stop()
    assert rep.completed == rep.accepted == len(served["trace"]) and rep.errored == 0
    assert obs.latency_summaries()["ttft_s"]["count"] == len(served["trace"])


# ---------------------------------------------------------------------------
# the schedule explorer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def harness(served):
    """Three requests, all seatable at once (max_batch=3): host-sync parity
    then holds for every admission order."""
    rng = np.random.default_rng(5)
    trace = [(f"r{i}", rng.integers(1, TINY["vocab_size"], n).tolist(), m)
             for i, (n, m) in enumerate([(3, 8), (7, 12), (5, 6)])]

    def engine():
        return served["gen"].serve(block_size=4, max_batch=3, prefill_chunk=8)

    offline = engine()
    for rid, p, m in trace:
        offline.add_request(rid, p, m)
    want, stats_off = offline.run()
    return {"trace": trace, "engine": engine, "want": want, "stats_off": stats_off}


def test_explorer_is_deterministic_per_seed():
    a = ScheduleExplorer(7, record=True)
    b = ScheduleExplorer(7, record=True)
    for tag in ("submit:enter", "engine:collect", "drain:flagged", "t"):
        a.visit(tag)
        b.visit(tag)
    assert a.visits == b.visits == 4
    assert [t for _, t in a.trace] == [t for _, t in b.trace]
    assert ScheduleExplorer(8)._rng.random() != ScheduleExplorer(7)._rng.random()


def test_single_installation_is_enforced_and_uninstalled_on_exit():
    assert frontend_mod._YIELD is None, "production default: no explorer"
    frontend_mod._yield_point("anything")
    with ScheduleExplorer(1) as a:
        assert frontend_mod._YIELD == a.visit
        with pytest.raises(RuntimeError):
            ScheduleExplorer(2).install()
    assert frontend_mod._YIELD is None


def test_200_seeded_interleavings_match_offline(harness):
    want, stats_off = harness["want"], harness["stats_off"]
    visits = 0
    guard = CompileGuard(label="explorer-parity")
    with guard:
        guard.mark_warm()
        for seed in PARITY_SEEDS:
            ep = run_episode(harness["engine"](), harness["trace"], seed, live=False)
            assert ep["errors"] == {}, (seed, ep["errors"])
            assert ep["drained"], f"seed {seed}: drain timed out"
            for rid, p, _m in harness["trace"]:
                h = ep["handles"][rid]
                assert h.result == want[rid], f"seed {seed}: {rid} diverged"
                assert h.tokens == want[rid][len(p):], f"seed {seed}: {rid} streamed wrong"
            engine = ep["frontend"].engine
            assert engine.stats.host_syncs == stats_off.host_syncs, f"seed {seed}: syncs"
            assert ep["frontend"].idle and engine.scheduler.finished == []
            visits += ep["explorer"].visits
    guard.expect_clean()
    assert visits > len(PARITY_SEEDS) * 10, "the explorer must perturb the yield points"


def test_live_adversarial_episodes_hold_invariants(harness):
    want = harness["want"]
    for seed in ADVERSARIAL_SEEDS:
        cancel = ("r1",) if seed % 2 else ("r0", "r2")
        ep = run_episode(harness["engine"](), harness["trace"], seed, live=True,
                         cancel=cancel, drain_race=(seed % 3 == 0))
        assert ep["drained"], f"seed {seed}: drain timed out"
        for rid, p, _m in harness["trace"]:
            if rid in ep["errors"]:
                assert isinstance(ep["errors"][rid], FrontendClosedError)
                assert rid not in ep["handles"]
                continue
            h = ep["handles"][rid]
            assert h.done.is_set() and h.error is None, f"seed {seed}: {rid}: {h.error}"
            if h.cancelled:
                gen_want = want[rid][len(p):]
                assert h.tokens == gen_want[:len(h.tokens)] and rid in cancel
            else:
                assert h.result == want[rid], f"seed {seed}: {rid} diverged (live)"
        assert ep["frontend"].idle and ep["frontend"].engine.scheduler.finished == []


def test_drained_frontend_rejects_with_zero_side_effects(harness):
    engine = harness["engine"]()
    front = ServingFrontend(engine).start()
    assert front.drain(timeout=60.0)
    with pytest.raises(FrontendClosedError):
        front.submit([1, 2, 3], 4, rid="late")
    assert front._offered == 0 and engine.stats.offered_qps == 0.0
    assert "late" not in front._handles
    front.stop()


def test_drain_window_regression_seeds(harness):
    want, trace = harness["want"], harness["trace"]
    for seed in DRAIN_REGRESSION_SEEDS:
        ep = run_episode(harness["engine"](), trace, seed, live=True, drain_race=True)
        assert ep["drained"], f"seed {seed}: drain timed out"
        accepted, rejected = set(ep["handles"]), set(ep["errors"])
        assert accepted | rejected == {rid for rid, _, _ in trace}
        assert not (accepted & rejected), "half-admitted request"
        assert all(isinstance(ep["errors"][r], FrontendClosedError) for r in rejected)
        for rid in accepted:
            h = ep["handles"][rid]
            assert h.done.is_set() and h.result == want[rid], f"seed {seed}: {rid}"
        assert ep["frontend"]._offered == len(accepted)


class RacyFrontend(ServingFrontend):
    """Deliberately broken: the channel hand-off snapshots and clears
    WITHOUT the lock; a submit landing in the window is lost."""

    def _drain_channel(self):
        frontend_mod._yield_point("engine:drain-channel")
        batch = list(self._channel)  # racy snapshot (no lock)
        frontend_mod._yield_point("racy:window")
        self._channel.clear()
        for _handle, req in batch:
            self.engine.scheduler.add(req)


def test_explorer_catches_the_planted_lost_update(harness):
    rng = np.random.default_rng(11)
    trace = [(f"x{i}", rng.integers(1, TINY["vocab_size"], 4).tolist(), 4) for i in range(6)]
    detections = []
    for seed in DETECTOR_SEEDS:
        ep = run_episode(harness["engine"](), trace, seed, live=True,
                         frontend_cls=RacyFrontend, drain_timeout_s=0.75,
                         explorer_kwargs={"p_pause": 1.0, "max_pause_s": 0.004})
        if ep["drained"]:
            continue
        lost = [rid for rid, h in ep["handles"].items()
                if h.error == "frontend stopped before completion"]
        assert lost, f"seed {seed}: undrained but no handle reports the loss"
        detections.append((seed, lost))
    assert detections, "no seed caught the planted lost-update"


def test_doctor_burst_is_clean():
    out = doctor_burst(n_seeds=2)
    assert out["ok"] and out["mismatches"] == [] and out["yield_point_visits"] > 0
    json.dumps(out)
