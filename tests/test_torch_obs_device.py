"""The port's step reports (`obs/device.py`), the captures guard and the
bounded profiler window (`utils/profiling.py`), on the CPU.

- a step's FlopCounterMode count (the plain route, on the CPU) agrees
  with the analytic model (`obs/roofline.py`) at the step's static shapes
  within `FLOP_AGREEMENT_RTOL`: the mixed step, the decode chunk, the
  per-token decode and the greedy verify, over fp and int8 pools; the
  reports carry the step's input/output/pool bytes and no error;
- the kernel wrappers' flop tally: what a launch adds equals what
  FlopCounterMode counts for the plain route of the same call;
- a body that raises gives a report with `error` set and raises nothing;
- through a stand-in for the CUDA graph (a capture records the body, as
  in tests/test_torch_graphs.py) the probe measures the warm-up, the
  engine still captures and replays, and its streams are unchanged;
- `Generator.attach_device_obs`: `generate` measures its prefill and
  decode chunk once per shape, with unchanged tokens;
- the captures guard counts every capture, passes a run after warm-up
  and fails on a capture after `mark_warm` (an engine built inside the
  steady state); guards nest;
- `StepWindowProfiler` writes a Chrome trace of the window on the CPU,
  and `profile()` a cProfile dump.
"""

import json

import numpy as np
import pytest
import torch

from mdi_llm_tpu_torch import kernels
from mdi_llm_tpu_torch.config import Config, ServingConfig
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.obs import ServingObserver
from mdi_llm_tpu_torch.obs import roofline as rf
from mdi_llm_tpu_torch.obs.device import (
    DeviceReportRegistry,
    ExecutableReport,
    Probe,
    introspect_step,
)
from mdi_llm_tpu_torch.serving.engine import ServingEngine, pool_bytes
from mdi_llm_tpu_torch.utils import profiling, step_graph
from mdi_llm_tpu_torch.utils.step_graph import StepGraph

torch.set_num_threads(1)

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)
BASE = dict(block_size=4, max_batch=3, prefill_chunk=8)


@pytest.fixture(scope="module")
def cfg():
    return Config(**TINY)


def _gen(cfg, **kw):
    params = transformer.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    return Generator(cfg, params, cache_dtype=torch.float32, device="cpu", **kw)


def _trace(seed=5, lens=(3, 9, 17, 5), news=(8, 12, 6, 10)):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(1, TINY["vocab_size"], n).tolist(), m)
            for i, (n, m) in enumerate(zip(lens, news))]


def _cycling_trace():
    return [(f"r{i}", np.random.default_rng(s).integers(1, TINY["vocab_size"], 5).tolist(), m)
            for i, (s, m) in enumerate(zip((0, 3, 4), (24, 20, 16)))]


def _serve(engine, trace):
    for rid, prompt, new in trace:
        engine.add_request(rid, prompt, new)
    return engine.run()


@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_step_flops_agree_with_the_analytic_model(cfg, pool, decode_chunk):
    obs = ServingObserver(device=True)
    gen = _gen(cfg)
    engine = gen.serve(serving=ServingConfig(
        **BASE, decode_chunk=decode_chunk, kv_dtype="int8" if pool == "int8" else None),
        obs=obs)
    B, T = engine.scheduler.max_batch, engine.token_budget
    window = engine.max_blocks_per_seq * engine.pool.block_size
    per_token = rf.decode_flops_per_token(cfg, window)
    decode = ("decode", (B,), B) if decode_chunk == 1 else (
        "decode_chunk", (B, decode_chunk), B * decode_chunk)
    for label, key, n_tokens in (("mixed", (B, T), T), decode):
        rep = obs.device.get(label, key, engine.kv_dtype_name)
        assert rep is not None and rep.error is None, rep
        cross = rf.crosscheck_flops(rep, n_tokens * per_token)
        assert cross["agrees"] is True, cross
        assert cross["rel_err"] < 0.01  # matmuls and attention are all of it
        assert rep.backend == "cpu" and rep.temp_bytes is None
        assert rep.alias_bytes == pool_bytes(engine._kv)
        assert rep.argument_bytes == sum(x.numel() * x.element_size()
                                         for x in engine._steps[label].inputs.values())
        assert rep.output_bytes > 0
        json.dumps(rep.to_dict())
    assert obs.metrics.to_dict()["gauges"]["step_mixed_flops"] == obs.device.get(
        "mixed", (B, T), engine.kv_dtype_name).flops


def test_verify_is_measured_at_its_first_call(cfg):
    obs = ServingObserver(device=True)
    engine = _gen(cfg).serve(serving=ServingConfig(**BASE, decode_chunk=4, spec_k=3), obs=obs)
    _results, stats = _serve(engine, _cycling_trace())
    assert stats.spec_drafted > 0
    B, K = engine.scheduler.max_batch, 3
    rep = obs.device.get("verify", (B, K + 1), engine.kv_dtype_name)
    assert rep is not None and rep.error is None
    window = engine.max_blocks_per_seq * engine.pool.block_size
    cross = rf.crosscheck_flops(rep, B * (K + 1) * rf.decode_flops_per_token(cfg, window))
    assert cross["agrees"] is True, cross


def test_kernel_flop_tally_matches_the_plain_routes_count():
    """The flops a K1 launch adds to the tally are the ones FlopCounterMode
    counts for the plain route of the same call (every packed row against
    the whole table window)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    T, H, G, hs, BS, MB, S = 12, 4, 2, 16, 4, 5, 3
    q = torch.randn(1, H, T, hs)
    k = torch.randn(1 + S * MB, BS, G, hs)
    tables = torch.arange(1, 1 + S * MB, dtype=torch.int32).reshape(S, MB)
    q_start = torch.tensor([0, 4, 8], dtype=torch.int32)
    q_len = torch.tensor([4, 4, 4], dtype=torch.int32)
    q_pos = torch.arange(T, dtype=torch.int32) % 4 + 3
    with FlopCounterMode(display=False) as mode:
        rpa.ragged_paged_attention_plain(q, k, k, tables, q_start, q_len, None, q_pos,
                                         scale=0.25)
    with kernels.flop_tally() as tally:
        kernels.add_flops(4.0 * T * H * hs * MB * BS)  # what the launch adds
    assert tally.flops == mode.get_total_flops()
    kernels.add_flops(1.0)  # outside a tally: a no-op
    with kernels.flop_tally() as outer:
        with kernels.flop_tally() as inner:
            kernels.add_flops(3.0)
        kernels.add_flops(2.0)
    assert (inner.flops, outer.flops) == (3.0, 2.0)


def test_a_failing_body_is_a_report_not_an_exception():
    class Owner:
        pass

    owner = Owner()

    def body(_owner, x):
        raise ValueError("refused")

    step = StepGraph("mixed", (2, 8), owner, body, {"x": torch.zeros(2)}, capture=False)
    rep = introspect_step(step, "mixed", (2, 8), "float32")
    assert rep.error == "ValueError: refused"
    assert rep.flops is None and rep.argument_bytes is None
    assert rep.to_dict()["error"] == "ValueError: refused"


def test_registry_dedups_and_publish_only_mode():
    calls = []

    def measure():
        calls.append(1)
        return ExecutableReport(label="mixed", key=(2, 8), flops=1.0)

    reg = DeviceReportRegistry()
    a = reg.capture("mixed", (2, 8), measure)
    b = reg.capture("mixed", (2, 8), measure)
    assert a is b and len(calls) == 1 and len(reg) == 1
    off = DeviceReportRegistry(capture_enabled=False)
    assert off.capture("mixed", (2, 8), measure) is None and len(calls) == 1
    off.add(a)
    off.add(ExecutableReport(label="mixed", key=(2, 8), flops=2.0))  # first one wins
    assert off.get("mixed", (2, 8)).flops == 1.0
    assert list(off.to_dict()) == ["mixed(2,8)"]


def _fake_graph_class(fail=False):
    """A stand-in for `step_graph.CudaGraph` (as in test_torch_graphs.py):
    a capture records the body, a replay runs it with every counter held."""

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
            if fail:
                raise RuntimeError("the stand-in refuses to capture")
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


def test_probe_measures_the_warm_up_of_a_capture(cfg, monkeypatch):
    trace = _trace()
    want, want_stats = _serve(_gen(cfg).serve(**BASE, decode_chunk=4), trace)
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class())
    obs = ServingObserver(device=True)
    engine = ServingEngine(_gen(cfg), ServingConfig(**BASE, decode_chunk=4), obs=obs,
                           _graphs=True)
    assert engine.graph_stats()["captures"] == 2
    assert len(obs.device) == 2 and all(
        r.error is None and r.flops > 0 for r in obs.device.reports())
    got, stats = _serve(engine, trace)
    assert got == want and stats.host_syncs == want_stats.host_syncs
    assert engine.graph_stats()["captures"] == 2 and engine.graph_stats()["replays"] > 0


def test_a_failed_capture_is_reported_then_the_engine_raises(cfg, monkeypatch):
    """The probe never raises; the engine's own capture of the step then
    fails as it would without an observer: no eager fallback."""
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(fail=True))
    gen = _gen(cfg, _graphs=True)
    obs = ServingObserver(device=True)
    with pytest.raises(RuntimeError, match="capture of step 'mixed'"):
        gen.serve(serving=ServingConfig(**BASE, decode_chunk=4), obs=obs)
    (rep,) = gen._exec_reports.values()
    assert "refuses to capture" in rep.error


def test_generate_measures_prefill_and_decode_chunk_once(cfg):
    prompts = [p for _rid, p, _n in _trace(lens=(9, 9))]
    want, _ = _gen(cfg).generate(prompts, 20, temperature=0.0, chunk_size=8)
    gen = _gen(cfg)
    reg = DeviceReportRegistry()
    gen.attach_device_obs(reg)
    got, _ = gen.generate(prompts, 20, temperature=0.0, chunk_size=8)
    assert got == want
    names = set(reg.to_dict())
    # the first token comes from the prefill: 19 decode steps in chunks of 8
    assert names == {"prefill(2,16)", "decode_chunk(2,8)", "decode_chunk(2,3)"}, names
    assert all(r.error is None and r.flops > 0 for r in reg.reports())
    got2, _ = gen.generate(prompts, 20, temperature=0.0, chunk_size=8)
    assert got2 == want and len(reg) == 3
    gen.attach_device_obs(None)
    assert gen.generate(prompts, 20, temperature=0.0, chunk_size=8)[0] == want


# ---------------------------------------------------------------------------
# the captures guard
# ---------------------------------------------------------------------------


def test_guard_counts_captures_and_passes_a_clean_steady_state(cfg, monkeypatch):
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class())
    guard = profiling.CompileGuard(label="serve")
    with guard:
        engine = ServingEngine(_gen(cfg), ServingConfig(**BASE, decode_chunk=4), _graphs=True)
        guard.mark_warm()
        _serve(engine, _trace())
    guard.expect_clean()
    assert guard.summary() == {"captures": 2, "captures_after_warmup": 0}
    assert guard.captured[0].startswith("mixed (3, 11")


def test_guard_fails_on_a_capture_after_mark_warm(cfg, monkeypatch):
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class())
    outer = profiling.CompileGuard(label="outer")
    with outer:
        ServingEngine(_gen(cfg), ServingConfig(**BASE, decode_chunk=4), _graphs=True)
        outer.mark_warm()
        inner = profiling.CompileGuard(label="inner", max_recompiles_after_warmup=2)
        with inner:
            inner.mark_warm()
            # a step built inside the steady state captures there
            ServingEngine(_gen(cfg), ServingConfig(**BASE, decode_chunk=1), _graphs=True)
    inner.expect_clean()  # its allowance covers the 2 captures
    assert inner.captures == 2 and outer.captures == 4
    with pytest.raises(profiling.RecompileError, match=r"\[outer\]: 2 step capture"):
        outer.expect_clean()
    lenient = profiling.CompileGuard()
    with lenient:
        ServingEngine(_gen(cfg), ServingConfig(**BASE), _graphs=True)
    lenient.expect_clean()  # no warm mark: nothing to judge
    assert lenient.captures_after_warmup is None


# ---------------------------------------------------------------------------
# profiler window
# ---------------------------------------------------------------------------


def test_step_window_profiler_writes_a_trace_on_the_cpu(tmp_path):
    prof = profiling.StepWindowProfiler(tmp_path / "xprof", n_steps=2, skip=1)
    x = torch.randn(16, 16)
    for i in range(1, 6):
        x = torch.tanh(x @ x)
        prof.on_step(i)
    prof.close()
    assert prof.window == (2, 3) and prof.done and not prof.active
    trace = json.loads(prof.path.read_text())
    assert prof.path.name == "steps_2-3.json"
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    early = profiling.StepWindowProfiler(tmp_path / "early", n_steps=4, skip=0)
    early.on_step(0)
    early.close()  # a window left open by a short run is closed and written
    assert early.window == (1, 0) and early.path.exists()
    with pytest.raises(ValueError):
        profiling.StepWindowProfiler(tmp_path, n_steps=0)


def test_profile_writes_host_and_device_traces(tmp_path):
    with profiling.profile(tmp_path / "trace", tmp_path / "host.prof"):
        torch.randn(8, 8) @ torch.randn(8, 8)
    assert (tmp_path / "host.prof").stat().st_size > 0
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]


def test_probe_counts_flops_of_any_callable():
    probe = Probe()
    out = probe.measure(lambda: torch.randn(4, 8) @ torch.randn(8, 3))
    assert probe.flops == 2 * 4 * 8 * 3 and probe.output_bytes == out.numel() * 4
    probe.capture_begins()
    probe.captured()
    assert probe.temp_bytes is None  # the CPU has no graph pool
