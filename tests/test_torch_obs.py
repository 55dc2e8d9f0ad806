"""The port's serving observability (`mdi_llm_tpu_torch/obs/`) against the
JAX package's, on the CPU.

- the same hook sequence on a fake clock, fed to both packages'
  `ServingObserver`, gives equal `metrics_dict()` (the port's renamed
  metrics translated through `obs.JAX_NAMES`), equal latency summaries,
  equal Prometheus text and equal Chrome traces;
- a live port engine and the JAX engine on the same (converted) weights,
  over the same trace, give equal `serving_*` counters and gauges, equal
  histogram counts and equal engine-step spans: chunked decode with and
  without double buffering, per-token decode, a preempting pool, an int8
  pool, prefix-cache hits, and speculative serving on cycling prompts
  (the spec counters and the verify spans' `spec_k`/`accepted`);
- observer on (with device capture) versus off leaves greedy streams,
  host_syncs and forward counts unchanged;
- the port's roofline equals the JAX package's for registry configs,
  and only the SXM H100's device name maps to a peak row.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.config import ServingConfig as JServingConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.obs import ServingObserver as JObserver
from mdi_llm_tpu.obs import roofline as jrf
from mdi_llm_tpu.obs.device import ExecutableReport as JReport
from mdi_llm_tpu_torch import obs as tobs
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.config import ServingConfig as TServingConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.obs import ServingObserver as TObserver
from mdi_llm_tpu_torch.obs import roofline as trf
from mdi_llm_tpu_torch.obs.device import ExecutableReport as TReport

torch.set_num_threads(1)

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)


class FakeClock:
    def __init__(self, t0: float = 100.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


def to_jax_names(metrics: dict) -> dict:
    """The port's registry snapshot under the JAX observer's names."""
    out = {}
    for kind, entries in metrics.items():
        renamed = {}
        for name, value in entries.items():
            if name in tobs.JAX_NAMES:
                for jname in tobs.JAX_NAMES[name]:
                    renamed[jname] = value
            elif name.startswith("step_"):
                renamed["xla_" + name[len("step_"):]] = value
            else:
                renamed[name] = value
        out[kind] = renamed
    return out


# ---------------------------------------------------------------------------
# the same hook sequence on a fake clock
# ---------------------------------------------------------------------------


def _lifecycle(obs, clock, report_cls):
    obs.request_submitted("a", 5, 4)
    clock.tick(0.01)
    obs.request_submitted("b", 9, 3)
    obs.request_admitted("a", 0, 0)
    obs.request_admitted("b", 1, 1, n_cached=8)
    clock.tick(0.02)
    obs.step("mixed", width=12, live=2, t_start=clock() - 0.015,
             kv_utilization=0.25, queue_depth=0, useful_tokens=7)
    obs.prefill_chunk("a", 5)
    obs.prefill_chunk("b", 1)
    obs.tokens("a")
    obs.tokens("b")
    for i in range(3):
        clock.tick(0.004 + 0.001 * i)
        obs.step("decode_chunk", width=8, live=2, kv_utilization=0.3 + 0.1 * i,
                 queue_depth=1)
        obs.tokens("a")
        if i < 2:
            obs.tokens("b")
    obs.request_finished("b")
    obs.request_finished("a")
    obs.publish_device_report(report_cls(label="mixed", key=(2, 12), variant="float32",
                                         flops=1.5e9, temp_bytes=4096, argument_bytes=100))


def _preempt_resume(obs, clock, report_cls):
    obs.request_submitted("x", 17, 6)
    obs.request_submitted("y", 3, 2)
    clock.tick(0.003)
    obs.request_admitted("x", 0, 0)
    obs.step("mixed", width=16, live=1, kv_utilization=0.9, queue_depth=1)
    obs.prefill_chunk("x", 16)
    clock.tick(0.002)
    obs.request_preempted("x", 0)
    obs.request_admitted("y", 0, 1)
    obs.request_rejected("z")
    obs.step("mixed", width=16, live=1, queue_depth=1)
    obs.prefill_chunk("y", 3)
    obs.tokens("y")
    clock.tick(0.002)
    obs.step("decode", width=2, live=1, kv_utilization=0.2)
    obs.tokens("y")
    obs.request_finished("y")
    obs.request_admitted("x", 0, 2, resumed=True)
    clock.tick(0.005)
    obs.step("mixed", width=16, live=1, queue_depth=0)
    obs.prefill_chunk("x", 17)
    obs.tokens("x")
    obs.request_finished("x")


def _spec(obs, clock, report_cls):
    for rid in ("s0", "s1"):
        obs.request_submitted(rid, 6, 8)
        obs.request_admitted(rid, int(rid[1]), int(rid[1]))
    obs.step("mixed", width=14, live=2)
    for rid in ("s0", "s1"):
        obs.prefill_chunk(rid, 6)
        obs.tokens(rid)
    for k in range(3):
        clock.tick(0.006)
        obs.step("draft_scan", width=12, live=1, spec_k=4)
        clock.tick(0.003)
        obs.step("verify", width=10, live=2, spec_k=4, accepted=k + 1)
        obs.spec(4, k + 1, "ngram")
        obs.spec(3, 0, "model")
        obs.tokens("s0", k + 2)
        obs.tokens("s1", 1)
    obs.request_finished("s0")
    obs.publish_device_report(report_cls(label="verify", key=(2, 5), error="no counts"))
    obs.publish_device_report(report_cls(label="decode", key=(2,), flops=3e8))


HOOK_SEQUENCES = {"lifecycle": _lifecycle, "preempt-resume": _preempt_resume,
                  "spec": _spec}


@pytest.mark.parametrize("ring", [65536, 5], ids=["ring-64k", "ring-5"])
@pytest.mark.parametrize("seq", list(HOOK_SEQUENCES))
def test_same_hooks_same_exposition_as_jax(seq, ring):
    jclock, tclock = FakeClock(), FakeClock()
    jobs, tobs_ = JObserver(ring=ring, clock=jclock), TObserver(ring=ring, clock=tclock)
    HOOK_SEQUENCES[seq](jobs, jclock, JReport)
    HOOK_SEQUENCES[seq](tobs_, tclock, TReport)
    jd, td = jobs.metrics_dict(), tobs_.metrics_dict()
    assert to_jax_names(td.pop("metrics")) == jd.pop("metrics")
    assert td == jd  # latency block, per-request rows, ring, device reports
    assert tobs_.latency_summaries() == jobs.latency_summaries()
    assert tobs_.tracer.to_chrome_trace() == jobs.tracer.to_chrome_trace()
    # Prometheus: the same text but for the renamed metrics' lines
    renamed = re.compile(r"(step_|xla_|graph_captures|jax_)")
    assert ([ln for ln in tobs_.metrics.render_prometheus().splitlines() if not renamed.search(ln)]
            == [ln for ln in jobs.metrics.render_prometheus().splitlines()
                if not renamed.search(ln)])


def test_captures_counter_counts_step_captures_while_attached():
    """`graph_captures_total` takes the place of the JAX observer's jit
    trace/compile counters: it counts StepGraph captures between attach
    and detach, and nothing else."""
    from mdi_llm_tpu_torch.utils import profiling

    obs = TObserver()

    class Step:
        name, key = "mixed", (2, 12)

    profiling.note_capture(Step())
    obs.attach_compile_hook()
    obs.attach_compile_hook()  # idempotent
    profiling.note_capture(Step())
    profiling.note_capture(Step())
    obs.detach_compile_hook()
    profiling.note_capture(Step())
    assert obs.metrics.to_dict()["counters"] == {"graph_captures_total": 2}


def test_rss_gauge_and_missing_psutil_warns_once(monkeypatch, capsys):
    import sys

    obs = TObserver(rss_interval_s=0.0)
    obs.step("decode", width=2, live=1)
    assert obs.metrics.to_dict()["gauges"]["host_rss_bytes"] > 0
    monkeypatch.setitem(sys.modules, "psutil", None)  # import now fails
    obs = TObserver(rss_interval_s=0.0)
    for _ in range(3):
        obs.step("decode", width=2, live=1)
    assert "host_rss_bytes" not in obs.metrics.to_dict()["gauges"]
    assert capsys.readouterr().err.count("RSS sampling off") == 1


# ---------------------------------------------------------------------------
# a live engine in each package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    jc, tc = JConfig(**TINY), TConfig(**TINY)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return (JGenerator(jc, jp, cache_dtype=jnp.float32),
            TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu"))


def _random_prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], int(n)).tolist() for n in lens]


def _cycling_prompts(seeds):
    """Prompts whose greedy continuation echoes earlier context (the tiny
    random model falls into cycles), so n-gram drafting fires."""
    return [np.random.default_rng(s).integers(1, TINY["vocab_size"], 5).tolist()
            for s in seeds]


def _shared_prefix_prompts():
    """Two prompts over one 16-token prefix (4 full blocks of 4), the second
    submitted after the first has prefilled: its prefix blocks hit."""
    head = _random_prompts(11, [16])[0]
    return [head + [5, 6, 7], head + [9, 10], _random_prompts(12, [7])[0]]


BASE = dict(block_size=4, max_batch=3, prefill_chunk=8)
CASES = {
    "chunk4-buffered": (dict(decode_chunk=4, double_buffer=True), "random"),
    "chunk4-nobuf": (dict(decode_chunk=4, double_buffer=False), "random"),
    "per-token": (dict(decode_chunk=1), "random"),
    "preempting-pool": (dict(decode_chunk=4, max_blocks=1 + 10, prefix_caching=False), "random"),
    "int8-pool": (dict(decode_chunk=4, kv_dtype="int8"), "random"),
    "prefix-hits": (dict(decode_chunk=1, max_batch=1), "shared"),
    "spec-ngram": (dict(decode_chunk=4, spec_k=3), "cycling"),
}


def _trace(kind):
    if kind == "cycling":
        prompts, news = _cycling_prompts([0, 3, 4]), [24, 20, 16]
    elif kind == "shared":
        prompts, news = _shared_prefix_prompts(), [6, 5, 4]
    else:
        prompts, news = _random_prompts(5, [3, 9, 17, 5, 33]), [8, 12, 6, 10, 7]
    return [(f"r{i}", p, n) for i, (p, n) in enumerate(zip(prompts, news))]


def _serve(gen, serving, trace, obs):
    engine = gen.serve(serving=serving, obs=obs)
    for rid, prompt, new in trace:
        engine.add_request(rid, prompt, new)
    results, stats = engine.run()
    return results, stats, engine


def _serving_view(obs):
    """The deterministic part of an observer: every serving_* counter and
    gauge, histogram counts, latency counts and the engine-step spans."""
    m = obs.metrics.to_dict()
    keep = {kind: {k: v for k, v in m[kind].items() if k.startswith("serving_")}
            for kind in ("counters", "gauges")}
    keep["histograms"] = {k: v["count"] for k, v in m["histograms"].items()}
    keep["latency_counts"] = {k: v["count"] for k, v in obs.latency_summaries().items()}
    keep["steps"] = [(e["name"], e["args"]) for e in obs.tracer.events
                     if e["ph"] == "X" and e["pid"] == 2]
    keep["requests"] = [(t.rid, t.admit_order, t.n_prompt, t.n_tokens, t.prefill_chunks,
                         t.preemptions) for t in obs.tracer.completed]
    return keep


@pytest.mark.parametrize("case", list(CASES))
def test_live_engine_counters_match_jax(served, case):
    jgen, tgen = served
    knobs, kind = CASES[case]
    knobs = {**BASE, **knobs}
    trace = _trace(kind)
    jobs, tobs_ = JObserver(), TObserver()
    jres, jstats, _ = _serve(jgen, JServingConfig(**knobs), trace, jobs)
    tres, tstats, _ = _serve(tgen, TServingConfig(**knobs), trace, tobs_)
    assert tres == jres
    assert tstats.host_syncs == jstats.host_syncs
    jv, tv = _serving_view(jobs), _serving_view(tobs_)
    assert tv == jv
    c = tv["counters"]
    assert c["serving_tokens_generated_total"] == tstats.tokens_generated
    assert c["serving_host_syncs_total"] == tstats.host_syncs
    assert c["serving_requests_finished_total"] == len(trace)
    if case == "spec-ngram":
        assert c["serving_spec_drafted_total"] == tstats.spec_drafted > 0
        assert c["serving_spec_accepted_total"] == tstats.spec_accepted > 0
        verify = [a for name, a in tv["steps"] if name == "verify"]
        assert verify and all(a["spec_k"] == 3 for a in verify)
        assert sum(a["accepted"] for a in verify) == tstats.spec_accepted
    if case == "prefix-hits":
        assert c["serving_prefix_hit_blocks_total"] == tstats.prefix_cache_hits > 0
        assert c["serving_prefix_cached_tokens_total"] > 0
    if case == "preempting-pool":
        assert c["serving_preemptions_total"] == tstats.preemptions > 0


@pytest.mark.parametrize("case", ["chunk4-buffered", "per-token", "spec-ngram", "int8-pool"])
def test_observer_on_or_off_leaves_streams_and_syncs(served, case):
    _, tgen = served
    knobs, kind = CASES[case]
    serving = TServingConfig(**{**BASE, **knobs})
    trace = _trace(kind)
    off, off_stats, off_eng = _serve(tgen, serving, trace, None)
    obs = TObserver(device=True, rss_interval_s=0.0)
    on, on_stats, on_eng = _serve(tgen, serving, trace, obs)
    assert on == off
    assert on_stats.host_syncs == off_stats.host_syncs
    assert on_eng.forward_calls == off_eng.forward_calls
    assert on_stats.to_dict()["tokens_generated"] == off_stats.tokens_generated
    assert len(obs.device) >= 2 and all(r.error is None for r in obs.device.reports())


def test_fresh_observer_receives_cached_reports_without_measuring(served):
    """Reports are cached on the Generator: a second engine's observer
    that does not capture gets them at run end, as in the JAX package."""
    _, tgen = served
    serving = TServingConfig(**BASE, decode_chunk=4)
    trace = _trace("random")
    first = TObserver(device=True)
    _serve(tgen, serving, trace, first)
    second = TObserver()
    _serve(tgen, serving, trace, second)
    assert second.device.to_dict() == {
        k: v for k, v in first.device.to_dict().items() if k in second.device.to_dict()}
    assert len(second.device) >= 2
    assert "step_mixed_flops" in second.metrics.to_dict()["gauges"]


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


ROOF_MODELS = ["pythia-14m", "tiny-llama-1.1b", "NanoLlama", "Llama-3-8B-Instruct"]


@pytest.mark.parametrize("name", ROOF_MODELS)
def test_roofline_equals_jax(name):
    jc, tc = JConfig.from_name(name), TConfig.from_name(name)
    for ctx in (1, 37, 1000):
        assert trf.decode_flops_per_token(tc, ctx) == jrf.decode_flops_per_token(jc, ctx)
        assert trf.prefill_flops_per_token(tc, ctx) == jrf.prefill_flops_per_token(jc, ctx)
    for kv_dtype in (None, "int8"):
        js, ts = (JServingConfig(block_size=16, max_batch=8, kv_dtype=kv_dtype),
                  TServingConfig(block_size=16, max_batch=8, kv_dtype=kv_dtype))
        for serving in ((js, ts), (None, None)):
            args = dict(batch=6, context=777, weight_bytes=2_200_000_000)
            assert (trf.decode_hbm_bytes_per_token(tc, serving[1], **args)
                    == jrf.decode_hbm_bytes_per_token(jc, serving[0], **args))
            kw = dict(tokens_per_s=1234.5, context=640, batch=7, weight_bytes=10**9,
                      device_kind="cpu")
            jroof = jrf.serving_roofline(jc, serving[0], **kw)
            troof = trf.serving_roofline(tc, serving[1], **kw)
            assert troof == jroof and troof["mfu"] is None


def test_param_bytes_equal_jax_on_converted_weights():
    jc = JConfig(**TINY)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert trf.param_bytes(tp) == jrf.param_bytes(jp) > 0


@pytest.mark.parametrize("kind,norm", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("nvidia h100 80gb hbm3", "h100"),
    ("NVIDIA H100 PCIe", None), ("NVIDIA H100 NVL", None), ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None), ("TPU v5 lite", None), (None, None), ("", None),
])
def test_only_the_sxm_h100_maps_to_a_peak_row(kind, norm):
    assert trf.normalize_device_kind(kind) == norm
    peaks = trf.device_peaks(kind)
    assert peaks == ({"bf16_tflops": 989.0, "hbm_gbps": 3350.0} if norm else None)


def test_h100_roofline_mfu_mbu_derivation():
    cfg = TConfig.from_name("tiny-llama-1.1b")
    serving = TServingConfig(block_size=16, max_batch=8)
    roof = trf.serving_roofline(cfg, serving, tokens_per_s=1000.0, context=600, batch=8,
                                weight_bytes=2_200_000_000, device_kind="NVIDIA H100 80GB HBM3")
    flops = trf.decode_flops_per_token(cfg, 600)
    assert roof["mfu"] == pytest.approx(1000.0 * flops / 989e12)
    hbm = trf.decode_hbm_bytes_per_token(cfg, serving, 8, 600, 2_200_000_000)
    assert roof["mbu"] == pytest.approx(1000.0 * hbm["total_bytes"] / 3350e9)
    assert 0 < roof["mfu"] < roof["mbu"] < 1


def test_readers_on_another_thread_never_see_a_ring_mutate():
    """`/v1/stats` reads the latency window on the HTTP thread while the
    engine thread retires requests: the port snapshots each ring before
    iterating it (the JAX recorder iterates the live deque and raises
    "deque mutated during iteration" under the same load)."""
    import sys
    import threading
    import time

    obs = TObserver(ring=512)
    stop = threading.Event()
    errors = []

    def engine():
        i = 0
        while not stop.is_set():
            rid = f"r{i}"
            obs.request_submitted(rid, 3, 2)
            obs.request_admitted(rid, 0, i)
            obs.step("decode", width=2, live=1)
            obs.tokens(rid)
            obs.tokens(rid)
            obs.request_finished(rid)
            i += 1

    def reader(fn):
        while not stop.is_set():
            try:
                fn()
            except RuntimeError as e:
                errors.append(f"{fn.__name__}: {e}")
                return

    readers = [obs.latency_summaries, obs.metrics_dict, obs.tracer.to_chrome_trace,
               obs.metrics.render_prometheus]
    threads = [threading.Thread(target=engine)] + [
        threading.Thread(target=reader, args=(fn,)) for fn in readers]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert obs.metrics.to_dict()["counters"]["serving_requests_finished_total"] >= 10
