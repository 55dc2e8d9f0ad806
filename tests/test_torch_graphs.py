"""The port's per-shape steps (`mdi_llm_tpu_torch/utils/step_graph.py`)
against the JAX package, on the CPU.

On the card the serving engine's mixed step, decode chunk and per-token
decode, and `Generator.generate`'s decode chunk, are CUDA graphs captured
over static buffers and replayed.  On the CPU the same step bodies run on
the same static buffers, so these tests hold that plumbing:

- engine greedy streams through the `StepGraph` bodies equal the JAX
  `ServingEngine`'s token for token (with the same host_syncs): decode
  chunk 1 and 4, double buffering on and off, fp and int8 pools, a token
  budget smaller than a prompt, a pool small enough to preempt, on a
  pythia-14m-class model and a tiny GQA llama;
- `Generator.generate` greedy tokens equal the JAX `generate`'s with a tail
  chunk shorter than `chunk_size` and with a batch compaction; a second
  call with the same shapes builds and captures no new step;
- every step body runs with `torch.tensor`, `Tensor.item`, `.cpu`,
  `.numpy`, `.tolist` (and the implicit host reads `bool`, `int`, `float`)
  patched to raise: a step makes no host copy and no host read, which a
  CUDA graph capture would refuse;
- the capture/replay accounting, through a stand-in for the CUDA graph
  (`FakeGraph`: a capture records the body, a replay runs it with every
  counter held still, as a replay runs no Python): after the run every
  counter equals the eager run's, and the streams too; a stand-in whose
  capture raises makes the engine and `generate` raise, never run eagerly;
- a dropped engine or Generator is freed at once (the steps hold their
  owner weakly);
- the sampled engine at temperature 0.8: the first token (the mixed step)
  and the second (the decode step) follow the JAX package's filtered
  softmax, by the 5-sigma frequency test of the port's CPU suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops import sampling as jsampling
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.config import ServingConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.ops import paged_attention as tpa
from mdi_llm_tpu_torch.serving.engine import ServingEngine
from mdi_llm_tpu_torch.utils import step_graph

torch.set_num_threads(1)

LLAMA = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)
MODELS = {"tiny-gqa-llama": (None, LLAMA),
          "pythia-14m-class": ("pythia-14m", dict(n_layer=2, vocab_size=512))}


class Pair:
    """One model in both packages on the same float32 weights."""

    def __init__(self, key):
        name, kw = MODELS[key]
        if name is None:
            self.jc, self.tc = JConfig(**kw), TConfig(**kw)
        else:
            self.jc, self.tc = JConfig.from_name(name, **kw), TConfig.from_name(name, **kw)
        self.jp = jtf.init_params(self.jc, jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))
        self.jgen = JGenerator(self.jc, self.jp, cache_dtype=jnp.float32, use_flash=False)

    def tgen(self, **kw):
        return TGenerator(self.tc, self.tp, cache_dtype=torch.float32, device="cpu", **kw)

    def prompts(self, seed, lens):
        rng = np.random.default_rng(seed)
        return [rng.integers(1, self.tc.vocab_size, int(n)).tolist() for n in lens]


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def llama():
    return Pair("tiny-gqa-llama")


@pytest.fixture(scope="module")
def pythia():
    return Pair("pythia-14m-class")


def _serve(gen, trace, **knobs):
    engine = gen.serve(**knobs)
    for rid, prompt, new in trace:
        engine.add_request(rid, prompt, new)
    results, stats = engine.run()
    return results, stats, engine


BASE = dict(block_size=4, max_batch=3, prefill_chunk=8)
ENGINE_CASES = {
    "k1": dict(decode_chunk=1, double_buffer=False),
    "k4-buffered": dict(decode_chunk=4, double_buffer=True),
    "k4-nobuf": dict(decode_chunk=4, double_buffer=False),
    "int8-k4-buffered": dict(decode_chunk=4, double_buffer=True, kv_dtype="int8"),
    "int8-k1": dict(decode_chunk=1, kv_dtype="int8"),
    "budget-below-prompt": dict(decode_chunk=4, token_budget=12, prefill_chunk=64),
    "preempting-pool": dict(decode_chunk=4, double_buffer=True, max_blocks=1 + 10,
                            prefix_caching=False),
}


def _trace(pair, case):
    if case == "budget-below-prompt":
        prompts = pair.prompts(13, (41, 5, 19))
        return [(f"r{i}", p, n) for i, (p, n) in enumerate(zip(prompts, (6, 10, 8)))]
    if case == "preempting-pool":
        return [(f"p{i}", p, 10) for i, p in enumerate(pair.prompts(9, (9, 13, 11)))]
    prompts = pair.prompts(5, (3, 9, 17, 5, 33))
    return [(f"r{i}", p, n) for i, (p, n) in enumerate(zip(prompts, (8, 12, 6, 10, 7)))]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_steps_give_the_jax_engines_streams(pair, case):
    knobs = {**BASE, **ENGINE_CASES[case]}
    trace = _trace(pair, case)
    jres, jstats, _ = _serve(pair.jgen, trace, **knobs)
    tres, tstats, engine = _serve(pair.tgen(), trace, **knobs)
    assert tres == jres
    assert tstats.host_syncs == jstats.host_syncs
    assert tstats.mixed_steps == jstats.mixed_steps
    assert tstats.preemptions == jstats.preemptions
    if case == "preempting-pool":
        assert tstats.preemptions >= 1
    if case == "budget-below-prompt":
        assert tstats.mixed_steps >= 4
    # the run went through the static-buffer steps the card replays
    decode = "decode_chunk" if knobs["decode_chunk"] > 1 else "decode"
    assert sorted(engine._steps) == sorted(["mixed", decode])
    assert engine._steps["mixed"].key == (3, engine.token_budget, "greedy", None)
    assert engine.graph_stats()["captures"] == 0  # the CPU calls the bodies


def test_generate_steps_give_the_jax_tokens_and_stay_built(pair):
    """A tail chunk (14 tokens: the first from the prefill, then chunks of
    4, 4, 4 and a tail of 1), the same call again, then a batch
    compaction."""
    tg = pair.tgen()
    prompts = pair.prompts(3, (5, 2))
    want, _ = pair.jgen.generate(prompts, 14, temperature=0.0, chunk_size=4)
    got, stats = tg.generate(prompts, 14, temperature=0.0, chunk_size=4)
    assert got == want
    keys = sorted(tg._steps)
    assert [k[2] for k in keys] == [1, 4]  # the tail is its own key
    steps = dict(tg._steps)
    again, stats = tg.generate(prompts, 14, temperature=0.0, chunk_size=4)
    assert again == want and stats.captures == 0
    assert all(tg._steps[k] is steps[k] for k in keys) and len(tg._steps) == len(keys)

    many = [[i + 1, i + 2, i + 3] for i in range(8)]
    free = [tg.generate([p], 14, temperature=0.0, chunk_size=4)[0][0] for p in many]
    stops = [[free[j][3 + 2 * (j + 1)]] for j in range(4)]
    want, _ = pair.jgen.generate(many, 14, temperature=0.0, stop_sequences=stops, chunk_size=2)
    got, stats = tg.generate(many, 14, temperature=0.0, stop_sequences=stops, chunk_size=2)
    assert got == want and stats.compactions >= 1
    # one cache and one set of steps per lane count, all of one length
    assert {k[0] for k in tg._steps} == {1, 2, 4, 8} == {k[0] for k in tg._caches}
    assert len({k[1] for k in tg._caches}) == 1


def test_generate_keeps_one_cache_length(pythia):
    tg = pythia.tgen()
    tg.generate(pythia.prompts(1, (5,)), 4, temperature=0.0)
    short = {k[1] for k in tg._caches}
    tg.generate(pythia.prompts(2, (5,)), 260, temperature=0.0, chunk_size=64)
    longer = {k[1] for k in tg._caches}
    assert len(short) == len(longer) == 1 and short != longer
    assert {k[1] for k in tg._steps} == longer


@pytest.fixture
def no_host_reads(monkeypatch):
    """Patch every host copy and host read a step could make to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host copy or host read inside a step")

    def patch():
        monkeypatch.setattr(torch, "tensor", refuse)
        for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)

    return patch


@pytest.mark.parametrize("case", ["k4-buffered", "k1", "int8-k4-buffered", "sampled"])
def test_step_bodies_make_no_host_copy_or_read(pair, case, no_host_reads):
    knobs = {**BASE, **ENGINE_CASES.get(case, {})}
    sampling = dict(temperature=0.8, top_k=4) if case == "sampled" else dict(temperature=0.0)
    engine = pair.tgen().serve(**knobs, **{k: v for k, v in sampling.items()})
    tg = pair.tgen()
    tg.generate(pair.prompts(4, (6, 3)), 7, chunk_size=4, **sampling)
    steps = list(engine._steps.values()) + list(tg._steps.values())
    assert len(steps) == 4
    no_host_reads()
    for step in steps:
        step.call()


def _fake_graph_class(counters, fail=False):
    """A stand-in for `step_graph.CudaGraph` on the CPU.  `warm_up` runs
    the body and puts the generators back; `capture` records the body (it
    runs once more, drawing nothing, as a capture records without running)
    or raises; `replay` runs it with every counter in `counters` held
    still, as a replay runs no Python, and writes the results into the
    captured outputs in place."""

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
            counts = [getattr(o, a) for o, a in counters()]
            new = self.fn()
            for (o, a), v in zip(counters(), counts):
                setattr(o, a, v)
            outs = self.outputs if isinstance(self.outputs, tuple) else (self.outputs,)
            news = new if isinstance(new, tuple) else (new,)
            for o, n in zip(outs, news):
                o.copy_(n)

    return FakeGraph


@pytest.mark.parametrize("case", ["k4-buffered", "k1", "int8-k4-buffered", "sampled"])
def test_replays_count_as_the_eager_run(llama, case, monkeypatch):
    knobs = {**BASE, **ENGINE_CASES.get(case, {})}
    if case == "sampled":
        knobs.update(temperature=0.8, top_k=4)
    trace = _trace(llama, case)
    gen = llama.tgen()
    engines = []
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(
        lambda: step_graph.kernel_counters() + [(e, "forward_calls") for e in engines]))
    runs = {}
    for graphs in (False, True):
        for fn in (tpa._paged_prefill_plain, tpa._paged_attention_plain):
            fn.calls = 0
        engine = ServingEngine(gen, ServingConfig(**knobs), _graphs=graphs)
        engines[:] = [engine]
        built = engine.graph_stats()
        for rid, prompt, new in trace:
            engine.add_request(rid, prompt, new)
        results, stats = engine.run()
        counts = (engine.forward_calls, tpa._paged_prefill_plain.calls,
                  tpa._paged_attention_plain.calls)
        runs[graphs] = (results, stats.host_syncs, counts, built, engine.graph_stats())
    (eres, esyncs, ecounts, _, eafter), (gres, gsyncs, gcounts, gbuilt, gafter) = (
        runs[False], runs[True])
    assert gres == eres and gsyncs == esyncs
    assert gcounts == ecounts and ecounts[0] > 0
    assert eafter["captures"] == eafter["replays"] == 0
    # captured when built, none inside the run; every step replayed
    assert gbuilt["captures"] == gbuilt["steps"] == 2 == gafter["captures"]
    assert gafter["replays"] == sum(s.replays for s in engines[0]._steps.values()) > 0


def test_generate_replays_and_captures_once(llama, monkeypatch):
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(
        lambda: step_graph.kernel_counters()))
    prompts = llama.prompts(6, (4, 7))
    want, _ = llama.jgen.generate(prompts, 11, temperature=0.0, chunk_size=4)
    tg = llama.tgen(_graphs=True)
    got, stats = tg.generate(prompts, 11, temperature=0.0, chunk_size=4)
    assert got == want and stats.captures == 2  # chunks of 4 and the tail of 2
    got, stats = tg.generate(prompts, 11, temperature=0.0, chunk_size=4)
    assert got == want and stats.captures == 0
    assert tg.graph_stats()["replays"] == 6


def test_a_failed_capture_raises_and_never_runs_eagerly(llama, monkeypatch):
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(lambda: [], fail=True))
    with pytest.raises(RuntimeError, match="capture of step 'mixed' at key"):
        ServingEngine(llama.tgen(), ServingConfig(**BASE), _graphs=True)
    tg = llama.tgen(_graphs=True)
    counts = [getattr(o, a) for o, a in step_graph.kernel_counters()]
    with pytest.raises(RuntimeError, match="capture of step 'generate.decode_chunk' at key"):
        tg.generate(llama.prompts(6, (4,)), 6, temperature=0.0)
    assert tg.graph_stats()["replays"] == 0
    assert [getattr(o, a) for o, a in step_graph.kernel_counters()] == counts


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "stand-in-graphs"])
def test_a_dropped_owner_is_freed_at_once(llama, graphs, monkeypatch):
    """The steps hold their owner weakly: dropping an engine or a Generator
    frees it (its pool, caches and graph pools) without waiting for the
    cycle collector."""
    import gc
    import weakref

    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(lambda: []))
    gc.disable()
    try:
        gen = llama.tgen(_graphs=graphs)
        engine = ServingEngine(gen, ServingConfig(**BASE), _graphs=graphs)
        gen.generate(llama.prompts(6, (4,)), 6, temperature=0.0, chunk_size=4)
        assert gen._steps and engine._steps
        refs = weakref.ref(engine), weakref.ref(gen)
        del engine, gen
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_sampled_engine_draws_follow_the_jax_distribution(llama):
    """N requests of one prompt, 2 new tokens each, at temperature 0.8 and
    top_k 4: the first tokens (the mixed step's draws) and the second ones
    after each frequent first token (the decode chunk's draws) against the
    JAX package's filtered softmax, |freq - p| < 5 sigma + 1e-3."""
    temperature, top_k, n = 0.8, 4, 400
    prompt = llama.prompts(8, (6,))[0]
    trace = [(f"s{i}", prompt, 2) for i in range(n)]
    res, _, engine = _serve(llama.tgen(), trace, block_size=4, max_batch=8, decode_chunk=4,
                            temperature=temperature, top_k=top_k)
    assert engine._steps["decode_chunk"].key[-2:] == ("top_k", 4)
    draws = np.array([res[f"s{i}"][len(prompt):] for i in range(n)])
    t_op, p_op = jsampling.sampling_operands(temperature, None)

    def probs(ctx):
        logits = jtf.forward(llama.jc, llama.jp, jnp.asarray([ctx], jnp.int32),
                             jnp.zeros((1,), jnp.int32))[0]
        f = jsampling.filtered_logits(logits[0, -1:], t_op, p_op, mode="top_k", top_k=top_k)
        return np.asarray(jax.nn.softmax(f, axis=-1))[0].astype(np.float64)

    firsts, counts = np.unique(draws[:, 0], return_counts=True)
    cases = [(prompt, draws[:, 0])] + [
        (prompt + [int(t)], draws[draws[:, 0] == t, 1]) for t, c in zip(firsts, counts) if c >= 60
    ]
    assert len(cases) >= 3
    for ctx, got in cases:
        p = probs(ctx)
        freq = np.bincount(got, minlength=len(p)) / len(got)
        se = np.sqrt(p * (1.0 - p) / len(got))
        assert np.all(np.abs(freq - p) < 5.0 * se + 1e-3), (len(ctx), freq[p > 0], p[p > 0])
        assert np.all(freq[p == 0.0] == 0.0)
