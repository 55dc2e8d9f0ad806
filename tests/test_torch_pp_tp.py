"""The pipe x tp ring and pp x tp serving against the JAX package's, on the
CPU (the port: every stage's two tp ranks on the CPU; the JAX package: its
8 fake devices).

The ring (`PipelineEngine(mesh=pipeline_mesh(2, ["cpu"], tp=2))`, stages
[2, 3] of `tiny_config(block_size=128, n_layer=5)`) against the JAX ring on
`pipeline_mesh(2, devices[:4], tp=2)` and the JAX single-device
`Generator`, the cases of `tests/test_pipeline.py::test_pipeline_tp_*`:

- greedy streams of 2 prompts x 10 tokens, and M = 2 samples per slot over
  4 prompts x 8 tokens, identical to both, with the JAX ring's
  tokens_generated, rotations and token fills;
- int8 weights against the JAX single-device int8 Generator and the JAX
  int8 ring; w8a8 and int4 against the port's Generator in the same mode;
- each stage's rank trees are the Megatron slices of its blocks, each
  rank's cache holds G/tp groups, and the ring launches no kernel and
  takes no plain route.

Serving (`Generator(mesh=make_mesh({"tp": 2, "pp": 2}, ["cpu"])).serve`,
stages [1, 2] of `tiny_config(block_size=128)`) against the JAX composed
engine of `tests/test_pp_serving.py::test_tp_pp_composed_token_identical`
(its trace and knobs), the JAX single engine and the port's single
engine, through both attention routes (`use_kernel=None`, the plain
route, and `True`, K1's plain version on CPU tensors, counted: tp x
`stage_layer_runs` calls):

- greedy streams identical, with the single engine's step and sync
  counts; an int8 pool; chunked decode double-buffered or not; preemption
  recomputed or swapped through the host tier; prefix-cache hits;
- the pool is {stage: {rank: (L_s, NB, BS, G/tp, hs)}};
- one mixed step's hidden states and logits within 1e-5 of the port's
  single engine's, and its logits within 1e-4 of the JAX engine's mixed
  forward (`transformer.forward` with `paged_ragged`, the JAX engine's
  step) on the same packed batch over fresh pools.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import init_params
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.parallel.mesh import make_mesh as jmake_mesh
from mdi_llm_tpu.parallel.mesh import pipeline_mesh as jpipeline_mesh
from mdi_llm_tpu.parallel.pipeline import PipelineEngine as JPipeline
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa
from mdi_llm_tpu_torch.ops.rope import gather_rope
from mdi_llm_tpu_torch.parallel.mesh import make_mesh, pipeline_mesh
from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine
from mdi_llm_tpu_torch.parallel.sharding import shard_ranks
from mdi_llm_tpu_torch.serving.pipeline import PipelinedServingEngine
from mdi_llm_tpu_torch.utils import step_graph
from tests.test_model import tiny_config

torch.set_num_threads(1)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 18], [9, 9, 9, 9, 9, 9, 9], [6, 2]]
GREEDY = dict(temperature=0.0)
TP = 2


class Pair:
    """One tiny config in both packages on one set of float32 weights."""

    def __init__(self, **kw):
        self.jc = tiny_config(**kw)
        self.tc = TConfig(**self.jc.asdict())
        self.jp = init_params(self.jc, jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))

    def tgen(self, **kw):
        return Generator(self.tc, self.tp, cache_dtype=torch.float32, device="cpu", **kw)

    def jgen(self, **kw):
        return JGenerator(self.jc, self.jp, cache_dtype=jnp.float32, **kw)


# ---------------------------------------------------------------------------
# the pipe x tp ring
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_model():
    return Pair(block_size=128, n_layer=5)


def _jax_single(m, prompts, n, **kw):
    gen = m.jgen(**kw)
    return [gen.generate([p], n, **GREEDY)[0][0] for p in prompts]


def _ring(m, **kw):
    return PipelineEngine(m.tc, m.tp, mesh=pipeline_mesh(2, ["cpu"], tp=TP),
                          cache_dtype=torch.float32, **kw)


@pytest.mark.parametrize("prompts,n,M", [(PROMPTS[:2], 10, 1), (PROMPTS, 8, 2)],
                         ids=["matches_single_device", "samples_per_slot"])
def test_pipe_tp_ring_matches_jax(ring_model, devices, prompts, n, M):
    """`test_pipeline_tp_matches_single_device` and
    `test_pipeline_tp_samples_per_slot`: the JAX ring's streams and counts,
    and the JAX single device's streams."""
    m = ring_model
    jeng = JPipeline(m.jc, m.jp, mesh=jpipeline_mesh(2, devices[:4], tp=TP),
                     cache_dtype=jnp.float32, samples_per_slot=M)
    jout, jst = jeng.generate(prompts, n, **GREEDY)
    before = [getattr(o, a) for o, a in step_graph.kernel_counters()]
    eng = _ring(m, samples_per_slot=M)
    tout, tst = eng.generate(prompts, n, **GREEDY)
    assert tout == jout == _jax_single(m, prompts, n)
    assert tst.tokens_generated == n * len(prompts)
    assert (tst.tokens_generated, tst.rotations, tst.token_fills) == (
        jst.tokens_generated, jst.rotations, jst.token_fills)
    # as the JAX ring: none of the port's kernels, no plain route either
    assert [getattr(o, a) for o, a in step_graph.kernel_counters()] == before


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_pipe_tp_ring_quantized_parity(ring_model, devices, mode):
    """`test_pipeline_tp_quantized_parity`: int8 weights give the JAX
    single-device int8 Generator's streams and the JAX int8 ring's; w8a8
    and int4 (row-parallel scales regrouped per rank) the port's Generator
    in the same mode."""
    m = ring_model
    got, _ = _ring(m, quantize=mode).generate(PROMPTS[:2], 10, **GREEDY)
    want, _ = m.tgen(quantize=mode).generate(PROMPTS[:2], 10, **GREEDY)
    assert got == want
    if mode == "int8":
        jwant, _ = m.jgen(quantize="int8").generate(PROMPTS[:2], 10, **GREEDY)
        jring = JPipeline(m.jc, m.jp, mesh=jpipeline_mesh(2, devices[:4], tp=TP),
                          cache_dtype=jnp.float32, quantize="int8")
        assert got == jwant == jring.generate(PROMPTS[:2], 10, **GREEDY)[0]


def test_pipe_tp_ring_layout(ring_model):
    """Each stage's rank trees are the Megatron slices of its blocks (the
    fused qkv's rows and the proj's inputs split, norms whole), each rank
    caches G/tp groups, and a sampled run is reproducible from its seed."""
    m = ring_model
    eng = _ring(m)
    assert eng.tp == TP and eng.counts == [2, 3] and len(eng.stage_blocks[1]) == TP
    whole = m.tp["blocks"]
    for s, (lo, hi) in enumerate(((0, 2), (2, 5))):
        for r, rank in enumerate(eng.stage_blocks[s]):
            qkv = whole["attn"]["qkv"]["weight"][lo:hi]
            n = qkv.shape[1] // TP
            assert torch.equal(rank["attn"]["qkv"]["weight"], qkv[:, r * n:(r + 1) * n])
            proj = whole["attn"]["proj"]["weight"][lo:hi]
            k = proj.shape[2] // TP
            assert torch.equal(rank["attn"]["proj"]["weight"], proj[:, :, r * k:(r + 1) * k])
            assert torch.equal(rank["norm_1"]["weight"], whole["norm_1"]["weight"][lo:hi])
    eng.generate(PROMPTS[:2], 4, **GREEDY)
    caches = next(iter(eng._caches.values()))
    assert [c["k"].shape[:4] for c in caches[1]] == [
        (3, 3, 1, m.tc.n_query_groups // TP)] * TP
    kw = dict(temperature=0.8, top_k=20)
    a, _ = _ring(m, rng_seed=5).generate(PROMPTS, 8, **kw)
    b, _ = _ring(m, rng_seed=5).generate(PROMPTS, 8, **kw)
    assert a == b and all(len(o) == len(p) + 8 for o, p in zip(a, PROMPTS))


def test_pipe_tp_process_layouts(ring_model):
    """Over processes each holds whole tp groups of a contiguous group of
    stages (the pipeline axis first): process 1 of 2 runs stage 1's two
    ranks, from copies of its slices; a layout that splits a tp group over
    processes is refused, naming it."""
    from mdi_llm_tpu_torch.parallel.mesh import stage_ranks

    m = ring_model
    cpu = torch.device("cpu")
    assert stage_ranks(make_mesh({"pipe": 2, "tp": 2}, ["cpu"], 1, 2)) == {1: [cpu, cpu]}
    assert stage_ranks(make_mesh({"pp": 4, "tp": 2}, ["cpu"], 0, 2)) == {0: [cpu] * 2,
                                                                         1: [cpu] * 2}
    for axes, pid in (({"tp": 2, "pipe": 2}, 0), ({"pipe": 3, "tp": 2}, 1)):
        with pytest.raises(ValueError, match="whole tp groups of a contiguous group"):
            stage_ranks(make_mesh(axes, ["cpu"], pid, 2))
    ring = type("Ring", (), {"world": 2, "rank": 1, "device": cpu})()
    eng = PipelineEngine(m.tc, m.tp, n_stages=2, tp=TP, ring=ring, device="cpu",
                         cache_dtype=torch.float32)
    assert (eng.owned, eng.tp, eng.head_params, len(eng.stage_blocks[1])) == ([1], TP, None, TP)
    whole = m.tp["blocks"]["norm_1"]["weight"]
    assert eng.stage_blocks[1][0]["norm_1"]["weight"].data_ptr() != whole[2:].data_ptr()


# ---------------------------------------------------------------------------
# pp x tp serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_model():
    m = Pair(block_size=128)
    m.single = m.tgen()
    m.jsingle = m.jgen()
    m.pptp = m.tgen(mesh=make_mesh({"tp": TP, "pp": 2}, ["cpu"]))
    return m


def _prompts(m, lens, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, m.jc.vocab_size, int(n)).tolist() for n in lens]


def _serve(gen, prompts, max_news, **knobs):
    engine = gen.serve(**knobs)
    for i, (p, n) in enumerate(zip(prompts, max_news)):
        engine.add_request(f"r{i}", p, n)
    results, stats = engine.run()
    return results, stats, engine


def _cadence(stats):
    return (stats.mixed_steps, stats.decode_steps, stats.host_syncs,
            stats.requests_finished, stats.tokens_generated)


@pytest.fixture
def k1_plain_calls(monkeypatch):
    """Counts K1's plain version (what `ragged_paged_attention` runs on CPU
    tensors)."""
    count = [0]
    plain = rpa.ragged_paged_attention_plain

    def counted(*a, **k):
        count[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(rpa, "ragged_paged_attention_plain", counted)
    return count


ROUTES = [None, True]
ROUTE_IDS = ["plain", "k1plain"]
COMPOSED = dict(block_size=4, max_batch=3, prefill_chunk=16, token_budget=12, decode_chunk=4)


@pytest.fixture(scope="module")
def composed(serve_model, devices):
    """`test_tp_pp_composed_token_identical`'s trace through the JAX
    composed tp 2 x pp 2 engine, the JAX single engine and the port's
    single engine."""
    m = serve_model
    prompts, news = _prompts(m, (3, 9, 17)), [6, 8, 5]
    jgen = m.jgen(mesh=jmake_mesh({"tp": TP, "pp": 2}, devices[:4]))
    jres, _, _ = _serve(jgen, prompts, news, **COMPOSED)
    jsingle, _, _ = _serve(m.jsingle, prompts, news, **COMPOSED)
    want, wstats, _ = _serve(m.single, prompts, news, **COMPOSED)
    return prompts, news, jres, jsingle, want, wstats


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_pp_tp_serving_matches_jax_composed_and_single(serve_model, composed, route,
                                                       k1_plain_calls):
    """`test_tp_pp_composed_token_identical`'s trace and knobs: the JAX
    composed tp 2 x pp 2 engine's streams, the JAX single engine's and the
    port's single engine's, with its step and sync counts; on K1's route
    every (stage layer, rank) is one K1 call."""
    m = serve_model
    prompts, news, jres, jsingle, want, wstats = composed
    k1_plain_calls[0] = 0
    got, stats, engine = _serve(m.pptp, prompts, news, use_kernel=route, **COMPOSED)
    assert isinstance(engine, PipelinedServingEngine) and engine._stage_counts == [1, 2]
    assert got == jres == jsingle == want
    assert _cadence(stats) == _cadence(wstats) and engine.pool.used == 0
    assert engine.stage_layer_runs > 0
    assert k1_plain_calls[0] == (TP * engine.stage_layer_runs if route else 0)
    shapes = {(s, r): tuple(engine._kv[s][r]["k"].shape) for s in (0, 1) for r in (0, 1)}
    NB = engine.pool.num_blocks
    G, hs = m.tc.n_query_groups // TP, m.tc.head_size
    assert shapes == {(s, r): (L, NB, 4, G, hs) for s, L in enumerate((1, 2)) for r in (0, 1)}


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("knobs", [
    dict(kv_dtype="int8", decode_chunk=4),
    dict(decode_chunk=8, double_buffer=False),
    dict(max_blocks=11, prefix_caching=False, decode_chunk=4),
    dict(max_blocks=11, prefix_caching=False, decode_chunk=4, host_pool_mib=64,
         host_link_gbps=1000.0),
], ids=["int8-pool", "k8-nobuf", "preempt-recompute", "preempt-host-tier"])
def test_pp_tp_serving_knobs_match_the_single_engine(serve_model, route, knobs):
    """An int8 pool (each rank's scales over its groups), unbuffered
    chunked decode, and a pool sized to preempt, recomputing or swapping
    every (stage, rank) pool's blocks through the host tier: the single
    engine's streams, counts and swaps."""
    m = serve_model
    prompts, news = _prompts(m, (9, 13, 11), seed=9), [10, 10, 10]
    base = dict(block_size=4, max_batch=3, prefill_chunk=8, **knobs)
    want, wstats, single = _serve(m.single, prompts, news, **base)
    got, stats, engine = _serve(m.pptp, prompts, news, use_kernel=route, **base)
    assert got == want
    assert _cadence(stats) == _cadence(wstats)
    assert (stats.preemptions, stats.swaps_out, stats.swaps_in, stats.swap_out_bytes) == (
        wstats.preemptions, wstats.swaps_out, wstats.swaps_in, wstats.swap_out_bytes)
    if "max_blocks" in knobs:
        assert stats.preemptions >= 1
    if "host_pool_mib" in knobs:
        assert stats.swaps_out >= 1 and engine.host_tier.store.used == 0
    assert {x.dtype for x in ttf.tree_leaves(engine._kv)} == \
        {x.dtype for x in ttf.tree_leaves(single._kv)}
    assert engine.pool.used == 0


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_pp_tp_prefix_cache_hits(serve_model, route):
    """One block id indexes every (stage, rank) pool: a prefix hit reuses
    them all, and the tail's stream is the JAX `generate`'s."""
    m = serve_model
    head = _prompts(m, (21,), seed=7)[0]
    engine = m.pptp.serve(block_size=4, max_batch=2, use_kernel=route)
    engine.add_request("first", head, 6)
    engine.run()
    tail = head + [7, 8]
    engine.add_request("second", tail, 6)
    results, stats = engine.run()
    assert stats.prefix_cache_hits >= 5
    assert results["second"] == m.jsingle.generate([tail], 6, **GREEDY)[0][0]


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_pp_tp_mixed_step_hidden_and_logits(serve_model, route):
    """One mixed step's packed batch (two prefill chunks, one straddling the
    ring's segments, a decode lane, an absent slot, a padded tail) through
    the pp x tp ring on fresh pools: hidden states and logits within 1e-5
    of the port's single engine's forward on every owned row, and logits
    within 1e-4 of the JAX engine's mixed forward."""
    m = serve_model
    knobs = dict(block_size=4, max_batch=4, token_budget=20, use_kernel=route)
    single = m.single.serve(**knobs)
    engine = m.pptp.serve(**knobs)
    B, T, MB = 4, 20, engine.max_blocks_per_seq
    spans = {0: (0, 7), 2: (7, 1), 3: (8, 9)}  # slot: (q_start, q_len); slot 1 absent
    tokens = torch.zeros(1, T, dtype=torch.int32)
    pos = torch.full((1, T), MB * 4, dtype=torch.int32)
    q_slot = torch.zeros(T, dtype=torch.int32)
    q_start = torch.zeros(B, dtype=torch.int32)
    q_len = torch.zeros(B, dtype=torch.int32)
    tables = torch.zeros(B, MB, dtype=torch.int32)
    rng = np.random.default_rng(3)
    depth = {0: 0, 2: 11, 3: 0}
    for i, (slot, (st, n)) in enumerate(spans.items()):
        tokens[0, st:st + n] = torch.from_numpy(rng.integers(1, 128, n).astype(np.int32))
        pos[0, st:st + n] = torch.arange(depth[slot], depth[slot] + n)
        q_slot[st:st + n] = slot
        q_start[slot], q_len[slot] = st, n
        tables[slot, :8] = torch.arange(1 + 8 * i, 9 + 8 * i)
    ragged = (q_slot, q_start, q_len)
    hidden = engine._ring(tokens, pos, tables, ragged)
    logits = engine._forward(tokens, pos, tables, ragged)
    want = single._forward(tokens, pos, tables, ragged)
    p = m.tp
    x = ttf.embed(m.tc, p, tokens, pos.long())
    cos, sin = gather_rope(*ttf.get_rope_cache(m.tc), pos.long())
    ref_kv = ttf.init_paged_kv_cache(m.tc, engine.pool.num_blocks, 4, dtype=torch.float32)
    want_hidden = ttf.run_blocks(m.tc, p["blocks"], x, pos.long(), cos, sin, ref_kv,
                                 paged_tables=tables, paged_kernel=route, paged_ragged=ragged)
    owned = int(q_len.sum())
    assert owned == 17
    assert torch.allclose(hidden[:, :owned], want_hidden[:, :owned], atol=1e-5, rtol=0)
    assert torch.allclose(logits[:, :owned], want[:, :owned], atol=1e-5, rtol=0)
    jkv = jtf.init_paged_kv_cache(m.jc, engine.pool.num_blocks, 4, dtype=jnp.float32)
    jlogits, _ = jtf.forward(
        m.jc, m.jp, jnp.asarray(tokens.numpy()), jnp.asarray(pos.numpy()), kv=jkv,
        paged_tables=jnp.asarray(tables.numpy()),
        paged_ragged=tuple(jnp.asarray(a.numpy()) for a in ragged))
    np.testing.assert_allclose(logits[0, :owned].numpy(), np.asarray(jlogits)[0, :owned],
                               atol=1e-4, rtol=0)


def test_pp_tp_pool_and_rank_layout(serve_model):
    """The staged pool is {stage: {rank: ...}} on the stages' ranks, the
    blocks of each stage are `shard_ranks`' slices, and `pipeline_fill`
    and the stats line's chip count see two stages of two ranks."""
    m = serve_model
    engine = m.pptp.serve(block_size=4, max_batch=3, kv_dtype="int8")
    assert sorted(engine._kv) == [0, 1] and all(sorted(engine._kv[s]) == [0, 1] for s in (0, 1))
    assert engine._kv[1][1]["k"]["scale"].shape == (2, engine.pool.num_blocks,
                                                    m.tc.n_query_groups // TP)
    assert engine.pipeline_fill()["stage_layers"] == [1, 2] and engine.devices == 1
    assert m.pptp.tp == TP and engine.gen.stage_ranks[1] == [torch.device("cpu")] * TP
    stage1 = {"blocks": ttf.slice_blocks(m.tp["blocks"], 1, 3)}
    for r, want in enumerate(shard_ranks(m.tc, stage1, ["cpu"] * TP)):
        got = engine._stage_tp[1].ranks[r]
        for a, b in zip(ttf.tree_leaves(got), ttf.tree_leaves(want)):
            assert torch.equal(a, b)
