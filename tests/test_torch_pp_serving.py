"""The port's pipeline-parallel serving engine (`serving/pipeline.py`)
against the green references, on the CPU.

The JAX ring is not the reference: `tests/test_pp_serving.py` fails on
jax builds without `jax.shard_map`, which its ring needs.  So the port
is held against the JAX single-device `ServingEngine` and
`Generator.generate`, and against the port's own single engine, on the
same float32 weights (JAX `init_params`, moved over by
`params_from_numpy`) of `tiny_config(block_size=128)`, 3 layers:

- every case runs at S = 2 (split [1, 2]) and S = 3 ([1, 1, 1]), all stages
  on the CPU, through both attention routes: `use_kernel=None` (the plain
  route) and `use_kernel=True`, which on CPU tensors is K1's plain version
  (`ragged_paged_attention_plain`), whose span ownership a segment of the
  packed batch must respect;
- greedy streams are identical, and the host-sync cadence (mixed steps,
  decode steps, host_syncs) equals the single engine's: the acceptance
  trace of the JAX pp test, chunked decode (k4 buffered, k8 unbuffered),
  n-gram speculation, recompute and host-tier preemption, prefix-cache
  hits, int8 and e4m3 pools; sampled draws at decode_chunk 1 equal the
  single engine's draw for draw;
- the hidden states and logits of one mixed step agree with the single
  engine's forward within 1e-5;
- segments of a random packed ragged batch with rebased spans
  (`segment_spans`) give K1's plain version the whole batch's owned rows;
- the refusals (a draft model, fewer layers than stages), a pipe x tp
  mesh served (the JAX composed engine's cases are
  `tests/test_torch_pp_tp.py`'s), the
  routing of a one-stage mesh, `pipeline_fill` against the JAX engine's
  formula, each stage's pool bytes;
- the steps' capture plumbing through the stand-in graph of
  `test_torch_graphs.py` (a second trace builds and captures nothing, the
  counters equal the eager run's), and no step body reads the host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import init_params
from mdi_llm_tpu.serving.pipeline import PipelinedServingEngine as JPipelined
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.config import ServingConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention_plain
from mdi_llm_tpu_torch.ops.rope import gather_rope
from mdi_llm_tpu_torch.parallel.mesh import make_mesh, pipeline_mesh
from mdi_llm_tpu_torch.serving.engine import ServingEngine, pool_bytes
from mdi_llm_tpu_torch.serving.pipeline import PipelinedServingEngine, segment_spans
from mdi_llm_tpu_torch.utils import step_graph
from tests.test_model import tiny_config
from tests.test_torch_graphs import _fake_graph_class, no_host_reads  # noqa: F401

torch.set_num_threads(1)

STAGES = {2: [1, 2], 3: [1, 1, 1]}
ROUTES = [(S, route) for S in STAGES for route in (None, True)]
ROUTE_IDS = [f"S{S}-{'k1plain' if r else 'plain'}" for S, r in ROUTES]


class Model:
    """tiny_config(block_size=128) in both packages on one set of float32
    weights; the single-device Generators and one pp Generator per S."""

    def __init__(self):
        self.jc = tiny_config(block_size=128)
        self.tc = TConfig(**self.jc.asdict())
        self.jp = init_params(self.jc, jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))
        self.jgen = JGenerator(self.jc, self.jp, cache_dtype=jnp.float32)
        self.tgen = self.gen()
        self.pp = {S: self.gen(mesh=pipeline_mesh(S, ["cpu"])) for S in STAGES}

    def gen(self, **kw):
        return Generator(self.tc, self.tp, cache_dtype=torch.float32, device="cpu", **kw)

    def prompts(self, lens, seed=5):
        rng = np.random.default_rng(seed)
        return [rng.integers(1, self.tc.vocab_size, int(n)).tolist() for n in lens]


@pytest.fixture(scope="module")
def model():
    return Model()


def _serve(gen, prompts, max_news, **knobs):
    engine = gen.serve(**knobs)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        engine.add_request(f"r{i}", p, m)
    results, stats = engine.run()
    return results, stats, engine


def _pp(model, S, route, prompts, max_news, **knobs):
    results, stats, engine = _serve(model.pp[S], prompts, max_news, use_kernel=route, **knobs)
    assert isinstance(engine, PipelinedServingEngine)
    assert engine._stage_counts == STAGES[S]
    return results, stats, engine


def _cadence(stats):
    return (stats.mixed_steps, stats.decode_steps, stats.host_syncs,
            stats.requests_finished, stats.tokens_generated)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

ACCEPT_KNOBS = dict(block_size=4, max_batch=3, prefill_chunk=16, token_budget=12)
ACCEPT_NEWS = [8, 12, 6, 10, 7]


@pytest.fixture(scope="module")
def acceptance(model):
    """The JAX pp test's acceptance trace through the JAX single engine,
    the JAX `generate` (one prompt at a time) and the port's single
    engine."""
    prompts = model.prompts((3, 9, 17, 5, 33))
    jres, _, _ = _serve(model.jgen, prompts, ACCEPT_NEWS, **ACCEPT_KNOBS)
    jgen = [model.jgen.generate([p], m, temperature=0.0)[0][0]
            for p, m in zip(prompts, ACCEPT_NEWS)]
    tres, tstats, _ = _serve(model.tgen, prompts, ACCEPT_NEWS, **ACCEPT_KNOBS)
    return prompts, jres, jgen, tres, tstats


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
def test_pp_engine_matches_single_engines_and_generate(model, acceptance, S, route):
    """The acceptance trace (its 33-token prompt splits over several mixed
    steps): streams equal the JAX single engine's, the JAX `generate`'s
    and the port's single engine's; the same step and sync counts."""
    prompts, jres, jgen, tres, tstats = acceptance
    got, stats, engine = _pp(model, S, route, prompts, ACCEPT_NEWS, **ACCEPT_KNOBS)
    assert got == jres == tres
    assert [got[f"r{i}"] for i in range(len(prompts))] == jgen
    assert _cadence(stats) == _cadence(tstats)
    assert stats.mixed_steps > 3 and stats.requests_finished == len(prompts)
    assert engine.pool.used == 0
    # every stage's layers in every tick, the fill and drain bubbles
    # included (the K1 launch count the card holds): 2S - 1 ticks per
    # mixed step, K·S + S per decode chunk of K forwards
    K = engine.cfg.decode_chunk
    chunks, rest = divmod(engine.forward_calls - stats.mixed_steps, K)
    assert rest == 0 and chunks > 0
    assert engine.stage_layer_runs == 3 * ((2 * S - 1) * stats.mixed_steps
                                           + (K * S + S) * chunks)


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("chunk,buffered", [(4, True), (8, False)],
                         ids=["k4-buffered", "k8-nobuf"])
def test_pp_chunked_decode_token_identical(model, S, route, chunk, buffered):
    """The recurrent ring proper: K decode steps circle the stages in one
    body, double-buffered or not; the JAX single engine's streams and the
    port's single engine's, with its host syncs."""
    prompts = model.prompts((3, 9, 17))
    news = [8, 12, 6]
    knobs = dict(block_size=4, max_batch=3, prefill_chunk=8, decode_chunk=chunk,
                 double_buffer=buffered)
    jres, _, _ = _serve(model.jgen, prompts, news, **knobs)
    want, wstats, _ = _serve(model.tgen, prompts, news, **knobs)
    got, stats, engine = _pp(model, S, route, prompts, news, **knobs)
    assert got == want == jres
    assert _cadence(stats) == _cadence(wstats)
    assert stats.tokens_per_sync > 1.0
    assert engine.pool.used == 0


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
def test_pp_speculative_serving_token_identical(model, S, route):
    """The batched n-gram verify rides the grouped sweep: exact, and the
    drafts still accept."""
    cyc = [np.random.default_rng(s).integers(1, model.tc.vocab_size, 5).tolist()
           for s in (5, 7, 0)]
    news = [30, 25, 20]
    knobs = dict(block_size=4, max_batch=3, decode_chunk=4, spec_k=4)
    want, wstats, _ = _serve(model.tgen, cyc, news, **knobs)
    got, stats, _ = _pp(model, S, route, cyc, news, **knobs)
    assert got == want
    assert stats.spec_drafted == wstats.spec_drafted > 0
    assert stats.spec_accepted == wstats.spec_accepted > 0
    assert _cadence(stats) == _cadence(wstats)


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("tier", [0, 64], ids=["recompute", "host-tier"])
def test_pp_preemption_resume_parity(model, S, route, tier):
    """A pool sized to preempt: victims recompute through the staged mixed
    step, or swap every stage's blocks to the host tier and back; streams
    exact, every stage's pool drained."""
    prompts = model.prompts((9, 13, 11), seed=9)
    news = [10, 10, 10]
    knobs = dict(block_size=4, max_batch=3, max_blocks=1 + 10, prefix_caching=False,
                 decode_chunk=4, host_pool_mib=tier, host_link_gbps=1000.0)
    want, wstats, _ = _serve(model.tgen, prompts, news, **knobs)
    got, stats, engine = _pp(model, S, route, prompts, news, **knobs)
    assert stats.preemptions == wstats.preemptions >= 1
    assert got == want
    if tier:
        assert stats.swaps_out == stats.swaps_in == wstats.swaps_out >= 1
        assert stats.swap_out_bytes == wstats.swap_out_bytes > 0
        assert engine.host_tier.store.used == 0
    assert engine.pool.used == 0


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
def test_pp_prefix_cache_hits_parity(model, S, route):
    """A block id indexes every stage's pool at once, so a prefix hit
    reuses every stage's K/V: the hits fire and the tail's stream is the
    sequential `generate`'s."""
    head = model.prompts((21,), seed=7)[0]
    engine = model.pp[S].serve(block_size=4, max_batch=2, use_kernel=route)
    engine.add_request("first", head, 6)
    engine.run()
    tail = head + [7, 8]
    engine.add_request("second", tail, 6)
    results, stats = engine.run()
    assert stats.prefix_cache_hits >= 5  # 21-token head -> 5 full blocks
    assert results["second"] == model.jgen.generate([tail], 6, temperature=0.0)[0][0]


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("kv_dtype", ["int8", "float8"])
def test_pp_narrow_pools_match_the_single_engine(model, S, route, kv_dtype):
    """Over an int8 pool (quantized on write) and an e4m3 pool, the staged
    pools give the single engine's streams over the same pool dtype."""
    prompts = model.prompts((3, 9, 17, 5))
    news = [8, 12, 6, 10]
    knobs = dict(block_size=4, max_batch=3, prefill_chunk=8, decode_chunk=4,
                 kv_dtype=kv_dtype)
    want, wstats, single = _serve(model.tgen, prompts, news, **knobs)
    got, stats, engine = _pp(model, S, route, prompts, news, **knobs)
    assert got == want
    assert _cadence(stats) == _cadence(wstats)
    assert engine.kv_dtype_name == single.kv_dtype_name
    assert {x.dtype for x in ttf.tree_leaves(engine._kv)} == \
        {x.dtype for x in ttf.tree_leaves(single._kv)}


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
def test_pp_sampled_draws_equal_the_single_engine(model, S, route):
    """At decode_chunk 1 the mixed and decode steps sample once at (B, V)
    from the engine's generator, as the single engine does: temperature
    0.8, top_k 4, the same tokens draw for draw."""
    prompts = model.prompts((3, 9, 17, 5))
    news = [8, 12, 6, 10]
    knobs = dict(block_size=4, max_batch=3, prefill_chunk=8, decode_chunk=1,
                 temperature=0.8, top_k=4)
    want, wstats, _ = _serve(model.tgen, prompts, news, **knobs)
    got, stats, _ = _pp(model, S, route, prompts, news, **knobs)
    assert got == want
    assert _cadence(stats) == _cadence(wstats)
    greedy, _, _ = _serve(model.tgen, prompts, news, **{**knobs, "temperature": 0.0})
    assert got != greedy  # the draws are draws


@pytest.mark.parametrize("S,route", ROUTES, ids=ROUTE_IDS)
def test_pp_mixed_step_hidden_and_logits_match(model, S, route):
    """One mixed step's packed batch (two prefill chunks, one of them
    straddling segments, a decode lane, an absent slot and a padded tail)
    through the ring and through the single engine's forward on fresh
    pools: hidden states and logits within 1e-5 on every packed row the
    batch owns."""
    knobs = dict(block_size=4, max_batch=4, token_budget=20, use_kernel=route)
    single = model.tgen.serve(**knobs)
    engine = model.pp[S].serve(**knobs)
    B, T, MB = 4, 20, engine.max_blocks_per_seq
    trash = MB * 4
    spans = {0: (0, 7), 2: (7, 1), 3: (8, 9)}  # slot: (q_start, q_len); slot 1 absent
    tokens = torch.zeros(1, T, dtype=torch.int32)
    pos = torch.full((1, T), trash, dtype=torch.int32)
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
    p = model.tp
    x = ttf.embed(model.tc, p, tokens, pos.long())
    cos, sin = gather_rope(*ttf.get_rope_cache(model.tc), pos.long())
    ref_kv = ttf.init_paged_kv_cache(model.tc, engine.pool.num_blocks, 4, dtype=torch.float32)
    want_hidden = ttf.run_blocks(model.tc, p["blocks"], x, pos.long(), cos, sin, ref_kv,
                                 paged_tables=tables, paged_kernel=route, paged_ragged=ragged)
    owned = q_len.sum().item()  # the spans are packed from 0
    assert owned == 17
    assert torch.allclose(hidden[:, :owned], want_hidden[:, :owned], atol=1e-5, rtol=0)
    assert torch.allclose(logits[:, :owned], want[:, :owned], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# rebased spans
# ---------------------------------------------------------------------------


def _ragged_case(seed, T=37, BS=4, MB=16, H=4, G=2, hs=8):
    """A random packed ragged batch: slot-major spans (one absent, one
    prefill chunk longer than a segment), a padded tail, random pools and
    tables; positions continue each slot's depth."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.permutation([6, 0, 15, 1, 9])]  # 31 of T tokens
    q_start, q_len, q_pos = [], [], torch.full((T,), MB * BS, dtype=torch.int32)
    q_slot = torch.zeros(T, dtype=torch.int32)
    off = 0
    for s, n in enumerate(lens):
        depth = int(rng.integers(0, MB * BS - n))
        q_start.append(off)
        q_len.append(n)
        q_pos[off:off + n] = torch.arange(depth, depth + n)
        q_slot[off:off + n] = s
        off += n
    n_slots = len(lens)
    NB = n_slots * MB + 1
    k = torch.randn(NB, BS, G, hs, generator=g)
    v = torch.randn(NB, BS, G, hs, generator=g)
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[: n_slots * MB]
                              .reshape(n_slots, MB).astype(np.int32))
    q = torch.randn(1, H, T, hs, generator=g)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    return q, k, v, tables, i32(q_start), i32(q_len), q_pos, q_slot


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segments_with_rebased_spans_give_the_whole_batchs_rows(S, seed):
    """Cut the packed batch into S segments of ceil(T/S) tokens with the
    spans of `segment_spans`: K1's plain version on each segment gives the
    whole-batch call's rows where a slot owns them, and zeros elsewhere."""
    q, k, v, tables, q_start, q_len, q_pos, _ = _ragged_case(seed)
    T = q.shape[2]
    seg = -(-T // S)
    lens = q_pos[q_start.long().clamp(max=T - 1)] + q_len
    whole = ragged_paged_attention_plain(q, k, v, tables, q_start, q_len, lens, q_pos,
                                         scale=0.3)
    pad = seg * S - T
    qp = torch.nn.functional.pad(q, (0, 0, 0, pad))
    pp = torch.nn.functional.pad(q_pos, (0, pad), value=int(q_pos.max()))
    starts, counts = segment_spans(q_start, q_len, S, seg)
    assert int(counts.sum()) == int(q_len.sum())
    assert any(int((counts[:, s] > 0).sum()) > 1 for s in range(len(q_len)))  # a straddler
    parts = []
    for m in range(S):
        qm, pm = qp[:, :, m * seg:(m + 1) * seg], pp[m * seg:(m + 1) * seg]
        lm = pm[starts[m].long().clamp(max=seg - 1)] + counts[m]
        for s, (st, n) in enumerate(zip(starts[m].tolist(), counts[m].tolist())):
            # K1's key bound: every owned token keeps q_pos < lens
            assert all(int(pm[t]) < int(lm[s]) for t in range(st, st + n))
        parts.append(ragged_paged_attention_plain(qm, k, v, tables, starts[m], counts[m], lm,
                                                  pm, scale=0.3))
    got = torch.cat(parts, dim=2)[:, :, :T]
    assert torch.equal(got, whole)
    owned = torch.zeros(T, dtype=torch.bool)
    for st, n in zip(q_start.tolist(), q_len.tolist()):
        owned[st:st + n] = True
    assert bool((got[:, :, ~owned] == 0).all()) and bool((got[:, :, owned] != 0).any())
    # without the rebase a later segment's rows are owned by no span
    wrong = ragged_paged_attention_plain(qp[:, :, seg:2 * seg], k, v, tables, q_start, q_len,
                                         lens, pp[seg:2 * seg], scale=0.3)
    assert not torch.equal(wrong, parts[1])


# ---------------------------------------------------------------------------
# refusals, routing and topology
# ---------------------------------------------------------------------------


def test_pp_refuses_a_draft_model(model):
    with pytest.raises(ValueError, match="draft pool has no per-stage ring"):
        model.pp[2].serve(spec_k=2, draft_model="pythia-14m")
    with pytest.raises(ValueError, match="draft pool has no per-stage ring"):
        model.pp[2].serve(spec_k=2, draft_model="pythia-14m", draft_gen=model.tgen)


@pytest.mark.parametrize("mesh", [{"pp": 2, "tp": 2}, {"pipe": 2, "tp": 2}],
                         ids=["pp-tp", "tp"])
def test_tp_meshes_are_refused_naming_item_14(model, mesh):
    """Once refused (item 14's second half), now served: a `make_mesh`
    Mesh with a pipeline axis ("pp" or "pipe") beside tp builds the staged
    engine over two ranks per stage, whose streams are the single
    engine's (the cases against the JAX composed engine are
    tests/test_torch_pp_tp.py's)."""
    gen = model.gen(mesh=make_mesh(mesh, ["cpu"]))
    assert gen.tp == 2 and gen.stage_ranks == {s: [torch.device("cpu")] * 2 for s in (0, 1)}
    prompts = model.prompts((3, 9, 17))
    knobs = dict(block_size=4, max_batch=3, prefill_chunk=8, decode_chunk=4)
    got, _, engine = _serve(gen, prompts, [6, 8, 5], **knobs)
    assert isinstance(engine, PipelinedServingEngine) and sorted(engine._kv[1]) == [0, 1]
    assert got == _serve(model.tgen, prompts, [6, 8, 5], **knobs)[0]
    assert pipeline_mesh(2, ["cpu"], tp=2).shape == {"pipe": 2, "tp": 2}


def test_fewer_layers_than_stages_is_refused(model):
    gen = model.gen(mesh=pipeline_mesh(4, ["cpu"]))
    with pytest.raises(ValueError, match="cannot split 3 layers over 4"):
        gen.serve(block_size=4, max_batch=4)


def test_one_stage_mesh_serves_on_the_plain_engine(model):
    gen = model.gen(mesh=pipeline_mesh(1, ["cpu"]))
    engine = gen.serve(block_size=4, max_batch=2)
    assert type(engine) is ServingEngine
    prompts = model.prompts((5, 9))
    assert _serve(gen, prompts, [6, 6], block_size=4, max_batch=2)[0] == \
        _serve(model.tgen, prompts, [6, 6], block_size=4, max_batch=2)[0]


def test_generator_on_a_pipeline_mesh_runs_on_stage_0(model):
    gen = model.pp[2]
    assert gen.device == torch.device("cpu") and set(gen.mesh) == {0, 1}
    prompts = model.prompts((4, 7))
    assert gen.generate(prompts, 6, temperature=0.0)[0] == \
        model.tgen.generate(prompts, 6, temperature=0.0)[0]
    with pytest.raises(ValueError, match="stage 0's device"):
        Generator(model.tc, model.tp, mesh={0: "cpu", 1: "cpu"}, device="meta")


@pytest.mark.parametrize("S,max_batch", [(2, 3), (3, 3), (3, 2), (2, 1)])
def test_pipeline_fill_is_the_jax_engines(model, S, max_batch):
    """`pipeline_fill()` against the JAX engine's method run on the same
    fields (its ring cannot be built here), a lane shortage included."""
    engine = model.pp[S].serve(block_size=4, max_batch=max_batch,
                               token_budget=max_batch + 8)
    stub = type("Stub", (), {})()
    stub.scheduler = engine.scheduler
    stub._pp, stub._stage_counts = S, engine._stage_counts
    fill = engine.pipeline_fill()
    assert fill == JPipelined.pipeline_fill(stub)
    assert engine.n_stages == S and engine.devices == 1
    assert (fill["bubble_fraction"] > 0) == (max_batch < S)


@pytest.mark.parametrize("S", list(STAGES))
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_each_stage_pool_holds_its_own_layers(model, S, kv_dtype):
    single = model.tgen.serve(block_size=4, max_batch=3, kv_dtype=kv_dtype)
    engine = model.pp[S].serve(block_size=4, max_batch=3, kv_dtype=kv_dtype)
    assert sorted(engine._kv) == list(range(S))
    for s, L in enumerate(STAGES[S]):
        assert pool_bytes(engine._kv[s]) * 3 == pool_bytes(single._kv) * L
        assert all(x.shape[:2] == (L, engine.pool.num_blocks)
                   for x in ttf.tree_leaves(engine._kv[s]))
    assert pool_bytes(engine._kv) == pool_bytes(single._kv)


def test_serving_config_fields_reach_the_pp_engine(model):
    sv = ServingConfig(block_size=4, max_batch=3, decode_chunk=4)
    engine = model.pp[2].serve(sv)
    assert dataclasses.asdict(engine.cfg) == dataclasses.asdict(sv)
    assert sorted(engine._steps) == ["decode_chunk", "mixed"]


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [dict(decode_chunk=4, double_buffer=True),
                                   dict(decode_chunk=1, temperature=0.8, top_k=4)],
                         ids=["k4-buffered", "k1-sampled"])
def test_pp_steps_capture_once_and_replay_as_the_eager_run(model, knobs, monkeypatch):
    """Through the stand-in graph (a replay runs the captured body with
    every counter held still): the steps are captured when the engine is
    built, a second trace on the same engine builds and captures nothing,
    and streams, host syncs and every counter equal the eager run's."""
    engines = []
    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(
        lambda: step_graph.kernel_counters()
        + [(e, a) for e in engines for a in ("forward_calls", "stage_layer_runs")]))
    traces = [model.prompts((3, 9, 17)), model.prompts((6, 4, 12), seed=8)]
    news = [8, 12, 6]
    runs = {}
    for graphs in (False, True):
        engine = PipelinedServingEngine(model.pp[2], ServingConfig(
            block_size=4, max_batch=3, prefill_chunk=8, **knobs), _graphs=graphs)
        engines[:] = [engine]
        built = engine.graph_stats()
        outs = []
        for i, prompts in enumerate(traces):
            for j, (p, m) in enumerate(zip(prompts, news)):
                engine.add_request(f"t{i}r{j}", p, m)
            res, stats = engine.run()
            outs.append((res, stats.host_syncs, engine.graph_stats()["captures"]))
        runs[graphs] = (outs, engine.forward_calls, engine.stage_layer_runs, built,
                        engine.graph_stats())
    eager, graph = runs[False], runs[True]
    assert [o[:2] for o in graph[0]] == [o[:2] for o in eager[0]]
    assert graph[1:3] == eager[1:3] and eager[2] > 0
    assert graph[3]["captures"] == graph[3]["steps"] == 2
    assert [o[2] for o in graph[0]] == [2, 2]  # nothing captured after the build
    assert graph[4]["replays"] > 0 and eager[4]["captures"] == eager[4]["replays"] == 0


@pytest.mark.parametrize("knobs", [dict(decode_chunk=4), dict(decode_chunk=1),
                                   dict(decode_chunk=4, kv_dtype="int8", temperature=0.8)],
                         ids=["k4", "k1", "int8-k4-sampled"])
def test_pp_step_bodies_make_no_host_copy_or_read(model, knobs, no_host_reads):  # noqa: F811
    engine = model.pp[3].serve(block_size=4, max_batch=3, **knobs)
    no_host_reads()
    for step in engine._steps.values():
        step.call()
