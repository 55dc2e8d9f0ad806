"""The port's recurrent pipeline against the JAX package's, on the CPU.

Every case of `tests/test_pipeline.py` runs through three engines on the
same float32 weights (JAX `init_params`, moved over by
`params_from_numpy`): the JAX `PipelineEngine` on the 8 fake CPU devices,
the port's `PipelineEngine` on the CPU (one process, every stage on the
CPU) and the port's `Generator.generate`, one prompt at a time.  Greedy
streams must be identical across the three, and the port's
`tokens_generated`, `rotations`, `token_fills` and the token column of
`tok_time` equal to the JAX engine's:

- 1, 2 and 4 stages; waves (more samples than stages); a partial wave;
  stop sequences; `stream_cb` with and without them;
- `samples_per_slot` 2 over 4 and 3 samples, and waves of slots;
- the continuous scheduler: refills that beat wave scheduling, batch
  refills of long prompts, token fills of partially busy slots;
- GQA, GPT-2 (learned positions, tied head) and MoE configs; both
  orderings of `overlap_chunks`;
- a bubble lane whose position passes the cache (the overlapped chunk's
  surplus rotations), clamped, with the streams unchanged.

Beside those: the quantized modes (int8, w8a8, int4) against the port's
`Generator` with the same `quantize`; a sampled run reproducible from its
seed; Ctrl-C inside the host loop returning partial results; the stage
placements (one device, one per stage, a process's share); a pipe x tp
ring on the CPU (the JAX package's pipe x tp cases are
`tests/test_torch_pp_tp.py`'s); `partition` against the JAX package's over a
grid of (n_layer, n_stages), the padding round trip and the stage
manifest byte for byte; the step-graph plumbing of the decode chunk on
the CPU (the stand-in graph of `test_torch_graphs.py`); the ring launches
none of the port's kernels.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.models import init_params
from mdi_llm_tpu.parallel import partition as jpart
from mdi_llm_tpu.parallel.mesh import pipeline_mesh as jmesh
from mdi_llm_tpu.parallel.pipeline import PipelineEngine as JPipeline
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.parallel import partition as tpart
from mdi_llm_tpu_torch.parallel.mesh import pipeline_mesh
from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine
from mdi_llm_tpu_torch.utils import step_graph
from tests.test_model import CONFIG_VARIANTS, tiny_config

torch.set_num_threads(1)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 18], [9, 9, 9, 9, 9, 9, 9], [6, 2]]
GREEDY = dict(temperature=0.0)


class Model:
    """One config in both packages, its weights, and the engines built on
    it (the JAX ones cached per setting: each compiles its own ring)."""

    def __init__(self, seed=0, **kw):
        self.jc = tiny_config(**kw)
        self.tc = TConfig(**self.jc.asdict())
        self.jp = init_params(self.jc, jax.random.PRNGKey(seed))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))
        self._jpipes = {}
        self.tgen = Generator(self.tc, self.tp, device="cpu", cache_dtype=torch.float32)

    def jpipe(self, devices, n_stages, **kw):
        key = (n_stages, tuple(sorted(kw.items())))
        if key not in self._jpipes:
            self._jpipes[key] = JPipeline(self.jc, self.jp, mesh=jmesh(n_stages, devices[:n_stages]),
                                          cache_dtype=jnp.float32, **kw)
        return self._jpipes[key]

    def tpipe(self, n_stages, **kw):
        kw.setdefault("cache_dtype", torch.float32)
        return PipelineEngine(self.tc, self.tp, n_stages=n_stages, device="cpu", **kw)

    def single(self, prompts, n, **kw):
        return [self.tgen.generate([p], n, **GREEDY, **kw)[0][0] for p in prompts]


@pytest.fixture(scope="module")
def model():
    return Model(block_size=128, n_layer=5)


def run_both(m, devices, n_stages, prompts, n, engine_kw=None, **gen_kw):
    """The JAX ring's and the port ring's (outs, stats) on the same run."""
    engine_kw = engine_kw or {}
    jout, jst = m.jpipe(devices, n_stages, **engine_kw).generate(prompts, n, **GREEDY, **gen_kw)
    tout, tst = m.tpipe(n_stages, **engine_kw).generate(prompts, n, **GREEDY, **gen_kw)
    return (jout, jst), (tout, tst)


def same_stats(jst, tst):
    """The counts the JAX ring reports, and the token column of its
    tokens/time trace (one entry per collected call)."""
    assert (tst.tokens_generated, tst.rotations, tst.token_fills) == (
        jst.tokens_generated, jst.rotations, jst.token_fills)
    assert [n for n, _t in tst.tok_time] == [n for n, _t in jst.tok_time]


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_pipeline_matches_jax_and_single_device(model, devices, n_stages):
    (jout, jst), (tout, tst) = run_both(model, devices, n_stages, PROMPTS[:n_stages], 10)
    assert tout == jout == model.single(PROMPTS[:n_stages], 10)
    assert tst.tokens_generated == 10 * n_stages
    same_stats(jst, tst)


def test_pipeline_waves_more_samples_than_stages(model, devices):
    (jout, jst), (tout, tst) = run_both(model, devices, 2, PROMPTS, 8)
    assert tout == jout == model.single(PROMPTS, 8)
    same_stats(jst, tst)


def test_pipeline_partial_wave(model, devices):
    (jout, jst), (tout, tst) = run_both(model, devices, 4, PROMPTS[:2], 6)
    assert tout == jout == model.single(PROMPTS[:2], 6)
    same_stats(jst, tst)


def test_pipeline_stop_sequences(model, devices):
    free = model.single(PROMPTS[:2], 8)
    stop = [free[0][len(PROMPTS[0]) + 3]]
    (jout, jst), (tout, tst) = run_both(model, devices, 2, PROMPTS[:2], 8,
                                        stop_sequences=[stop])
    assert tout == jout
    assert tout[0] == free[0][: len(PROMPTS[0]) + 3]
    same_stats(jst, tst)


def test_pipeline_stream_cb(model, devices):
    streamed = {j: [] for j in range(len(PROMPTS))}
    got, _ = model.tpipe(2).generate(PROMPTS, 8, **GREEDY,
                                     stream_cb=lambda j, t: streamed[j].append(t))
    jgot, _ = model.jpipe(devices, 2).generate(PROMPTS, 8, **GREEDY)
    assert got == jgot == model.single(PROMPTS, 8)
    for j, o in enumerate(got):
        assert streamed[j] == o[len(PROMPTS[j]):]


def test_pipeline_stream_cb_with_stops(model, devices):
    free = model.single(PROMPTS[:2], 8)
    stop = [free[0][len(PROMPTS[0]) + 3]]
    streamed = {0: [], 1: []}
    got, _ = model.tpipe(2).generate(PROMPTS[:2], 8, **GREEDY, stop_sequences=[stop],
                                     stream_cb=lambda j, t: streamed[j].append(t))
    jgot, _ = model.jpipe(devices, 2).generate(PROMPTS[:2], 8, **GREEDY, stop_sequences=[stop])
    assert got == jgot
    kept0 = got[0][len(PROMPTS[0]):]
    assert streamed[0][: len(kept0)] == kept0
    assert len(streamed[0]) <= len(kept0) + len(stop)


@pytest.mark.parametrize("n_samples", [4, 3])
def test_pipeline_samples_per_slot(model, devices, n_samples):
    (jout, jst), (tout, tst) = run_both(model, devices, 2, PROMPTS[:n_samples], 8,
                                        engine_kw=dict(samples_per_slot=2))
    assert tout == jout == model.single(PROMPTS[:n_samples], 8)
    assert tst.tokens_generated == 8 * n_samples
    same_stats(jst, tst)


def test_pipeline_samples_per_slot_waves(model, devices):
    (jout, jst), (tout, tst) = run_both(model, devices, 1, PROMPTS, 6,
                                        engine_kw=dict(samples_per_slot=2))
    assert tout == jout == model.single(PROMPTS, 6)
    same_stats(jst, tst)


def test_pipeline_continuous_beats_waves(model, devices):
    NEW = 20
    pool = [[3, 1, 4], [2, 7, 18], [9, 9, 9], [6, 2], [11, 5], [8, 13, 21]]
    free = model.single(pool, NEW)
    stops = [[free[j][len(pool[j]) + 1]] for j in (1, 3, 5)]
    want = model.single(pool, NEW, stop_sequences=stops)
    gens = [len(w) - len(p) for w, p in zip(want, pool)]
    assert min(gens[0], gens[2], gens[4]) >= 3 * max(gens[1], gens[3], gens[5])
    (jout, jst), (tout, tst) = run_both(model, devices, 2, pool, NEW,
                                        engine_kw=dict(rotations_per_call=1),
                                        stop_sequences=stops)
    assert tout == jout == want
    same_stats(jst, tst)
    assert tst.rotations < sum(max(gens[w: w + 2]) for w in range(0, 6, 2))


def test_pipeline_batch_refill_long_prompts(model, devices):
    NEW = 6
    rng = np.random.default_rng(7)
    pool = [rng.integers(1, 50, 40).tolist() for _ in range(4)]
    (jout, jst), (tout, tst) = run_both(model, devices, 2, pool, NEW,
                                        engine_kw=dict(rotations_per_call=1))
    assert tout == jout == model.single(pool, NEW)
    same_stats(jst, tst)
    assert tst.rotations <= 2 * NEW + 8


def test_pipeline_partial_slot_token_fill(model, devices):
    NEW = 20
    rng = np.random.default_rng(11)
    pool = [rng.integers(1, 50, n).tolist() for n in (5, 3, 7, 2, 4, 6, 14, 3)]
    free = model.single(pool, NEW)
    stops = [[free[j][len(pool[j]) + 1]] for j in (1, 2, 3, 4, 5)]
    want = model.single(pool, NEW, stop_sequences=stops)
    gens = [len(w) - len(p) for w, p in zip(want, pool)]
    assert gens[0] == NEW and gens[1] <= 2
    (jout, jst), (tout, tst) = run_both(model, devices, 2, pool, NEW,
                                        engine_kw=dict(samples_per_slot=2),
                                        stop_sequences=stops)
    assert tout == jout == want
    same_stats(jst, tst)
    assert tst.token_fills >= 1


@pytest.mark.parametrize("variant,prompts,n", [
    ("gqa", [[4, 8, 15]], 7),
    ("gpt2", [[4, 8, 15, 16]], 6),
    ("moe", [[4, 8, 15], [16, 23, 42]], 6),
])
def test_pipeline_config_variants(devices, variant, prompts, n):
    seed = {"gqa": 3, "gpt2": 4, "moe": 2}[variant]
    m = Model(seed=seed, block_size=64, n_layer=4, **CONFIG_VARIANTS[variant])
    (jout, jst), (tout, tst) = run_both(m, devices, 2, prompts, n)
    assert tout == jout == m.single(prompts, n)
    same_stats(jst, tst)


@pytest.mark.parametrize("overlap", [True, False])
def test_pipeline_overlap_modes_parity(model, devices, overlap):
    pool = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7, 1], [8, 8]]
    (jout, jst), (tout, tst) = run_both(model, devices, 2, pool, 12,
                                        engine_kw=dict(overlap_chunks=overlap))
    assert tout == jout == model.single(pool, 12)
    same_stats(jst, tst)


def test_bubble_lane_past_the_cache_is_clamped(model, devices, monkeypatch):
    """With overlapped chunks the ring runs one chunk past a sample's
    budget: a sample that ends at the last cache position leaves its lane
    running past the cache.  Those positions are clamped (the JAX ring's
    cache write clamps its start); the tokens stay the same."""
    seen = []
    forward = PipelineEngine._stage_forward

    def spy(self, s, kv, x, sid, input_pos):
        seen.append(int(input_pos.max()) + x.shape[1] - kv[s]["k"].shape[4])
        return forward(self, s, kv, x, sid, input_pos)

    monkeypatch.setattr(PipelineEngine, "_stage_forward", spy)
    prompt, new, seq = [5, 9, 2], 61, 64
    kw = dict(overlap_chunks=True, max_seq_length=seq)
    jout, jst = model.jpipe(devices, 2, **kw).generate([prompt], new, **GREEDY)
    tout, tst = model.tpipe(2, **kw).generate([prompt], new, **GREEDY)
    want, _ = Generator(model.tc, model.tp, device="cpu", cache_dtype=torch.float32,
                        max_seq_length=seq).generate([prompt], new, **GREEDY)
    assert len(tout[0]) == seq and tout == jout == want
    same_stats(jst, tst)
    assert max(seen) > 0  # some lane reached past the 64-slot cache


def test_ctrl_c_returns_partial_results(model):
    """An interrupt inside the ring's host loop (here from the stream
    callback) ends the run with what was collected, flagged."""
    seen = []

    def cb(j, tok):
        seen.append(tok)
        if len(seen) == 5:
            raise KeyboardInterrupt

    got, stats = model.tpipe(2, rotations_per_call=1).generate(PROMPTS[:2], 10, **GREEDY,
                                                             stream_cb=cb)
    full = model.single(PROMPTS[:2], 10)
    assert stats.interrupted
    assert 0 < sum(len(o) - len(p) for o, p in zip(got, PROMPTS)) < 20
    assert all(f[: len(o)] == o for o, f in zip(got, full))


def test_stage_placements(model):
    """One device for every stage, one per stage, a process's share; a
    ring whose stages sit on several devices runs the same tokens (its
    hop a copy between them) and is never captured."""
    cpu = torch.device("cpu")
    assert pipeline_mesh(2, ["cpu"]) == {0: cpu, 1: cpu}
    assert pipeline_mesh(4, ["cpu"] * 4, stages=range(2, 4)) == {2: cpu, 3: cpu}
    with pytest.raises(ValueError, match="one device for all stages or one per stage"):
        pipeline_mesh(4, ["cpu"] * 3)
    with pytest.raises(ValueError, match="out of range"):
        pipeline_mesh(2, ["cpu"], stages=[2])
    eng = PipelineEngine(model.tc, model.tp, devices=["cpu", "cpu"], device="cpu",
                         cache_dtype=torch.float32)
    assert eng.n_stages == 2 and eng.owned == [0, 1] and eng.counts == [2, 3]
    assert eng.generate(PROMPTS[:2], 6, **GREEDY)[0] == model.single(PROMPTS[:2], 6)
    with pytest.raises(ValueError, match="multiple of the node count"):
        PipelineEngine(model.tc, model.tp, n_stages=3, device="cpu",
                       ring=type("Ring", (), {"world": 2, "rank": 0, "device": cpu})())


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_quantized_ring_matches_quantized_generator(model, mode):
    want, _ = Generator(model.tc, model.tp, device="cpu", cache_dtype=torch.float32,
                        quantize=mode).generate(PROMPTS[:2], 10, **GREEDY)
    got, _ = model.tpipe(2, quantize=mode).generate(PROMPTS[:2], 10, **GREEDY)
    assert got == want


def test_sampled_ring_reproducible_from_its_seed(model):
    kw = dict(temperature=0.8, top_k=20)
    a, _ = model.tpipe(2, rng_seed=5).generate(PROMPTS, 12, **kw)
    b, _ = model.tpipe(2, rng_seed=5).generate(PROMPTS, 12, **kw)
    c, _ = model.tpipe(2, rng_seed=6).generate(PROMPTS, 12, **kw)
    assert a == b and a != c
    assert all(len(o) == len(p) + 12 for o, p in zip(a, PROMPTS))


@pytest.mark.parametrize("case", ["engine", "mesh"])
def test_tp_is_refused_naming_item_14(model, case):
    """Once refused (the pipe x tp ring was item 14's second half), now
    run: `tp=2` and the ("pipe", "tp") Mesh of `pipeline_mesh(2, ["cpu"],
    tp=2)` give the single device's greedy streams, each stage's blocks
    over two ranks of G/2 cached groups; the JAX ring's cases are held in
    tests/test_torch_pp_tp.py."""
    if case == "engine":
        eng = model.tpipe(2, tp=2)
    else:
        mesh = pipeline_mesh(2, ["cpu"], tp=2)
        assert mesh.axis_names == ("pipe", "tp") and mesh.shape == {"pipe": 2, "tp": 2}
        eng = PipelineEngine(model.tc, model.tp, mesh=mesh, cache_dtype=torch.float32)
    assert (eng.n_stages, eng.tp, eng.counts) == (2, 2, [2, 3])
    assert [len(eng.stage_blocks[s]) for s in (0, 1)] == [2, 2]
    got, stats = eng.generate(PROMPTS[:2], 6, **GREEDY)
    assert got == model.single(PROMPTS[:2], 6) and stats.tokens_generated == 12
    caches = next(iter(eng._caches.values()))
    assert caches[0][1]["k"].shape[3] == model.tc.n_query_groups // 2


def test_ring_launches_no_kernel_and_graph_plumbing(model, monkeypatch):
    """On the CPU with `_graphs=True` the decode chunk goes through the
    stand-in graph (capture once per chunk length, replays after); the
    streams equal the eager ring's and no kernel wrapper or plain route
    counts a call."""
    from tests.test_torch_graphs import _fake_graph_class

    monkeypatch.setattr(step_graph, "CudaGraph", _fake_graph_class(step_graph.kernel_counters))
    before = [getattr(o, a) for o, a in step_graph.kernel_counters()]
    eng = model.tpipe(2, _graphs=True)
    got, stats = eng.generate(PROMPTS, 8, **GREEDY)
    again, stats2 = eng.generate(PROMPTS, 8, **GREEDY)
    assert got == again == model.single(PROMPTS, 8)
    g = eng.graph_stats()
    assert stats.captures == g["captures"] >= 1 and stats2.captures == 0
    assert g["replays"] >= stats.rotations // 16
    assert [getattr(o, a) for o, a in step_graph.kernel_counters()] == before


@pytest.mark.parametrize("sampling", [dict(temperature=0.0), dict(temperature=0.8, top_k=4)],
                         ids=["greedy", "sampled"])
def test_decode_chunk_body_makes_no_host_copy_or_read(model, monkeypatch, sampling):
    """What a CUDA graph capture refuses: no host read and no tensor made
    from host values inside the decode chunk's body."""
    eng = model.tpipe(2)
    eng.generate(PROMPTS, 8, **sampling)
    steps = list(eng._steps.values())
    assert steps

    def refuse(*args, **kwargs):
        raise AssertionError("a host copy or host read inside the decode chunk")

    monkeypatch.setattr(torch, "tensor", refuse)
    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for step in steps:
        step.call()


@pytest.mark.parametrize("n_layer,n_stages", [
    (5, 2), (22, 2), (22, 3), (22, 4), (22, 5), (32, 4), (7, 3), (10, 4), (13, 6), (40, 7),
])
def test_partition_matches_jax(tmp_path, n_layer, n_stages):
    assert tpart.stage_layers(n_layer, n_stages) == jpart.stage_layers(n_layer, n_stages)
    assert tpart.stage_bounds(n_layer, n_stages) == jpart.stage_bounds(n_layer, n_stages)
    jc = tiny_config(n_layer=n_layer)
    tc = TConfig(**jc.asdict())
    for q in ("none", "int8"):
        tp = tpart.save_stage_manifest(tmp_path / "t", tc, n_stages, quantize=q)
        jp = jpart.save_stage_manifest(tmp_path / "j", jc, n_stages, quantize=q)
        assert tp.read_bytes() == jp.read_bytes()
    assert json.loads(tp.read_text())["stage_layers"] == tpart.stage_layers(n_layer, n_stages)


def test_partition_refuses_empty_stages():
    for mod in (tpart, jpart):
        with pytest.raises(ValueError, match="cannot split"):
            mod.stage_layers(3, 4)


def test_split_and_pad_match_jax(model):
    counts = tpart.stage_layers(model.jc.n_layer, 2)
    jst = jpart.split_params(model.jc, model.jp, 2)
    tst = tpart.split_params(model.tc, model.tp, 2)
    for j, t in zip(jst, tst):
        assert sorted(j) == sorted(t)
        for a, b in zip(jax.tree_util.tree_leaves(j), ttf.tree_leaves(t)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jpad = jpart.pad_stage_blocks(jst, max(counts))
    tpad = tpart.pad_stage_blocks(tst, max(counts))
    for a, b in zip(jax.tree_util.tree_leaves(jpad), ttf.tree_leaves(tpad)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = tpart.unpad_stage_blocks(tpad, counts)
    for a, b in zip(ttf.tree_leaves(back), ttf.tree_leaves(model.tp["blocks"])):
        assert torch.equal(a, b)
    sliced = ttf.slice_blocks(model.tp["blocks"], 1, 3)
    assert sliced["norm_1"]["weight"].shape[0] == 2
