"""The port's tensor-parallel serving engine (`Generator(mesh=make_mesh(
{"tp": N}, devices)).serve(...)`, `serving/engine.validate_serving_mesh`)
against the JAX package, on the CPU.

One counterpart for each test of `tests/test_tp_serving.py` but the
recompile counter (JAX-only, and red in the reference) and the audit's
(tests/test_torch_audit.py), on the same float32 weights of `tiny_config(block_size=128)`,
every rank on the CPU:

- greedy streams at tp = 2 and 4 equal the JAX tp engine's (virtual CPU
  devices), the JAX and the port's single engines' and sequential
  `generate`'s, with the single engine's step and sync counts: the
  acceptance trace, chunked decode, n-gram speculation, a draft model on
  the same mesh, preemption, prefix-cache hits, GQA groups split one per
  rank, int8 and e4m3 pools; through both attention routes
  (`use_kernel=None`, the plain route, and `use_kernel=True`, K1's plain
  version, which gets each rank's heads over its own pool slice);
- the pool is {rank: (L, NB, BS, G/tp, hs)} (+ the int8 scales), each
  rank's bytes a 1/tp share; the host tier's swaps under tp hold, with
  the ranks' slabs joined on the group axis, exactly the bytes the JAX
  tier keeps for its tp-global leaves (fp, int8 payload and scales, e4m3),
  and a tight-pool swap serve equals the JAX tp engine's;
- `validate_serving_mesh`'s refusals with the JAX package's messages;
  K1's plain version per rank slice against the whole; the serve and
  server CLIs' `--tp` (stats line `tp`, `n_chips`).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import init_params
from mdi_llm_tpu.parallel.mesh import make_mesh as jmake_mesh
from mdi_llm_tpu.serving.engine import validate_serving_mesh as jvalidate
from mdi_llm_tpu_torch.cli import serve as serve_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import paged_attention as tpa
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from mdi_llm_tpu_torch.serving import host_tier as tht
from mdi_llm_tpu_torch.serving.engine import ServingEngine, pool_bytes, validate_serving_mesh
from tests.test_model import CONFIG_VARIANTS, tiny_config

torch.set_num_threads(1)

ROUTES = [None, True]
ROUTE_IDS = ["plain", "k1plain"]


class Model:
    """tiny_config(block_size=128) in both packages on one set of float32
    weights: the single Generators, the JAX tp = 2 Generator and the
    port's tp = 2 and 4 Generators."""

    def __init__(self, devices, **kw):
        self.jc = tiny_config(block_size=128, **kw)
        self.tc = TConfig(**self.jc.asdict())
        self.jp = init_params(self.jc, jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))
        self.jgen = JGenerator(self.jc, self.jp, cache_dtype=jnp.float32)
        self.jtp = JGenerator(self.jc, self.jp, cache_dtype=jnp.float32,
                              mesh=jmake_mesh({"tp": 2}, devices[:2]))
        self.tgen = self.gen()
        self.tps = {n: self.gen(make_mesh({"tp": n}, ["cpu"])) for n in (2, 4)
                    if self.tc.n_query_groups % n == 0}

    def gen(self, mesh=None, **kw):
        return Generator(self.tc, self.tp, cache_dtype=torch.float32, device="cpu",
                         mesh=mesh, **kw)

    def prompts(self, lens, seed=5):
        rng = np.random.default_rng(seed)
        return [rng.integers(1, self.tc.vocab_size, int(n)).tolist() for n in lens]


@pytest.fixture(scope="module")
def model(devices):
    return Model(devices)


def _serve(gen, prompts, max_news, **knobs):
    engine = gen.serve(**knobs)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        engine.add_request(f"r{i}", p, m)
    results, stats = engine.run()
    return results, stats, engine


def _cadence(stats):
    return (stats.mixed_steps, stats.decode_steps, stats.host_syncs,
            stats.requests_finished, stats.tokens_generated)


def _sequential(gen, prompts, max_news):
    return [gen.generate([p], m, temperature=0.0)[0][0] for p, m in zip(prompts, max_news)]


# ---------------------------------------------------------------------------
# counterparts of tests/test_tp_serving.py
# ---------------------------------------------------------------------------

ACCEPT_KNOBS = dict(block_size=4, max_batch=3, prefill_chunk=16, token_budget=12)
ACCEPT_NEWS = [8, 12, 6, 10, 7]


@pytest.fixture(scope="module")
def acceptance(model):
    prompts = model.prompts((3, 9, 17, 5, 33))
    jres, jstats, _ = _serve(model.jgen, prompts, ACCEPT_NEWS, **ACCEPT_KNOBS)
    jtp, _, _ = _serve(model.jtp, prompts, ACCEPT_NEWS, **ACCEPT_KNOBS)
    gen = _sequential(model.tgen, prompts, ACCEPT_NEWS)
    tres, tstats, _ = _serve(model.tgen, prompts, ACCEPT_NEWS, **ACCEPT_KNOBS)
    return prompts, jres, jtp, gen, tres, tstats


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_tp_engine_matches_single_engine_and_generate(model, acceptance, tp, route):
    """The acceptance trace (its 33-token prompt splits over several mixed
    steps): streams equal the JAX tp engine's, both single engines' and
    sequential generate's; the same step and sync counts; the pool is
    split on its group axis, one slice per rank."""
    prompts, jres, jtp, want_gen, tres, tstats = acceptance
    got, stats, engine = _serve(model.tps[tp], prompts, ACCEPT_NEWS, use_kernel=route,
                                **ACCEPT_KNOBS)
    assert got == jres == jtp == tres
    assert [got[f"r{i}"] for i in range(len(prompts))] == want_gen
    assert _cadence(stats) == _cadence(tstats) and stats.mixed_steps >= 4
    assert isinstance(engine, ServingEngine) and sorted(engine._kv) == list(range(tp))
    G = model.tc.n_query_groups
    assert all(x.shape[3] == G // tp for x in ttf.tree_leaves(engine._kv))
    assert engine.pool.used == 0


@pytest.mark.parametrize("chunk,buffered", [(4, True), (8, False)], ids=["k4-buffered", "k8-nobuf"])
def test_tp_chunked_decode_token_identical(model, chunk, buffered):
    prompts = model.prompts((3, 9, 17))
    news = [8, 12, 6]
    knobs = dict(block_size=4, max_batch=3, prefill_chunk=8, decode_chunk=chunk,
                 double_buffer=buffered)
    want, wstats, _ = _serve(model.tgen, prompts, news, **knobs)
    jwant, _, _ = _serve(model.jtp, prompts, news, **knobs)
    got, stats, _ = _serve(model.tps[2], prompts, news, **knobs)
    assert got == want == jwant
    assert stats.tokens_per_sync > 1.0 and _cadence(stats) == _cadence(wstats)


def test_tp_speculative_serving_token_identical(model):
    cyc = [np.random.default_rng(s).integers(1, model.tc.vocab_size, 5).tolist()
           for s in (5, 7, 0)]
    news = [30, 25, 20]
    knobs = dict(block_size=4, max_batch=3, decode_chunk=4, spec_k=4)
    want, wstats, _ = _serve(model.tgen, cyc, news, **knobs)
    jwant, _, _ = _serve(model.jtp, cyc, news, **knobs)
    got, stats, _ = _serve(model.tps[2], cyc, news, **knobs)
    assert got == want == jwant
    assert stats.spec_drafted > 0 and stats.spec_accepted > 0
    assert stats.spec_accepted == wstats.spec_accepted


def test_tp_draft_model_engine_token_identical(model, devices):
    """Target and draft on the same tp = 2 mesh, each pool split on its
    groups: the sequential greedy streams, and the JAX tp draft engine's."""
    dc = tiny_config(name="test-tiny-draft", n_layer=1, block_size=128)
    djp = init_params(dc, jax.random.PRNGKey(1))
    dtp = params_from_numpy(jax.tree_util.tree_map(np.asarray, djp))
    cyc = [np.random.default_rng(s).integers(1, model.tc.vocab_size, 5).tolist()
           for s in (5, 7, 0)]
    news = [20, 16, 12]
    want = _sequential(model.tgen, cyc, news)
    mesh = make_mesh({"tp": 2}, ["cpu"])
    dgen = Generator(TConfig(**dc.asdict()), dtp, cache_dtype=torch.float32, device="cpu",
                     mesh=mesh)
    knobs = dict(block_size=4, max_batch=3, decode_chunk=4, spec_k=4,
                 draft_model="test-tiny-draft")
    engine = model.tps[2].serve(draft_gen=dgen, **knobs)
    for i, (p, m) in enumerate(zip(cyc, news)):
        engine.add_request(f"r{i}", p, m)
    results, stats = engine.run()
    assert [results[f"r{i}"] for i in range(3)] == want
    assert stats.spec_drafted_model > 0 and engine.draft_pool.used == 0
    assert sorted(engine._draft_kv) == [0, 1]
    jd = JGenerator(dc, djp, cache_dtype=jnp.float32, mesh=model.jtp.mesh)
    jres, jstats, _ = _serve(model.jtp, cyc, news, draft_gen=jd, **knobs)
    assert [jres[f"r{i}"] for i in range(3)] == want
    assert stats.spec_accepted == jstats.spec_accepted


def test_tp_preemption_resume_parity(model):
    prompts = model.prompts((9, 13, 11), seed=9)
    news = [10, 10, 10]
    knobs = dict(block_size=4, max_batch=3, max_blocks=1 + 10, prefix_caching=False,
                 decode_chunk=4)
    want, wstats, _ = _serve(model.tgen, prompts, news, **knobs)
    got, stats, engine = _serve(model.tps[2], prompts, news, **knobs)
    assert stats.preemptions >= 1 and stats.preemptions == wstats.preemptions
    assert got == want and engine.pool.used == 0


def test_tp_prefix_cache_hits_parity(model):
    head = model.prompts((21,), seed=7)[0]
    engine = model.tps[2].serve(block_size=4, max_batch=2)
    engine.add_request("first", head, 6)
    engine.run()
    tail = head + [7, 8]
    engine.add_request("second", tail, 6)
    results, stats = engine.run()
    assert stats.prefix_cache_hits >= 5
    assert results["second"] == _sequential(model.tgen, [tail], [6])[0]


def test_tp_gqa_groups_shard(devices):
    """G=2 KV groups split one per rank at tp=2, the narrowest split, with
    the single engine's streams and the JAX tp engine's."""
    m = Model(devices, n_layer=3, **CONFIG_VARIANTS["gqa"])
    prompts = m.prompts((5, 12), seed=3)
    knobs = dict(block_size=4, max_batch=2, decode_chunk=4)
    want, _, _ = _serve(m.tgen, prompts, [8, 8], **knobs)
    jwant, _, _ = _serve(m.jtp, prompts, [8, 8], **knobs)
    got, _, engine = _serve(m.tps[2], prompts, [8, 8], **knobs)
    assert got == want == jwant
    assert all(x.shape[3] == 1 for x in ttf.tree_leaves(engine._kv))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp_pool_bytes_are_a_share_of_the_single_pool(model, kv_dtype):
    """The port's counterpart of the JAX audit test's runtime half (the
    audit itself: tests/test_torch_audit.py): each rank holds 1/tp of the single engine's
    pool bytes, on its device, and the tp pool's total is the single's."""
    single = model.tgen.serve(block_size=4, max_batch=3, prefill_chunk=8, kv_dtype=kv_dtype)
    for tp, gen in model.tps.items():
        engine = gen.serve(block_size=4, max_batch=3, prefill_chunk=8, kv_dtype=kv_dtype)
        assert pool_bytes(engine._kv) == pool_bytes(single._kv)
        for r in range(tp):
            assert pool_bytes(engine._kv[r]) * tp == pool_bytes(single._kv)
        assert engine.devices == 1


@pytest.mark.parametrize("axes,name", [({"dp": 2}, "dp"), ({"ep": 2}, "ep"), ({"sp": 2}, "sp"),
                                       ({"xp": 2}, "xp")])
def test_serve_rejects_unsupported_mesh_axes(model, devices, axes, name):
    """`validate_serving_mesh` refuses dp, ep, sp and unknown axes with the
    JAX package's messages; `Generator.serve()` refuses a dp mesh before
    any pool is allocated, and a size-1 axis beside tp is harmless."""
    with pytest.raises(ValueError, match=name) as theirs:
        jvalidate(jmake_mesh(axes, devices[:2]))
    with pytest.raises(ValueError, match=name) as mine:
        validate_serving_mesh(make_mesh(axes, ["cpu"]))
    assert str(mine.value) == str(theirs.value)
    if name == "dp":
        with pytest.raises(ValueError, match="dp=2"):
            model.gen(make_mesh(axes, ["cpu"])).serve(block_size=4, max_batch=2)
    validate_serving_mesh(make_mesh({"dp": 1, "tp": 2, "pp": 2}, ["cpu"]))
    model.gen(make_mesh({"dp": 1, "tp": 2}, ["cpu"])).serve(block_size=4, max_batch=2)


def test_cli_help_covers_tp_flags():
    from mdi_llm_tpu_torch.cli import server as server_cli

    for parser in (serve_cli.build_parser(), server_cli.build_parser()):
        help_text = " ".join(parser.format_help().split())
        assert "--tp" in help_text and "tensor-parallel" in help_text
        assert "not ported" not in help_text.split("--tp")[1][:80]


@pytest.mark.parametrize("Tq", [1, 33], ids=["decode", "wide"])
def test_k1_per_rank_slices_match_the_whole(Tq):
    """K1's plain version (the kernel route on CPU tensors) run per rank
    on its heads and its pool's group slice, with the shared tables and
    spans, gives the whole call's rows for those heads."""
    H, G, B, hs, S, bs = 4, 2, 2, 16, 64, 8
    g = torch.Generator().manual_seed(9)
    NB = 1 + B * (S // bs)
    q = torch.randn(B, H, Tq, hs, generator=g)
    kp = torch.randn(NB, bs, G, hs, generator=g)
    vp = torch.randn(NB, bs, G, hs, generator=g)
    tables = torch.randperm(NB - 1, generator=g)[: B * (S // bs)].reshape(B, S // bs) + 1
    q_pos = torch.stack([torch.arange(Tq), torch.arange(S - Tq, S)])
    whole = tpa.paged_attention(q, kp, vp, tables, q_pos, use_kernel=True)
    for r in range(2):
        part = tpa.paged_attention(q[:, 2 * r:2 * r + 2], kp[:, :, r:r + 1], vp[:, :, r:r + 1],
                                   tables, q_pos, use_kernel=True)
        torch.testing.assert_close(part, whole[:, 2 * r:2 * r + 2], atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the port's own: pools, the host tier, the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["int8", "float8"])
@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_tp_narrow_pools_match_the_single_engine(model, acceptance, kv_dtype, route):
    prompts = acceptance[0]
    want, wstats, _ = _serve(model.tgen, prompts, ACCEPT_NEWS, kv_dtype=kv_dtype,
                             **ACCEPT_KNOBS)
    got, stats, engine = _serve(model.tps[2], prompts, ACCEPT_NEWS, kv_dtype=kv_dtype,
                                use_kernel=route, **ACCEPT_KNOBS)
    assert got == want and _cadence(stats) == _cadence(wstats)
    if kv_dtype == "int8":
        assert all(engine._kv[r][s]["scale"].shape[-1] == model.tc.n_query_groups // 2
                   for r in (0, 1) for s in ("k", "v"))
        jwant, _, _ = _serve(model.jtp, prompts, ACCEPT_NEWS, kv_dtype=kv_dtype,
                             **ACCEPT_KNOBS)
        assert got == jwant


def test_tp_sampled_serving_is_seeded(model):
    prompts = model.prompts((4, 7, 9), seed=2)
    knobs = dict(block_size=4, max_batch=3, decode_chunk=1, temperature=0.8, top_k=8)
    a, _, _ = _serve(model.tps[2], prompts, [6, 6, 6], **knobs)
    b, _, _ = _serve(model.tps[2], prompts, [6, 6, 6], **knobs)
    assert a == b


POOLS = {"f32": (jnp.float32, torch.float32, None), "int8": (jnp.float32, torch.float32, "int8"),
         "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, None)}


def _np_bytes(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _torch_bytes(t):
    return t.contiguous().view(tht.raw_dtype(t.dtype)).numpy()


@pytest.mark.parametrize("pool", list(POOLS))
def test_tp_host_tier_holds_the_jax_tiers_bytes(model, pool):
    """The JAX tp engine's pool (tp-global leaves) filled with seeded
    values and the port's rank pools with their group slices: a swap-out
    through the port's tier leaves per-rank slabs that, joined on the group
    axis, are byte for byte what the JAX tier's fetch gathers; a restore
    leaves each rank's pool equal to its slice of the JAX pool after the
    JAX restore."""
    jdt, tdt, kv_dtype = POOLS[pool]
    knobs = dict(block_size=4, max_batch=1, max_blocks=1 + 30, prefix_caching=False,
                 host_pool_mib=64, host_link_gbps=1000.0, kv_dtype=kv_dtype)
    je = JGenerator(model.jc, model.jp, cache_dtype=jdt, mesh=model.jtp.mesh).serve(**knobs)
    te = Generator(model.tc, model.tp, cache_dtype=tdt, device="cpu",
                   mesh=make_mesh({"tp": 2}, ["cpu"])).serve(**knobs)
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(je._kv)
    filled = []
    for leaf in leaves:
        dt = np.dtype(leaf.dtype)
        a = (rng.integers(-127, 128, leaf.shape).astype(dt) if dt.kind == "i"
             else rng.standard_normal(leaf.shape).astype(np.float32).astype(dt))
        filled.append(a)
    je._kv = jax.tree_util.tree_unflatten(
        treedef, [jax.device_put(jnp.asarray(a), x.sharding) for a, x in zip(filled, leaves)])

    def group_axis(a):  # the payload (L, NB, BS, G, hs), the scales (L, NB, G)
        return 3 if a.ndim == 5 else 2

    for r in (0, 1):
        for x, a in zip(ttf.tree_leaves(te._kv[r]), filled):
            ax = group_axis(a)
            part = np.take(a, np.arange(r * a.shape[ax] // 2, (r + 1) * a.shape[ax] // 2), ax)
            x.view(tht.raw_dtype(x.dtype)).copy_(torch.from_numpy(_np_bytes(part).copy()))
    src = [5, 9, 17, 3, 20, 21, 22, 23, 24, 25, 26]
    dst = [27, 28, 2, 29, 30, 1, 11, 12, 13, 14, 15]
    W = je.cfg.swap_chunk_blocks
    want = []
    for i in range(0, len(src), W):
        idx = np.zeros((W,), np.int32)
        chunk = src[i : i + W]
        idx[: len(chunk)] = chunk
        out = je._fetch_blocks_fn(W)(je._kv, jnp.asarray(idx))
        want.append([np.asarray(x)[: len(chunk)] for x in jax.tree_util.tree_leaves(out)])
    slots = te.host_tier.store.alloc(len(src))
    te._issue_fetch(src, slots)
    te._drain_swaps()
    got = te.host_tier.store.read(slots)  # rank 0's leaves, then rank 1's
    n = len(filled)
    assert len(got) == 2 * n
    for j in range(n):
        w = np.concatenate([c[j] for c in want])
        ax = group_axis(filled[j])  # slab rows are (blocks, L, ...): the same axis
        joined = np.concatenate([_torch_bytes(got[j]), _torch_bytes(got[n + j])], axis=ax)
        assert np.array_equal(joined, _np_bytes(w))
    for i in range(0, len(dst), W):
        chunk = dst[i : i + W]
        idx = np.zeros((W,), np.int32)
        idx[: len(chunk)] = chunk
        payload = []
        for j in range(n):
            rows = np.concatenate([c[j] for c in want])[i : i + W]
            pad = np.zeros((W - len(rows),) + rows.shape[1:], rows.dtype)
            payload.append(jnp.asarray(np.concatenate([rows, pad])))
        je._kv = je._restore_blocks_fn(W)(je._kv, jnp.asarray(idx), payload)
    te._restore(slots, dst)
    for j, a in enumerate(jax.tree_util.tree_leaves(je._kv)):
        theirs = _np_bytes(a)
        ax = group_axis(np.asarray(a))
        mine = np.concatenate([_torch_bytes(ttf.tree_leaves(te._kv[r])[j]) for r in (0, 1)],
                              axis=ax)
        assert np.array_equal(mine[:, 1:], theirs[:, 1:])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp_tight_pool_swap_serve_matches_jax(model, kv_dtype):
    """The pool-starved trace resolved by swaps on the tp = 2 engine: the
    JAX tp engine's streams and tier counters, and the port's recompute
    run's streams."""
    prompts = model.prompts((9, 13, 11), seed=9)
    news = [10, 10, 10]
    knobs = dict(block_size=4, max_batch=3, max_blocks=1 + 14, prefix_caching=False,
                 decode_chunk=1, kv_dtype=kv_dtype, host_link_gbps=1000.0)
    jres, jstats, _ = _serve(model.jtp, prompts, news, host_pool_mib=64, **knobs)
    tres, tstats, _ = _serve(model.tps[2], prompts, news, host_pool_mib=64, **knobs)
    rres, _, _ = _serve(model.tps[2], prompts, news, host_pool_mib=0, **knobs)
    assert tres == jres == rres
    for k in ("preemptions", "swaps_out", "swaps_in", "swap_out_bytes", "host_syncs"):
        assert getattr(tstats, k) == getattr(jstats, k), k
    assert tstats.swaps_out >= 1


CPU_RUN = ["--model", "pythia-14m", "--synthetic", "3", "--max-batch", "2", "--n-tokens", "8",
           "--sequence-length", "128", "--block-size", "8"]


def test_serve_cli_tp_prints_its_topology_and_the_single_streams(capsys):
    """`cli.serve --tp 2` (float32) prints the `--tp 1` streams; its stats
    line carries `tp: 2` and `n_chips: 2` on one device."""
    base = ["--device", "cpu", "--dtype", "float32", *CPU_RUN, "--no-device-obs"]
    serve_cli.main(base)
    want = capsys.readouterr()
    line = serve_cli.main(base + ["--tp", "2"])
    got = capsys.readouterr()
    assert got.out == want.out
    assert (line["tp"], line["n_chips"], line["devices"], line["pp"]) == (2, 2, 1, 1)
    assert json.loads(got.err.strip().splitlines()[-1])["tp"] == 2


def test_serve_cli_refuses_tp_with_pp_naming_item_14(capsys):
    """Once refused (item 14, second half): `cli.serve --tp 2 --pp 2`
    (float32) serves over the pipe x tp ring and prints the `--tp 1`
    streams; its stats line says tp 2, pp 2 and n_chips 4 on one device."""
    base = ["--device", "cpu", "--dtype", "float32", *CPU_RUN, "--no-device-obs"]
    serve_cli.main(base)
    want = capsys.readouterr()
    line = serve_cli.main(base + ["--tp", "2", "--pp", "2"])
    got = capsys.readouterr()
    assert got.out == want.out
    assert (line["tp"], line["pp"], line["n_chips"], line["devices"]) == (2, 2, 4, 1)


def test_server_cli_builds_a_tp_engine():
    from mdi_llm_tpu_torch.cli import server as server_cli

    args = server_cli.build_parser().parse_args(
        ["--device", "cpu", "--model", "pythia-14m", "--tp", "2", "--no-device-obs"])
    engine, _tok = server_cli.serve_cli.build_engine(args, need_tokenizer=False,
                                                     origin="cli.server")
    assert engine.gen.tp == 2 and sorted(engine._kv) == [0, 1]
    with pytest.raises(SystemExit, match="not ported"):
        server_cli.main(["--device", "cpu", "--model", "pythia-14m", "--pp", "2"])
