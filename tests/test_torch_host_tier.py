"""The port's host-RAM KV tier (`mdi_llm_tpu_torch/serving/host_tier.py` and
the engine's swap path) against the JAX package's, on the CPU.

- the cost model's boundary, EWMA and zero-bandwidth cases, the store's
  all-or-nothing allocation and the tier's LRU spill eviction give the JAX
  package's answers on the same inputs;
- the engine's fetch and restore move pool blocks byte for byte: over
  float32, bfloat16, int8 (payload and scales), e4m3 and e5m2 pools holding
  the JAX engine's bytes, the host slots hold what the JAX engine's
  `_fetch_blocks_fn` gathers, and a restore leaves the port's pool equal to
  the JAX engine's after its `_restore_blocks_fn`;
- a tight-pool greedy float32 serve with the tier gives the JAX engine's
  streams and counters, and the streams of the port's own run without a
  tier; spilled prefix chains come back as `prefix_hits_host`;
- the scheduler's recompute fallback, `drop_swap_record` (also through a
  frontend cancel), the observer's `serving_swap_*` counters and
  `restore_wait` histogram, and the serve CLI's tier flags.
"""

import json

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
from mdi_llm_tpu.serving import host_tier as jht
from mdi_llm_tpu_torch.cli import serve as serve_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.config import ServingConfig as TServingConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.obs import ServingObserver as TObserver
from mdi_llm_tpu_torch.serving import host_tier as tht
from mdi_llm_tpu_torch.serving.kv_pool import KVPool
from mdi_llm_tpu_torch.serving.scheduler import Request, Scheduler

torch.set_num_threads(1)

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)


@pytest.fixture(scope="module")
def served():
    jc, tc = JConfig(**TINY), TConfig(**TINY)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jgen = JGenerator(jc, jp, cache_dtype=jnp.float32)
    tgen = TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu")
    return jgen, tgen


# ---------------------------------------------------------------------------
# the host-side pieces
# ---------------------------------------------------------------------------


def _cost_model_trace(mod):
    cm = mod.SwapCostModel(link_gbps=8.0, prefill_tokens_per_s=2000.0, ewma=0.25)
    out = [cm.swap_seconds(8_000_000_000), cm.recompute_seconds(2000)]
    out += [cm.should_swap(8_000_000_000, n) for n in (4001, 4000, 3999)]
    cm.observe_transfer(16_000_000_000, 1.0)
    cm.observe_prefill(4000, 1.0)
    out += [cm.link_gbps, cm.prefill_tokens_per_s]
    cm.observe_transfer(0, 1.0)  # degenerate measurements are ignored
    cm.observe_prefill(100, 0.0)
    out += [cm.link_gbps, cm.prefill_tokens_per_s]
    zero = mod.SwapCostModel(link_gbps=0.0)
    out += [zero.swap_seconds(1), zero.should_swap(1, 10**9)]
    return out


def test_cost_model_boundary_ewma_and_zero_link_match_jax():
    got, want = _cost_model_trace(tht), _cost_model_trace(jht)
    assert got == want
    assert got[2:5] == [True, False, False]  # a tie is no win
    assert got[-2:] == [float("inf"), False]


def test_link_table_is_the_cards_and_explicit_bandwidth_wins():
    assert tht.lookup_host_link_gbps("cpu") == tht.DEFAULT_HOST_LINK_GBPS
    assert tht.lookup_host_link_gbps(None) == jht.DEFAULT_HOST_LINK_GBPS
    assert not any(k.startswith("TPU") for k in tht.HOST_LINK_GBPS)
    for kind, gbps in tht.HOST_LINK_GBPS.items():
        assert kind.startswith("NVIDIA ") and gbps > 0
        assert tht.lookup_host_link_gbps(kind) == gbps
    assert TServingConfig(host_link_gbps=3.5).resolved_host_link_gbps("cpu") == 3.5
    assert TServingConfig().resolved_host_link_gbps(None) == tht.DEFAULT_HOST_LINK_GBPS


def _store_trace(mod, dtype):
    store = mod.HostBlockStore([((1, 3, 2), dtype)], 1, num_slots=3)
    out = [store.available, store.nbytes]
    a = store.alloc(2)
    out += [a, store.used, store.alloc(2), store.used]  # no partial grab
    b = store.alloc(1)
    out += [b, store.available]
    store.release(a)
    out += [sorted(store.alloc(2)), store.alloc(-1)]
    return out


def _tier_trace(mod, dtype):
    def tier(n):
        return mod.HostTier(mod.HostBlockStore([((1, 3, 2), dtype)], 1, n),
                            mod.SwapCostModel(link_gbps=8.0), prefix_spill=True)

    t = tier(3)
    for h in (101, 102, 103):
        t.record_spill(h, t.alloc_for_spill())
    out = [list(t.spilled), t.store.available, t.alloc_for_swap(2), list(t.spilled)]
    t2 = tier(2)
    swap = t2.alloc_for_swap(2)
    out += [swap, t2.alloc_for_spill(), t2.store.used]  # a spill never displaces a swap
    t2.store.release([swap.pop()])
    s = t2.alloc_for_spill()
    t2.record_spill(7, s)
    out += [t2.alloc_for_spill() == s, t2.take_spill(7), t2.lookup_spill(7)]
    out.append({k: v for k, v in t.snapshot().items() if k != "host_pool_bytes"})
    return out


def test_store_alloc_and_tier_lru_eviction_match_jax():
    assert _store_trace(tht, torch.float32) == _store_trace(jht, np.float32)
    assert _tier_trace(tht, torch.float32) == _tier_trace(jht, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn, torch.float8_e5m2],
                         ids=["f32", "bf16", "int8", "e4m3", "e5m2"])
def test_store_write_read_is_byte_exact_and_drops_padding(dtype):
    store = tht.HostBlockStore([((2, 5, 4, 3), dtype), ((2, 5, 3), torch.float32)], 1, 4)
    assert store.nbytes == 4 * (2 * 4 * 3 * dtype.itemsize + 2 * 3 * 4)
    g = torch.Generator().manual_seed(0)
    raw = [torch.randint(-100, 100, (4, 2, 4, 3), generator=g).to(tht.raw_dtype(dtype)),
           torch.randint(-100, 100, (4, 2, 3), generator=g).to(torch.int32)]
    payload = [raw[0].view(dtype), raw[1].view(torch.float32)]
    slots = store.alloc(2)
    store.write(slots, payload)  # rows 2 and 3 are transfer padding
    back = store.read(slots)
    assert [b.dtype for b in back] == [dtype, torch.float32]
    for r, b in zip(raw, back):
        assert torch.equal(b.view(r.dtype), r[:2])
    padded = store.read(slots, width=3)
    assert all(torch.equal(p.view(r.dtype)[:2], r[:2]) and not p.view(r.dtype)[2].any()
               for p, r in zip(padded, raw))
    back[0].view(raw[0].dtype).zero_()  # reads are copies
    assert torch.equal(store.read(slots)[0].view(raw[0].dtype), raw[0][:2])


# ---------------------------------------------------------------------------
# engine: fetch and restore against the JAX engine's executables
# ---------------------------------------------------------------------------

POOLS = {
    "f32": dict(cache=(jnp.float32, torch.float32), kv_dtype=None),
    "bf16": dict(cache=(jnp.bfloat16, torch.bfloat16), kv_dtype=None),
    "int8": dict(cache=(jnp.float32, torch.float32), kv_dtype="int8"),
    "e4m3": dict(cache=(jnp.float32, torch.float32), kv_dtype="float8_e4m3fn"),
    "e5m2": dict(cache=(jnp.float32, torch.float32), kv_dtype="float8_e5m2"),
}


def _np_bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _torch_bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(tht.raw_dtype(t.dtype)).numpy().view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[t.element_size()])


@pytest.mark.parametrize("pool", list(POOLS))
def test_fetch_and_restore_move_the_jax_engines_bytes(served, pool):
    jgen, tgen = served
    jdt, tdt = POOLS[pool]["cache"]
    knobs = dict(block_size=4, max_batch=1, max_blocks=1 + 30, prefix_caching=False,
                 host_pool_mib=64, host_link_gbps=1000.0, kv_dtype=POOLS[pool]["kv_dtype"])
    je = JGenerator(jgen.cfg, jgen.params, cache_dtype=jdt).serve(**knobs)
    te = TGenerator(tgen.cfg, tgen.params, cache_dtype=tdt, device="cpu").serve(**knobs)
    # the JAX pool filled with seeded values; the port's pool gets its bytes
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(je._kv)
    filled = []
    for leaf in leaves:
        dt = np.dtype(leaf.dtype)
        if dt.kind == "i":
            filled.append(rng.integers(-127, 128, leaf.shape).astype(dt))
        else:
            filled.append(rng.standard_normal(leaf.shape).astype(np.float32).astype(dt))
    je._kv = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in filled])
    tleaves = ttf.tree_leaves(te._kv)
    assert [tuple(x.shape) for x in tleaves] == [a.shape for a in filled]
    for x, a in zip(tleaves, filled):
        x.view(tht.raw_dtype(x.dtype)).copy_(torch.from_numpy(_np_bytes(a).view(
            {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])))
    src = [5, 9, 17, 3, 20, 21, 22, 23, 24, 25, 26]  # two chunks of 8, one padded
    dst = [27, 28, 2, 29, 30, 1, 11, 12, 13, 14, 15]
    W = je.cfg.swap_chunk_blocks
    assert W == te.cfg.swap_chunk_blocks == 8
    want = []
    for i in range(0, len(src), W):
        idx = np.zeros((W,), np.int32)
        chunk = src[i : i + W]
        idx[: len(chunk)] = chunk
        out = je._fetch_blocks_fn(W)(je._kv, jnp.asarray(idx))
        want.append([np.asarray(x)[: len(chunk)] for x in jax.tree_util.tree_leaves(out)])
    slots = te.host_tier.store.alloc(len(src))
    te._issue_fetch(src, slots)
    assert len(te._pending_swaps) == 1  # one fetch, two fixed-width chunks
    te._drain_swaps()
    got = te.host_tier.store.read(slots)
    for j, g in enumerate(got):
        w = np.concatenate([chunk[j] for chunk in want])
        assert g.shape == w.shape
        assert np.array_equal(_torch_bytes(g), _np_bytes(w))
    # restore: the port's pool must equal the JAX pool after its scatter
    for i in range(0, len(dst), W):
        chunk = dst[i : i + W]
        idx = np.zeros((W,), np.int32)
        idx[: len(chunk)] = chunk
        payload = []
        for j in range(len(filled)):
            rows = np.concatenate([c[j] for c in want])[i : i + W]
            pad = np.zeros((W - len(rows),) + rows.shape[1:], rows.dtype)
            payload.append(jnp.asarray(np.concatenate([rows, pad])))
        je._kv = je._restore_blocks_fn(W)(je._kv, jnp.asarray(idx), payload)
    te._restore(slots, dst)
    for x, a, f in zip(ttf.tree_leaves(te._kv), jax.tree_util.tree_leaves(je._kv), filled):
        mine, theirs = _torch_bytes(x), _np_bytes(a)
        # block 0 is the write-only trash block: padding lands there
        assert np.array_equal(mine[:, 1:], theirs[:, 1:])
        assert np.array_equal(mine[:, dst], _np_bytes(f)[:, src])


def test_store_bytes_are_the_configs_host_pool_bytes(served):
    _, tgen = served
    for kv_dtype in (None, "int8"):
        sv = TServingConfig(block_size=4, max_batch=2, host_pool_mib=4, kv_dtype=kv_dtype)
        engine = tgen.serve(serving=sv)
        store = engine.host_tier.store
        assert store.num_slots == sv.num_host_blocks(tgen.cfg, "float32")
        assert store.nbytes == sv.host_pool_bytes(tgen.cfg, "float32")
        assert not store.pin_memory  # pinning is for a CUDA device's engine


# ---------------------------------------------------------------------------
# engine: serving with the tier
# ---------------------------------------------------------------------------

PREEMPT = dict(block_size=4, max_batch=3, max_blocks=1 + 14, prefix_caching=False,
               decode_chunk=1)
COUNTERS = ("preemptions", "swaps_out", "swaps_in", "swap_out_bytes", "swap_in_bytes",
            "prefix_hits_host", "host_syncs", "tokens_generated", "mixed_steps")


def _prompts(seed, lens, vocab=TINY["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(n)).tolist() for n in lens]


def _serve(gen, trace, **knobs):
    engine = gen.serve(**knobs)
    for rid, p, n in trace:
        engine.add_request(rid, p, n)
    return engine.run()


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


@pytest.mark.parametrize("kv_dtype,chunk", [(None, 1), (None, 4), ("int8", 1)],
                         ids=["f32-k1", "f32-k4", "int8-k1"])
def test_tight_pool_swap_serve_matches_jax_and_recompute(served, kv_dtype, chunk):
    """The pool-starved trace resolved by swap: the JAX engine's streams
    and counters, and the streams of the port's recompute run."""
    jgen, tgen = served
    trace = [(f"p{i}", p, 10) for i, p in enumerate(_prompts(9, (9, 13, 11)))]
    knobs = dict(PREEMPT, decode_chunk=chunk, kv_dtype=kv_dtype, host_link_gbps=1000.0)
    jres, jstats = _serve(jgen, trace, host_pool_mib=64, **knobs)
    tres, tstats = _serve(tgen, trace, host_pool_mib=64, **knobs)
    rres, rstats = _serve(tgen, trace, host_pool_mib=0, **knobs)
    assert tres == jres == rres
    assert _counters(tstats) == _counters(jstats)
    assert tstats.swaps_out >= 1 and tstats.swaps_in == tstats.swaps_out
    assert tstats.swap_out_bytes == tstats.swap_in_bytes > 0
    assert rstats.preemptions >= 1 and rstats.swaps_out == 0


def test_spilled_prefix_chain_restores_as_a_host_hit(served):
    """A registers a prefix chain, B's footprint evicts it (a spill), C
    reuses the prefix: the hit restores from the host tier."""
    jgen, tgen = served
    rng = np.random.default_rng(6)
    shared = rng.integers(1, 128, 16).tolist()
    trace = [("a", shared + rng.integers(1, 128, 4).tolist(), 4),
             ("b", rng.integers(1, 128, 24).tolist(), 4),
             ("c", shared + rng.integers(1, 128, 4).tolist(), 4)]
    knobs = dict(block_size=4, max_batch=1, max_blocks=1 + 7, prefix_caching=True,
                 host_link_gbps=1000.0)
    jres, jstats = _serve(jgen, trace, host_pool_mib=64, **knobs)
    tres, tstats = _serve(tgen, trace, host_pool_mib=64, **knobs)
    plain, _ = _serve(tgen, trace, host_pool_mib=0, **knobs)
    assert tres == jres == plain
    assert _counters(tstats) == _counters(jstats)
    assert tstats.prefix_hits_host >= 1


def test_zero_bandwidth_link_falls_back_to_recompute(served):
    """The cost model declines every swap over a zero link: the engine
    preempts by recompute, as without a tier."""
    _, tgen = served
    trace = [(f"p{i}", p, 10) for i, p in enumerate(_prompts(9, (9, 13, 11)))]
    res, stats = _serve(tgen, trace, host_pool_mib=64, host_link_gbps=0.0, **PREEMPT)
    plain, pstats = _serve(tgen, trace, host_pool_mib=0, **PREEMPT)
    assert res == plain
    assert stats.preemptions == pstats.preemptions >= 1
    assert stats.swaps_out == stats.swaps_in == 0


# ---------------------------------------------------------------------------
# scheduler seam and the frontend's cancel
# ---------------------------------------------------------------------------


def _scheduler():
    pool = KVPool(num_blocks=17, block_size=4)
    return Scheduler(pool, max_batch=1, prefill_chunk=8, max_seq_length=128), pool


def test_scheduler_recompute_fallback_when_the_hook_declines():
    sched, _pool = _scheduler()
    sched.swap_out_hook = lambda seq: None  # the cost model said recompute
    sched.add(Request("r0", [1, 2, 3, 4, 5], 4))
    sched.admit()
    sched.running()[0].fed = 5
    assert sched.preempt_latest()
    assert sched.swaps_out == 0 and sched.swap_records == {}
    assert sched.admit()[0].needs_prefill  # recompute resumes re-prefill


def test_scheduler_drop_swap_record_releases_host_slots():
    sched, _pool = _scheduler()
    dropped = []
    record = tht.SwapRecord(slots=[3, 4], n_tokens=8, nbytes=10)
    sched.swap_out_hook = lambda seq: record
    sched.swap_drop_hook = dropped.append
    sched.add(Request("r0", list(range(1, 10)), 4))
    sched.admit()
    sched.running()[0].fed = 9
    sched.preempt_latest()
    sched.preempted.clear()
    sched.drop_swap_record("r0")
    assert dropped == [record] and sched.swap_records == {}
    sched.drop_swap_record("never-swapped")  # unknown rid: no-op
    assert dropped == [record]


def test_frontend_cancel_of_a_swapped_request_releases_its_host_slots(served):
    """A request preempted by swap and cancelled before it resumes: the
    frontend's cancel drops its record and the host slots come back."""
    from mdi_llm_tpu_torch.server import ServingFrontend

    _, tgen = served
    engine = tgen.serve(host_pool_mib=64, host_link_gbps=1000.0, **PREEMPT)
    front = ServingFrontend(engine, max_queue=8)
    handles = [front.submit(p, 10, rid=f"p{i}")
               for i, p in enumerate(_prompts(9, (9, 13, 11)))]
    front._drain_channel()
    while not engine.scheduler.swap_records:
        assert engine.step(), "the trace was sized to swap"
    rid, record = next(iter(engine.scheduler.swap_records.items()))
    store = engine.host_tier.store
    held = store.used
    assert held >= len(record.slots) > 0
    front.cancel(rid)
    front._apply_cancels()
    assert rid not in engine.scheduler.swap_records
    assert store.used == held - len(record.slots)
    cancelled = [h for h in handles if h.rid == rid][0]
    assert cancelled.cancelled
    engine.run()
    assert store.used == 0


# ---------------------------------------------------------------------------
# observer and CLI
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _tier_hooks(obs):
    obs.request_submitted("x", 9, 6)
    obs.request_admitted("x", 0, 0)
    obs.tier_swap_out(3, 3 * 1536)
    obs.request_preempted("x", 2, swapped=True)
    for ms in (0.02, 0.3, 0.3, 7.0, 2000.0):
        obs.tier_swap_in(2, 3072)
        obs.restore_wait(ms / 1e3)
    obs.request_admitted("x", 0, 1, resumed=True, restored=True)
    obs.tokens("x", 4)
    obs.request_finished("x")


def test_tier_hooks_give_the_jax_observers_metrics_and_trace():
    jobs, tobs = JObserver(clock=FakeClock()), TObserver(clock=FakeClock())
    _tier_hooks(jobs)
    _tier_hooks(tobs)
    jm, tm = jobs.metrics_dict(), tobs.metrics_dict()
    for name in ("serving_swap_out_bytes_total", "serving_swap_out_blocks_total",
                 "serving_swap_in_bytes_total", "serving_swap_in_blocks_total",
                 "serving_preemptions_swapped_total", "serving_requests_restored_total"):
        assert tm["metrics"]["counters"][name] == jm["metrics"]["counters"][name]
    assert tm["metrics"]["counters"]["serving_swap_in_blocks_total"] == 10
    hist = "serving_restore_wait_ms"
    assert tm["metrics"]["histograms"][hist] == jm["metrics"]["histograms"][hist]
    assert tobs.metrics.render_prometheus() == jobs.metrics.render_prometheus()
    assert tobs.tracer.to_chrome_trace() == jobs.tracer.to_chrome_trace()


def test_live_engine_feeds_the_tier_counters_like_jax(served):
    jgen, tgen = served
    trace = [(f"p{i}", p, 10) for i, p in enumerate(_prompts(9, (9, 13, 11)))]
    out = []
    for gen, obs in ((jgen, JObserver()), (tgen, TObserver())):
        engine = gen.serve(host_pool_mib=64, host_link_gbps=1000.0, obs=obs, **PREEMPT)
        for rid, p, n in trace:
            engine.add_request(rid, p, n)
        _res, stats = engine.run()
        counters = obs.metrics_dict()["metrics"]["counters"]
        out.append(({k: v for k, v in counters.items() if "swap" in k or "restored" in k},
                    obs.metrics.histogram("serving_restore_wait_ms").count, stats))
    (jc, jn, jstats), (tc, tn, tstats) = out
    assert tc == jc and tc["serving_swap_out_bytes_total"] == tstats.swap_out_bytes > 0
    assert tn == jn == tstats.swaps_in
    assert tstats.restore_issue_s > 0


CPU_RUN = ["--device", "cpu", "--model", "pythia-14m", "--synthetic", "6", "--max-batch", "4",
           "--n-tokens", "48", "--sequence-length", "128", "--block-size", "8",
           "--max-blocks", "12", "--no-device-obs"]


def test_serve_cli_takes_the_tier_flags(capsys):
    line = serve_cli.main([*CPU_RUN, "--host-pool-mib", "16", "--host-link-gbps", "1000"])
    err = capsys.readouterr().err
    assert "cli.serve: host KV tier" in err and "MiB host RAM" in err
    assert line["preemptions"] >= 1 and line["swaps_out"] >= 1
    assert line["swaps_in"] == line["swaps_out"]
    assert line["swap_out_bytes"] == line["swap_in_bytes"] > 0
    recompute = serve_cli.main(CPU_RUN)
    assert recompute["swaps_out"] == 0 and recompute["preemptions"] >= 1
    assert recompute["tokens_generated"] == line["tokens_generated"]
    for key in ("swaps_out", "swaps_in", "swap_out_bytes", "swap_in_bytes",
                "prefix_hits_host", "restore_issue_s"):
        assert key in line and key in recompute
    json.dumps(line)


def test_serve_cli_tier_follows_the_prefix_cache_flag():
    args = serve_cli.build_parser().parse_args(
        [*CPU_RUN, "--host-pool-mib", "8", "--no-prefix-cache"])
    sv = serve_cli.make_serving_config(args)
    assert sv.host_pool_mib == 8 and not sv.host_prefix_spill and not sv.prefix_caching
    args = serve_cli.build_parser().parse_args([*CPU_RUN, "--host-link-gbps", "2.5"])
    sv = serve_cli.make_serving_config(args)
    assert sv.host_prefix_spill and sv.resolved_host_link_gbps("cpu") == 2.5
    assert JServingConfig(host_link_gbps=2.5).resolved_host_link_gbps("cpu") == 2.5
