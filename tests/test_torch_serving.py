"""The port's serving stack against the JAX package's, on the CPU.

- The host-only copies (`kv_pool`, `policy`, `scheduler`): a scripted
  engine loop drives the port's scheduler and the JAX package's side by
  side — arrivals mid-run, shared prompt heads, preemption on a tight
  pool, every policy — and their decisions must be identical, step by
  step.  A few direct cases come from tests/test_serving.py.
- The engine: greedy streams of the port's `ServingEngine` must equal the
  JAX `ServingEngine`'s token for token, on the same float32 weights and
  the same mixed-length trace: per-token decode, chunked decode with and
  without double buffering, a token budget smaller than a prompt, a
  prefix-cache hit and a preemption on a tight pool.
- Every ServingConfig knob the port does not carry raises, and the
  combinations the JAX engine refuses raise with the JAX engine's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.serving import kv_pool as j_kv_pool
from mdi_llm_tpu.serving import policy as j_policy
from mdi_llm_tpu.serving import scheduler as j_scheduler
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.serving import kv_pool as t_kv_pool
from mdi_llm_tpu_torch.serving import policy as t_policy
from mdi_llm_tpu_torch.serving import scheduler as t_scheduler

torch.set_num_threads(1)

JAX_MODULES = (j_kv_pool, j_scheduler, j_policy)
PORT_MODULES = (t_kv_pool, t_scheduler, t_policy)


# ---------------------------------------------------------------------------
# host-only copies
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(modules, policy, num_blocks, seed=0, steps=200):
    """Drive a scheduler through a scripted engine loop; returns every
    decision it made plus its final counters."""
    kv_pool, scheduler, policy_mod = modules
    clock = FakeClock()
    pool = kv_pool.KVPool(num_blocks, 4, prefix_caching=True)
    sched = scheduler.Scheduler(pool, 3, 6, 64,
                                policy=policy_mod.make_policy(policy, clock))
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 90, 9).tolist()
    pending = []
    for i in range(10):
        prompt = (head if i % 3 == 0 else []) + rng.integers(1, 90, int(rng.integers(2, 14))).tolist()
        pending.append(scheduler.Request(
            f"r{i}", prompt, int(rng.integers(3, 12)), priority=int(rng.integers(0, 3)),
            tenant=f"t{i % 2}", ttft_slo_s=float(rng.uniform(0.5, 4.0)),
        ))
    log = []

    def emit(seq):
        tok = (len(seq.tokens) * 7 + 3) % 50 + 1
        seq.tokens.append(tok)
        seq.next_tok = tok
        if len(seq.generated()) >= seq.req.max_new_tokens or len(seq.tokens) >= 64:
            sched.retire(seq)

    for step in range(steps):
        clock.t += 0.25
        if pending and step % 2 == 0:
            sched.add(pending.pop(0))
        action = sched.next_batch(token_budget=10)
        if action is None:
            if not pending:
                break
            continue
        kind, items = action
        entries = items if kind == "mixed" else [(s, 1) for s in items]
        live = [(s, n) for s, n in entries
                if sched.slots[s.slot] is s and sched.ensure_blocks_for(s, n)]
        live = [(s, n) for s, n in live if sched.slots[s.slot] is s]
        log.append((kind, [(s.req.rid, n, s.fed) for s, n in live]))
        for seq, n in live:
            if seq.needs_prefill:
                seq.fed += n
                if seq.fed >= seq.prefill_target:
                    pool.register_prefix(seq.blocks, seq.req.prompt[: seq.fed])
                    if seq.resume_tok is not None:
                        seq.next_tok = seq.resume_tok
                    else:
                        emit(seq)
            else:
                seq.fed += 1
                emit(seq)
    return log, sched.preemptions, pool.prefix_hits, pool.used


@pytest.mark.parametrize("num_blocks", [64, 14], ids=["roomy", "tight"])
@pytest.mark.parametrize("policy", ["fcfs", "priority", "fair", "deadline"])
def test_scheduler_copy_decides_like_the_jax_package(policy, num_blocks):
    port = _script(PORT_MODULES, policy, num_blocks)
    ref = _script(JAX_MODULES, policy, num_blocks)
    assert port == ref
    assert port[0], "the script ran"
    if num_blocks == 14 and policy == "fcfs":
        assert port[1] > 0, "the tight pool preempts"


def test_pool_alloc_free_and_prefix_reuse():
    pool = t_kv_pool.KVPool(num_blocks=17, block_size=4)
    assert pool.available == 16  # block 0 is the reserved trash block
    prompt = list(range(100, 111))
    blocks = pool.alloc(pool.blocks_needed(len(prompt)))
    assert 0 not in blocks
    pool.register_prefix(blocks, prompt)
    m, n_cached = pool.match_prefix(prompt)
    assert m == blocks[:2] and n_cached == 8 and pool.prefix_hits == 2
    with pytest.raises(ValueError):
        t_kv_pool.KVPool(1, 4)


def test_scheduler_token_budget_composition():
    """Decode lanes pack first, then prefill chunks split to fit."""
    pool = t_kv_pool.KVPool(33, 4)
    sched = t_scheduler.Scheduler(pool, 2, 32, 64)
    sched.add(t_scheduler.Request("a", [1, 2, 3], 8))
    kind, entries = sched.next_batch(token_budget=10)
    assert kind == "mixed" and [n for _, n in entries] == [3]
    seq = entries[0][0]
    seq.fed, seq.next_tok = 3, 7
    seq.tokens.append(7)
    sched.add(t_scheduler.Request("b", [1] * 20, 4))
    kind, entries = sched.next_batch(token_budget=10)
    assert [(s.req.rid, n) for s, n in entries] == [("a", 1), ("b", 9)]


def test_policy_registry_matches():
    assert sorted(t_policy.POLICIES) == sorted(j_policy.POLICIES)


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

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
    jgen = JGenerator(jc, jp, cache_dtype=jnp.float32)  # one jit cache
    tgen = TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu")
    return jgen, tgen


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], int(n)).tolist() for n in lens]


def _run_both(served, trace, **knobs):
    out = []
    for gen in served:
        engine = gen.serve(**knobs)
        for rid, prompt, new in trace:
            engine.add_request(rid, prompt, new)
        out.append(engine.run())
    (jres, jstats), (tres, tstats) = out
    return jres, tres, jstats, tstats


BASE = dict(block_size=4, max_batch=3, prefill_chunk=8)


@pytest.mark.parametrize("chunk,buffered", [(1, False), (4, True), (4, False)],
                         ids=["k1", "k4-buffered", "k4-nobuf"])
def test_engine_streams_match_jax_engine(served, chunk, buffered):
    prompts = _prompts(5, (3, 9, 17, 5, 33))
    trace = [(f"r{i}", p, m) for i, (p, m) in enumerate(zip(prompts, (8, 12, 6, 10, 7)))]
    jres, tres, jstats, tstats = _run_both(
        served, trace, decode_chunk=chunk, double_buffer=buffered, **BASE)
    assert tres == jres
    assert tstats.requests_finished == jstats.requests_finished == len(trace)
    assert tstats.mixed_steps == jstats.mixed_steps
    assert tstats.host_syncs == jstats.host_syncs
    assert tstats.tokens_generated == jstats.tokens_generated


def test_engine_budget_smaller_than_prompt(served):
    prompts = _prompts(13, (41, 5))
    trace = [("r0", prompts[0], 6), ("r1", prompts[1], 10)]
    jres, tres, jstats, tstats = _run_both(
        served, trace, block_size=4, max_batch=2, prefill_chunk=64,
        token_budget=12, decode_chunk=4)
    assert tres == jres
    assert tstats.mixed_steps == jstats.mixed_steps >= 4


def test_engine_prefix_cache_hit(served):
    head = _prompts(7, (21,))[0]
    outs = []
    for gen in served:
        engine = gen.serve(block_size=4, max_batch=2, prefill_chunk=8, decode_chunk=4)
        engine.add_request("first", head, 6)
        engine.run()
        engine.add_request("second", head + [7, 8], 6)
        outs.append(engine.run())
    (jres, jstats), (tres, tstats) = outs
    assert tres == jres
    assert tstats.prefix_cache_hits == jstats.prefix_cache_hits >= 5


def test_engine_preemption_on_tight_pool(served):
    prompts = _prompts(9, (9, 13, 11))
    trace = [(f"p{i}", p, 10) for i, p in enumerate(prompts)]
    jres, tres, jstats, tstats = _run_both(
        served, trace, max_blocks=1 + 10, prefix_caching=False,
        decode_chunk=4, double_buffer=True, **BASE)
    assert tres == jres
    assert tstats.preemptions == jstats.preemptions >= 1


@pytest.mark.parametrize("knobs", [
    dict(host_pool_mib=64), dict(draft_model="pythia-14m"),
    dict(spec_k=2, spec_sampled=False, temperature=0.8), dict(spec_k=-1),
    dict(kv_dtype="int9"), dict(kv_dtype="int32"),
], ids=["host_pool_mib", "draft_without_spec_k", "exact_verify_sampling", "spec_k_negative",
        "unknown_kv_dtype", "non_storage_kv_dtype"])
def test_unported_knobs_raise(served, knobs):
    """The host tier is not ported; every other case is a refusal of the
    JAX engine, which the port makes with the same message."""
    if "host_pool_mib" in knobs:
        with pytest.raises(ValueError, match="not ported"):
            served[1].serve(**knobs)
        return
    with pytest.raises(ValueError) as want:
        served[0].serve(**knobs)
    with pytest.raises(ValueError) as got:
        served[1].serve(**knobs)
    assert str(got.value) == str(want.value)


def test_engine_refuses_tight_token_budget(served):
    with pytest.raises(ValueError, match="token_budget"):
        served[1].serve(max_batch=4, token_budget=4)


def test_generator_raises_without_cuda_by_default():
    """Entry points default to the GPU and never fall back by themselves."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    tc = TConfig(**TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        TGenerator(tc, {}, cache_dtype=torch.float32)


def test_tiny_config_fields_match():
    assert dataclasses.asdict(TConfig(**TINY)) == dataclasses.asdict(JConfig(**TINY))
