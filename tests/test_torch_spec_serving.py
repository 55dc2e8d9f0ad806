"""Speculative serving in the port against the JAX package, on the CPU
(the patterns of tests/test_serving.py's speculative tests).

- `ops/sampling.speculative_verify`: the greedy rule gives JAX's output on
  the same logits; the rejection-sampled rule emits, at every position it
  reaches, tokens distributed as the filtered softmax the per-step sampler
  draws from (the reference's 5-sigma per-position frequency test; the
  draws come from a `torch.Generator`, not JAX's threefry, so the check is
  by distribution).
- Engine streams with `spec_k` (n-gram drafts, exact-match verify) equal
  the JAX engine's and the port's own streams without `spec_k`, token for
  token; so do streams with a draft model handed to both packages as
  `draft_gen` (the same converted weights), greedy and sampled at
  `top_k=1` (one-hot distributions), with the same drafted counts; and
  the verify over an int8 pool.
- `prime` writes only into the trash blocks: every live block of both
  pools is byte-unchanged.
- No draw comes from the global torch generator.
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
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)
DRAFT = {**TINY, "name": "test-tiny-draft", "n_layer": 1}


def _pair(cfg, seed):
    jc, tc = JConfig(**cfg), TConfig(**cfg)
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return (JGenerator(jc, jp, cache_dtype=jnp.float32),
            TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def served():
    return _pair(TINY, 0)


@pytest.fixture(scope="module")
def drafts():
    return _pair(DRAFT, 1)


def _cycling_prompts(seeds):
    """Prompts whose greedy continuation echoes earlier context (the tiny
    random model falls into cycles), so n-gram drafting fires."""
    return [np.random.default_rng(s).integers(1, TINY["vocab_size"], 5).tolist()
            for s in seeds]


def _run(gen, prompts, max_news, **knobs):
    engine = gen.serve(**knobs)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        engine.add_request(f"r{i}", p, m)
    results, stats = engine.run()
    return results, stats, engine


# ---------------------------------------------------------------------------
# speculative_verify
# ---------------------------------------------------------------------------


def test_speculative_verify_greedy_matches_jax():
    rng = np.random.default_rng(0)
    B, K, V = 3, 4, 16
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    g = np.argmax(logits, axis=-1)
    draft = np.stack([g[0, :K], np.r_[g[1, :2], (g[1, 2] + 1) % V, g[1, 3]],
                      (g[2, :K] + 1) % V]).astype(np.int32)
    dlen = np.array([4, 4, 2], np.int32)
    jt, jp = jsampling.sampling_operands(0.0, None)
    jout, jn = jsampling.speculative_verify(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(dlen),
        jax.random.PRNGKey(0), jt, jp, mode="greedy")
    tt, tp = tsampling.sampling_operands(0.0, None)
    tout, tn = tsampling.speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(draft), torch.from_numpy(dlen),
        torch.Generator().manual_seed(0), tt, tp, mode="greedy")
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert list(tn) == [5, 3, 1]
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("mode,top_k,top_p", [
    ("top_k", None, None), ("top_k", 4, None), ("top_p", None, 0.9),
], ids=["temperature", "top_k", "top_p"])
def test_speculative_verify_preserves_distribution(mode, top_k, top_p):
    """At every position the verify reaches, the emitted token is a draw
    from the filtered softmax: |freq - p| < 5 sigma + 1e-3 per token over
    N = 10000 independent rows, and filtered-out tokens never appear."""
    rng = np.random.default_rng(42)
    K, V, N = 2, 8, 10000
    logits = torch.from_numpy(rng.normal(size=(1, K + 1, V)).astype(np.float32) * 1.5)
    draft = torch.argmax(logits[:, :K], dim=-1).int()  # reach later positions often
    t_op, p_op = tsampling.sampling_operands(0.7, top_p)
    out, n_emit = tsampling.speculative_verify(
        logits.expand(N, -1, -1), draft.expand(N, -1), torch.full((N,), K),
        torch.Generator().manual_seed(7), t_op, p_op, mode=mode, top_k=top_k)
    f = tsampling.filtered_logits(logits, t_op, p_op, mode=mode, top_k=top_k)[0]
    p = torch.softmax(f, dim=-1).numpy()
    # the port's filter is the JAX package's
    jf = jsampling.filtered_logits(jnp.asarray(logits.numpy()), *jsampling.sampling_operands(
        0.7, top_p), mode=mode, top_k=top_k)[0]
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-6)
    out, n_emit = out.numpy(), n_emit.numpy()
    for j in range(K + 1):
        reach = n_emit > j
        n_j = int(reach.sum())
        assert n_j > N // 20, f"position {j} starved ({n_j} trials)"
        freq = np.bincount(out[reach, j], minlength=V) / n_j
        se = np.sqrt(p[j] * (1.0 - p[j]) / n_j)
        assert np.all(np.abs(freq - p[j]) < 5.0 * se + 1e-3), (j, freq, p[j])
        assert np.all(freq[p[j] == 0.0] == 0.0)


# ---------------------------------------------------------------------------
# engine streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_k,chunk", [(4, 1), (4, 4), (8, 8)])
def test_spec_streams_match_jax_and_plain_decode(served, spec_k, chunk):
    prompts = _cycling_prompts((5, 7, 0))
    max_news = [40, 35, 30]
    knobs = dict(block_size=4, max_batch=3, decode_chunk=chunk)
    want, _, _ = _run(served[1], prompts, max_news, **knobs)
    jres, jstats, _ = _run(served[0], prompts, max_news, spec_k=spec_k, **knobs)
    tres, tstats, engine = _run(served[1], prompts, max_news, spec_k=spec_k, **knobs)
    assert tres == jres == want
    assert tstats.spec_drafted == jstats.spec_drafted > 0, "the trace was built to draft"
    assert tstats.spec_accepted == jstats.spec_accepted > 0
    assert tstats.host_syncs == jstats.host_syncs
    assert engine.pool.used == 0


def test_spec_mixed_batch_with_non_drafting_slot(served):
    """A slot whose context never echoes rides the same ragged verify with
    one valid token while its neighbour verifies K+1."""
    rng = np.random.default_rng(11)
    prompts = _cycling_prompts((5,)) + [rng.integers(1, TINY["vocab_size"], 23).tolist()]
    max_news = [30, 12]
    knobs = dict(block_size=4, max_batch=2, decode_chunk=4)
    want, _, _ = _run(served[1], prompts, max_news, **knobs)
    jres, _, _ = _run(served[0], prompts, max_news, spec_k=4, **knobs)
    tres, tstats, _ = _run(served[1], prompts, max_news, spec_k=4, **knobs)
    assert tres == jres == want
    assert tstats.spec_drafted > 0


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.7, top_k=1)],
                         ids=["greedy", "sampled-top1"])
def test_draft_model_streams_match_jax(served, drafts, sampling):
    """The same draft weights in both packages (`draft_gen`): token-
    identical streams (at top_k=1 every filtered distribution is one-hot,
    so the sampled verify is deterministic), the same split of drafted
    counts by source, and both pools drained."""
    prompts = _cycling_prompts((5, 7, 0))
    max_news = [24, 20, 16]
    knobs = dict(block_size=4, max_batch=3, decode_chunk=4, spec_k=4,
                 draft_model="test-tiny-draft", **sampling)
    out = [_run(gen, prompts, max_news, draft_gen=dgen, **knobs)
           for gen, dgen in zip(served, drafts)]
    (jres, jstats, _), (tres, tstats, engine) = out
    assert engine.cfg.spec_verify_sampled() == bool(sampling)
    assert tres == jres
    want, _, _ = _run(served[1], prompts, max_news, block_size=4, max_batch=3, decode_chunk=4)
    assert tres == want
    assert tstats.spec_drafted_model == jstats.spec_drafted_model > 0
    assert tstats.spec_drafted_ngram == jstats.spec_drafted_ngram
    assert tstats.spec_accepted == jstats.spec_accepted
    assert engine.pool.used == 0 and engine.draft_pool.used == 0
    assert engine.draft_forward_calls > 0


def test_int8_spec_streams_match_jax(served):
    """The ragged verify over the quantized pool: the port's streams equal
    the JAX engine's with spec_k over int8 blocks."""
    prompts = _cycling_prompts((5, 7))
    max_news = [40, 35]
    knobs = dict(block_size=4, max_batch=2, prefill_chunk=8, kv_dtype="int8", spec_k=4)
    jres, jstats, _ = _run(served[0], prompts, max_news, **knobs)
    tres, tstats, _ = _run(served[1], prompts, max_news, **knobs)
    assert tres == jres
    assert tstats.spec_drafted == jstats.spec_drafted > 0


def test_sampled_spec_draws_only_from_the_engine_generator(served, drafts):
    """temperature > 0 over an int8 pool with a draft model: the sampled
    verify runs, tokens stay in the vocabulary, and the global torch
    generator is untouched (every draw comes from the engine's own)."""
    state = torch.random.get_rng_state()
    prompts = _cycling_prompts((5, 7))
    res, stats, _ = _run(served[1], prompts, [12, 12], block_size=4, max_batch=2,
                         kv_dtype="int8", spec_k=3, temperature=0.8,
                         draft_model="test-tiny-draft", draft_gen=drafts[1])
    assert torch.equal(torch.random.get_rng_state(), state)
    assert stats.spec_drafted > 0 and stats.requests_finished == 2
    for i, p in enumerate(prompts):
        assert all(0 <= t < TINY["vocab_size"] for t in res[f"r{i}"][len(p):])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prime_leaves_live_blocks_unchanged(served, drafts, kv_dtype):
    """Mid-run, `prime` (an inert verify, a draft scan and a draft mixed
    step on all-zero tables) changes no byte of any block but the trash
    block 0, in the target pool or the draft pool."""
    engine = served[1].serve(block_size=4, max_batch=2, spec_k=3, kv_dtype=kv_dtype,
                             draft_model="test-tiny-draft", draft_gen=drafts[1])
    for i, p in enumerate(_cycling_prompts((5, 7))):
        engine.add_request(f"r{i}", p, 20)
    for _ in range(4):
        engine.step()
    leaves = lambda kv: [x for side in ("k", "v") for x in  # noqa: E731
                         (kv[side].values() if isinstance(kv[side], dict) else [kv[side]])]
    before = [x.clone() for x in leaves(engine._kv) + leaves(engine._draft_kv)]
    assert any(x[:, 1:].any() for x in before), "the run wrote live blocks"
    calls = engine.forward_calls, engine.draft_forward_calls
    engine.prime()
    after = leaves(engine._kv) + leaves(engine._draft_kv)
    for a, b in zip(after, before):
        assert torch.equal(a[:, 1:], b[:, 1:])
    # one verify; one draft scan of spec_k forwards and one draft mixed step
    assert (engine.forward_calls - calls[0], engine.draft_forward_calls - calls[1]) == (1, 4)
    results, _ = engine.run()
    assert len(results) == 2
