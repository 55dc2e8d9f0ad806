"""The port's serving engine over int8 and float8 pools against the JAX
engine, on the CPU (the patterns of tests/test_quantized_serving.py).

Greedy streams of the port's `ServingEngine` with `kv_dtype="int8"`,
`"float8"` (e4m3) and `"float8_e5m2"` must equal the JAX engine's token
for token, on the same float32 weights and the same trace: per-token
decode, chunked decode with and without double buffering, a prefix-cache
hit and a preemption on a tight pool.  Both engines quantize the same
K/V with the same arithmetic and run attention on the same dequantized
values; their float32 products differ in the last bits, which moves an
int8 byte only at a rounding tie and a token only at a near-tie of the
logits, neither of which these traces contain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.serving.engine import pool_bytes

torch.set_num_threads(1)

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)
BASE = dict(block_size=4, max_batch=3, prefill_chunk=8)


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
        out.append((*engine.run(), engine))
    return out


TRACE = [(f"r{i}", p, m) for i, (p, m) in
         enumerate(zip(_prompts(5, (3, 9, 17, 5, 33)), (8, 12, 6, 10, 7)))]


@pytest.mark.parametrize("chunk,buffered", [(1, False), (4, True), (4, False)],
                         ids=["k1", "k4-buffered", "k4-nobuf"])
@pytest.mark.parametrize("kv_dtype", ["int8", "float8", "float8_e5m2"])
def test_narrow_pool_streams_match_jax_engine(served, kv_dtype, chunk, buffered):
    (jres, jstats, jeng), (tres, tstats, teng) = _run_both(
        served, TRACE, kv_dtype=kv_dtype, decode_chunk=chunk, double_buffer=buffered,
        **BASE)
    assert tres == jres
    assert teng.kv_dtype_name == jeng.kv_dtype_name == kv_dtype
    assert tstats.requests_finished == jstats.requests_finished == len(TRACE)
    assert tstats.host_syncs == jstats.host_syncs
    assert teng.pool.used == 0  # every retirement released its blocks
    assert pool_bytes(teng._kv) == sum(int(x.nbytes) for x in jax.tree_util.tree_leaves(jeng._kv))


@pytest.mark.parametrize("kv_dtype", ["int8", "float8"])
def test_narrow_pool_prefix_hit_matches_jax_engine(served, kv_dtype):
    head = _prompts(7, (21,))[0]
    outs = []
    for gen in served:
        engine = gen.serve(block_size=4, max_batch=2, prefill_chunk=8, decode_chunk=4,
                           kv_dtype=kv_dtype)
        engine.add_request("first", head, 6)
        engine.run()
        engine.add_request("second", head + [7, 8], 6)
        outs.append(engine.run())
    (jres, jstats), (tres, tstats) = outs
    assert tres == jres
    assert tstats.prefix_cache_hits == jstats.prefix_cache_hits >= 5


@pytest.mark.parametrize("kv_dtype", ["int8", "float8"])
def test_narrow_pool_preemption_matches_jax_engine(served, kv_dtype):
    trace = [(f"p{i}", p, 10) for i, p in enumerate(_prompts(9, (9, 13, 11)))]
    (jres, jstats, _), (tres, tstats, teng) = _run_both(
        served, trace, kv_dtype=kv_dtype, max_blocks=1 + 10, prefix_caching=False,
        decode_chunk=4, double_buffer=True, **BASE)
    assert tres == jres
    assert tstats.preemptions == jstats.preemptions >= 1
    assert teng.pool.used == 0


def test_int8_pool_layout_and_name(served):
    engine = served[1].serve(kv_dtype="int8", **BASE)
    L, NB = TINY["n_layer"], engine.pool.num_blocks
    for side in ("k", "v"):
        assert engine._kv[side]["q"].shape == (L, NB, 4, 2, 8)
        assert engine._kv[side]["q"].dtype == torch.int8
        assert engine._kv[side]["scale"].shape == (L, NB, 2)
    assert engine.kv_dtype_name == "int8"
    fp = served[1].serve(**BASE)
    assert fp.kv_dtype_name == "float32" and fp._kv["k"].dtype == torch.float32
