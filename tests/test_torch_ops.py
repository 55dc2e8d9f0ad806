"""The port's plain tensor ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both functions.
Tolerances: norms, rope and attention in float32 agree within atol 1e-5
(the two frameworks sum in different orders); greedy argmax is identical;
filtered sampling probabilities agree within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.ops import attention as jatt
from mdi_llm_tpu.ops import norms as jnorms
from mdi_llm_tpu.ops import rope as jrope
from mdi_llm_tpu.ops import sampling as jsamp
from mdi_llm_tpu_torch.ops import attention as tatt
from mdi_llm_tpu_torch.ops import norms as tnorms
from mdi_llm_tpu_torch.ops import rope as trope
from mdi_llm_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)
ATOL = 1e-5


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt) = _pair(rng.standard_normal((3, 5, 64)).astype(np.float32)), \
        _pair(rng.standard_normal(64).astype(np.float32))
    _close(jnorms.rms_norm(xj, wj, 1e-5, unit_offset),
           tnorms.rms_norm(xt, wt, 1e-5, unit_offset))


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm(with_bias):
    rng = np.random.default_rng(1)
    (xj, xt) = _pair(rng.standard_normal((2, 7, 48)).astype(np.float32) * 3 + 1)
    (wj, wt) = _pair(rng.standard_normal(48).astype(np.float32))
    (bj, bt) = _pair(rng.standard_normal(48).astype(np.float32))
    _close(jnorms.layer_norm(xj, wj, bj if with_bias else None),
           tnorms.layer_norm(xt, wt, bt if with_bias else None))


@pytest.mark.parametrize("n_elem,base,ratio", [(8, 10000, 1), (64, 10000, 1), (16, 500000, 4)])
def test_rope_cache_and_apply(n_elem, base, ratio):
    cj, sj = jrope.build_rope_cache(64, n_elem, base, ratio)
    ct, st = trope.build_rope_cache(64, n_elem, base, ratio)
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(sj, st)
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 4, 10, n_elem)).astype(np.float32))
    pos = rng.integers(0, 64, (2, 10))
    cos_j, sin_j = jrope.gather_rope(jnp.asarray(cj), jnp.asarray(sj), jnp.asarray(pos))
    cos_t, sin_t = trope.gather_rope(torch.from_numpy(ct), torch.from_numpy(st),
                                     torch.from_numpy(pos))
    _close(jrope.apply_rope(xj, cos_j[:, None], sin_j[:, None]),
           trope.apply_rope(xt, cos_t[:, None], sin_t[:, None]))


def test_gather_rope_clamps_out_of_range_positions():
    """Padding tokens carry positions past the table: the port clamps,
    matching the JAX forward's `jnp.take(..., mode="clip")`."""
    cos, sin = trope.build_rope_cache(32, 8)
    pos = np.array([0, 5, 31, 32, 100, -3])
    ct, st = trope.gather_rope(torch.from_numpy(cos), torch.from_numpy(sin),
                               torch.from_numpy(pos))
    want_c = jnp.take(jnp.asarray(cos), jnp.asarray(pos), axis=0, mode="clip")
    want_s = jnp.take(jnp.asarray(sin), jnp.asarray(pos), axis=0, mode="clip")
    _close(want_c, ct, 0)
    _close(want_s, st, 0)


@pytest.mark.parametrize("heads", [(8, 8), (8, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("variant", ["cache", "valid_len", "k_pos"])
def test_multihead_attention(heads, variant):
    H, G = heads
    B, Tq, Tk, hs = 2, 5, 24, 16
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng.standard_normal((B, H, Tq, hs)).astype(np.float32))
    kj, kt = _pair(rng.standard_normal((B, G, Tk, hs)).astype(np.float32))
    vj, vt = _pair(rng.standard_normal((B, G, Tk, hs)).astype(np.float32))
    pj, pt = _pair(np.array([np.arange(7, 7 + Tq), np.arange(14, 14 + Tq)]))
    kw_j, kw_t = {}, {}
    if variant == "valid_len":
        kw_j["kv_valid_len"], kw_t["kv_valid_len"] = _pair(np.array([10, 19]))
    if variant == "k_pos":
        kp = np.tile(np.arange(3, 3 + Tk), (B, 1))
        kw_j["k_pos"], kw_t["k_pos"] = _pair(kp)
    _close(jatt.multihead_attention(qj, kj, vj, pj, **kw_j),
           tatt.multihead_attention(qt, kt, vt, pt, **kw_t))
    assert tatt.NEG_INF == jatt.NEG_INF


def _logits(seed=4, shape=(6, 97)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3


def test_greedy_argmax_identical():
    lj, lt = _pair(_logits())
    key = jax.random.PRNGKey(0)
    tj, pj = jsamp.sampling_operands(0.0, None)
    tt, pt = tsamp.sampling_operands(0.0, None)
    a = jsamp.sample_traced(lj, key, tj, pj, mode="greedy")
    b = tsamp.sample_traced(lt, None, tt, pt, mode="greedy")
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, None, None), (1.3, 5, None), (0.8, None, 0.9), (1.0, None, 0.3), (0.5, 1, None),
])
def test_filtered_probabilities_agree(temperature, top_k, top_p):
    lj, lt = _pair(_logits(seed=5))
    mode = tsamp.sample_mode(temperature, top_k, top_p)
    assert mode == jsamp.sample_mode(temperature, top_k, top_p)
    tj, pj = jsamp.sampling_operands(temperature, top_p)
    tt, pt = tsamp.sampling_operands(temperature, top_p)
    fj = jsamp.filtered_logits(lj, tj, pj, mode=mode, top_k=top_k)
    ft = tsamp.filtered_logits(lt, tt, pt, mode=mode, top_k=top_k)
    _close(jax.nn.softmax(fj, axis=-1), torch.softmax(ft, dim=-1), 1e-6)
    _close(jsamp.logits_to_probs(lj, temperature, top_k),
           tsamp.logits_to_probs(lt, temperature, top_k), 1e-6)


def test_sampled_draws_stay_in_the_filtered_support():
    """Draws cannot match JAX's draw for draw; each draw must be a token
    the filter kept, and top_k=1 must be greedy."""
    lt = torch.from_numpy(_logits(seed=6, shape=(64, 50)))
    gen = torch.Generator().manual_seed(0)
    t, p = tsamp.sampling_operands(0.9, None)
    draws = tsamp.sample_traced(lt, gen, t, p, mode="top_k", top_k=3)
    top3 = torch.topk(lt, 3, dim=-1).indices
    assert bool((top3 == draws[:, None]).any(dim=-1).all())
    one = tsamp.sample_traced(lt, gen, t, p, mode="top_k", top_k=1)
    np.testing.assert_array_equal(one.numpy(), lt.argmax(-1).numpy())
