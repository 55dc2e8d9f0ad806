"""The port's paged transformer forward against the JAX package's, on the
CPU, in float32.

JAX `init_params` weights go through `params_from_numpy` into the port;
both run the same serving steps over fresh pools: two unified mixed
ragged steps (prefill chunks, a decode lane, padding rows past every table)
and a batched decode step.  Logits of every real row must agree within
atol 1e-4 (float32, different summation orders), and the pools the steps
wrote must agree too.  Models: pythia-14m (MHA, LayerNorm, parallel
residual, partial rope) and tiny-llama-1.1b narrowed to 2 layers x 256
(GQA with head size 64, as in the full model)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.models import transformer as ttf

torch.set_num_threads(1)
ATOL = 1e-4
TINY = dict(n_layer=2, n_embd=256, n_head=4, n_query_groups=2,
            intermediate_size=512, vocab_size=512)
MODELS = {"pythia-14m": {}, "tiny-llama-1.1b": TINY}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name = request.param
    jc = JConfig.from_name(name, **MODELS[name])
    tc = TConfig.from_name(name, **MODELS[name])
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jc, tc, jp, tp


def _mixed_batch(spans, T, trash_pos, vocab, seed):
    """spans: [(slot, first position, n)] -> packed (tokens, pos, q_slot,
    q_start, q_len, n_real) for a (1, T) mixed step."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, T), np.int32)
    pos = np.full((1, T), trash_pos, np.int32)
    q_slot = np.zeros(T, np.int32)
    q_start = np.zeros(2, np.int32)
    q_len = np.zeros(2, np.int32)
    off = 0
    for slot, p0, n in spans:
        tokens[0, off:off + n] = rng.integers(1, vocab, n)
        pos[0, off:off + n] = np.arange(p0, p0 + n)
        q_slot[off:off + n] = slot
        q_start[slot], q_len[slot] = off, n
        off += n
    return tokens, pos, q_slot, q_start, q_len, off


def test_paged_forward_matches_jax(model):
    jc, tc, jp, tp = model
    BS, MB = 8, 4
    NB = 1 + 2 * MB
    tables = np.array([[1, 2, 3, 4], [8, 7, 6, 5]], np.int32)
    trash = MB * BS
    jkv = jtf.init_paged_kv_cache(jc, NB, BS, dtype=jnp.float32)
    tkv = ttf.init_paged_kv_cache(tc, NB, BS, dtype=torch.float32)
    steps = [
        ([(0, 0, 7), (1, 0, 10)], 20),  # two prefill chunks + 3 padding rows
        ([(0, 7, 1), (1, 10, 5)], 9),   # a decode lane beside a chunk
    ]
    for i, (spans, T) in enumerate(steps):
        tokens, pos, q_slot, q_start, q_len, n = _mixed_batch(
            spans, T, trash, tc.vocab_size, seed=i)
        jl, jkv = jtf.forward(
            jc, jp, jnp.asarray(tokens), jnp.asarray(pos), kv=jkv,
            paged_tables=jnp.asarray(tables), paged_kernel=False,
            paged_ragged=(jnp.asarray(q_slot), jnp.asarray(q_start),
                          jnp.asarray(q_len)),
        )
        tl = ttf.forward(
            tc, tp, torch.from_numpy(tokens), torch.from_numpy(pos), tkv,
            torch.from_numpy(tables),
            paged_ragged=(torch.from_numpy(q_slot), torch.from_numpy(q_start),
                          torch.from_numpy(q_len)),
        )
        np.testing.assert_allclose(tl.numpy()[0, :n], np.asarray(jl)[0, :n],
                                   atol=ATOL, rtol=0)
    # a batched decode step: one token per sequence at its own depth
    tok = np.array([[5], [9]], np.int32)
    ipos = np.array([8, 15], np.int32)
    jl, jkv = jtf.forward(jc, jp, jnp.asarray(tok), jnp.asarray(ipos), kv=jkv,
                          paged_tables=jnp.asarray(tables), paged_kernel=False)
    tl = ttf.forward(tc, tp, torch.from_numpy(tok), torch.from_numpy(ipos), tkv,
                     torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # the written pool blocks agree (block 0 holds only padding garbage)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy()[:, 1:],
                                   np.asarray(jkv[name])[:, 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash-plain"])
def test_dense_cache_forward_matches_jax(model, use_flash):
    """Sequential generation's steps over the dense cache: a fresh prefill
    of a padded (B, 16) bucket (through K2's plain version with
    use_flash), a batched decode step at per-row depths, and a 4-token
    chunk at an offset that attends through the cache.  Logits within atol
    1e-4, and the caches the steps wrote agree."""
    jc, tc, jp, tp = model
    B, T, S = 2, 16, 32
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, tc.vocab_size, (B, T)).astype(np.int32)
    jkv = jtf.init_kv_cache(jc, B, S, dtype=jnp.float32)
    tkv = ttf.init_kv_cache(tc, B, S, dtype=torch.float32)
    zero = np.zeros(B, np.int32)
    jl, jkv = jtf.forward(jc, jp, jnp.asarray(tokens), jnp.asarray(zero), kv=jkv,
                          fresh_prefill=True)
    tl = ttf.forward(tc, tp, torch.from_numpy(tokens), torch.from_numpy(zero), tkv,
                     fresh_prefill=True, use_flash=use_flash)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    steps = [(np.array([[7], [11]], np.int32), np.array([9, 15], np.int32)),
             (rng.integers(1, tc.vocab_size, (B, 4)).astype(np.int32),
              np.array([10, 16], np.int32))]
    for tok, ipos in steps:
        jl, jkv = jtf.forward(jc, jp, jnp.asarray(tok), jnp.asarray(ipos), kv=jkv)
        tl = ttf.forward(tc, tp, torch.from_numpy(tok), torch.from_numpy(ipos), tkv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   atol=ATOL, rtol=0)


def test_param_tree_layout_matches_jax(model):
    """The port's own init draws other numbers but the same tree: same
    keys, shapes and (for norms and biases) values."""
    jc, tc, jp, tp = model
    mine = ttf.init_params(tc, seed=0)
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    flat_t = dict(walk(mine))
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k


def test_moe_configs_are_refused():
    cfg = TConfig.from_name("Mixtral-8x7B-v0.1", n_layer=1, n_embd=64, n_head=4,
                            n_query_groups=2, intermediate_size=64, n_expert=4,
                            n_expert_per_token=2)
    with pytest.raises(ValueError, match="not ported"):
        ttf.init_params(cfg, seed=0)
    with pytest.raises(ValueError, match="not ported"):
        ttf.check_supported(cfg)
