"""The port's quantized and float8 paged pools against the JAX package, on
the CPU.

- `paged_update` over an int8 pool against the JAX `paged_update`
  (`_quantized_update`): the same writes into the same starting pool must
  give byte-identical payloads and bit-identical scales, with the trash
  redirect, duplicate block ids inside one call and a scale that grows over
  a block's earlier tokens.  Both round half to even in float32, so a byte
  may differ by one only where the value to round is an exact tie computed
  in two float orders; the test allows that and nothing else.
- Rewrites are byte-idempotent, and a block's final scale does not depend
  on how its tokens were grouped into calls (the contracts the chunked
  decode and the prefix cache lean on).
- float8 pools (e4m3, e5m2): `paged_update` casts to the same bytes as
  JAX, and `paged_prefill` / `paged_attention` on the plain route and the
  kernel route's CPU fallback agree with the JAX lax routes within 2e-5
  (float32 q; the pool upcasts at the read).
- A model forward over an int8 pool writes through the per-layer views of
  `run_blocks` into the stacked pool: the pool the JAX forward returns, up
  to the last bits of the two packages' float32 products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from mdi_llm_tpu.ops.paged_attention import paged_prefill as jax_paged_prefill
from mdi_llm_tpu.ops.paged_attention import paged_update as jax_paged_update
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
FP8 = {"e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
       "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def q8_pool(NB, BS, G, hs, seed=None):
    """An int8 pool as numpy: empty, or (with a seed) random payloads under
    random positive scales."""
    if seed is None:
        return {"q": np.zeros((NB, BS, G, hs), np.int8), "scale": np.zeros((NB, G), np.float32)}
    rng = np.random.default_rng(seed)
    return {"q": rng.integers(-127, 128, (NB, BS, G, hs)).astype(np.int8),
            "scale": rng.uniform(0.01, 0.02, (NB, G)).astype(np.float32)}


def to_t(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def to_j(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()}


def update_both(kp, vp, k_new, v_new, tables, pos):
    """One paged_update through each package from the same numpy pools;
    returns ((port k, port v), (jax k, jax v)) as numpy dicts."""
    tk, tv = to_t(kp), to_t(vp)
    out = tpa.paged_update(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                           torch.from_numpy(tables), torch.from_numpy(pos))
    assert out[0] is tk and out[1] is tv, "the update is in place"
    jk, jv = jax_paged_update(to_j(kp), to_j(vp), jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(tables), jnp.asarray(pos))
    as_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731
    return (as_np(tk), as_np(tv)), (as_np(jk), as_np(jv))


def assert_same_q8(got, want, before, new, blk, off):
    """Scales bit-identical; payload bytes identical except an off-by-one
    where the value rounded was an exact tie (x.5) in float32."""
    np.testing.assert_array_equal(got["scale"], want["scale"])
    diff = got["q"].astype(np.int16) - want["q"].astype(np.int16)
    if not diff.any():
        return
    assert np.abs(diff).max() == 1, "payloads differ by more than a rounding tie"
    s_old, s_new = before["scale"][blk], want["scale"][blk]  # (N, G)
    ties = np.zeros(got["q"].shape, bool)
    factor = np.where(s_new > 0, s_old / np.maximum(s_new, 1e-30), 0).astype(np.float32)
    req = before["q"][blk].astype(np.float32) * factor[:, None, :, None]
    ties[blk] |= np.abs(req - np.floor(req)) == 0.5
    tok = new.astype(np.float32) / np.maximum(s_new, 1e-30)[..., None]
    ties[blk, off] |= np.abs(tok - np.floor(tok)) == 0.5
    assert ties[diff != 0].all(), "a payload byte differs away from a rounding tie"


def test_q8_paged_update_matches_jax_byte_for_byte():
    """Two updates into a random int8 pool: the second writes values large
    enough to grow scales over earlier tokens (requantizing them), repeats
    block ids within the call, shares one block between both rows and
    sends a position past the table to the trash block."""
    G, hs, BS, MB, NB = 2, 8, 4, 3, 9
    kp, vp = q8_pool(NB, BS, G, hs, seed=1), q8_pool(NB, BS, G, hs, seed=2)
    tables = np.array([[1, 2, 3], [4, 2, 5]], np.int32)  # block 2 is shared
    rng = np.random.default_rng(3)
    for scale, pos in ((1.0, np.array([[0, 1, 2, 5], [0, 4, 6, 7]], np.int32)),
                       (4.0, np.array([[3, 5, 9, 10], [1, 5, 11, MB * BS + 2]], np.int32))):
        k_new = (scale * rng.standard_normal((2, 4, G, hs))).astype(np.float32)
        v_new = (scale * rng.standard_normal((2, 4, G, hs))).astype(np.float32)
        (tk, tv), (jk, jv) = update_both(kp, vp, k_new, v_new, tables, pos)
        idx = pos // BS
        blk = np.where(idx < MB, np.take_along_axis(tables, np.clip(idx, 0, MB - 1), 1), 0)
        blk, off = blk.reshape(-1), (pos % BS).reshape(-1)
        assert_same_q8(tk, jk, kp, k_new.reshape(-1, G, hs), blk, off)
        assert_same_q8(tv, jv, vp, v_new.reshape(-1, G, hs), blk, off)
        grew = (jk["scale"][1:] > kp["scale"][1:]).any()
        kp, vp = jk, jv
    assert grew, "the second update must grow a scale"
    assert (kp["q"][0] != 0).any(), "the past-the-table position went to the trash block"


def test_q8_rewrite_is_byte_idempotent_and_scales_ignore_grouping():
    """Re-writing the same (token, position) pairs leaves payload and
    scales bit-identical (a factor of exactly 1 rounds every byte back);
    writing the same tokens one call per token gives the same final
    scales as one call for all of them."""
    G, hs, BS, NB = 2, 8, 4, 5
    tables = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    k_new = torch.randn(1, 9, G, hs, generator=g) * torch.linspace(0.5, 3, 9)[None, :, None, None]
    v_new = torch.randn(1, 9, G, hs, generator=g)
    pos = torch.arange(9)[None]
    one = [to_t(q8_pool(NB, BS, G, hs)) for _ in range(2)]
    tpa.paged_update(*one, k_new, v_new, tables, pos)
    snap = [{k: x.clone() for k, x in p.items()} for p in one]
    for i in (4, 8, 0):  # frozen-lane style rewrites of single positions
        tpa.paged_update(*one, k_new[:, i:i + 1], v_new[:, i:i + 1], tables, pos[:, i:i + 1])
    tpa.paged_update(*one, k_new, v_new, tables, pos)
    for a, b in zip(one, snap):
        assert torch.equal(a["q"], b["q"]) and torch.equal(a["scale"], b["scale"])
    each = [to_t(q8_pool(NB, BS, G, hs)) for _ in range(2)]
    for i in range(9):
        tpa.paged_update(*each, k_new[:, i:i + 1], v_new[:, i:i + 1], tables, pos[:, i:i + 1])
    for a, b in zip(one, each):
        assert torch.equal(a["scale"], b["scale"])
        # requantized bytes round again under grouping: within one step
        assert (a["q"].int() - b["q"].int()).abs().max() <= 1


@pytest.mark.parametrize("kind", list(FP8))
def test_float8_paged_update_casts_like_jax(kind):
    tdt, jdt = FP8[kind]
    G, hs, BS, NB = 2, 8, 4, 6
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((NB, BS, G, hs)).astype(np.float32)
    new = (3 * rng.standard_normal((2, 3, G, hs))).astype(np.float32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    pos = np.array([[0, 5, 9], [2, 3, 7]], np.int32)  # 9 lies past row 0's table
    tk, tv = (torch.from_numpy(pool).to(tdt) for _ in range(2))
    tpa.paged_update(tk, tv, torch.from_numpy(new), torch.from_numpy(-new),
                     torch.from_numpy(tables), torch.from_numpy(pos))
    jk, jv = jax_paged_update(jnp.asarray(pool, jdt), jnp.asarray(pool, jdt), jnp.asarray(new),
                              jnp.asarray(-new), jnp.asarray(tables), jnp.asarray(pos))
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(a.view(torch.uint8).numpy(),
                                      np.asarray(b).view(np.uint8))


def fp8_case(kind, G, H, hs, BS, MB, n_slots, seed):
    """float32 q, a float8 pool (the same bytes in both packages) and
    shuffled tables."""
    tdt, jdt = FP8[kind]
    rng = np.random.default_rng(seed)
    NB = 1 + n_slots * MB
    k = (2 * rng.standard_normal((NB, BS, G, hs))).astype(np.float32)
    v = rng.standard_normal((NB, BS, G, hs)).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB))[: n_slots * MB].reshape(n_slots, MB)
    tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    np.testing.assert_array_equal(tk.view(torch.uint8).numpy(), np.asarray(jk).view(np.uint8))
    return (tk, tv), (jk, jv), tables.astype(np.int32), rng


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("kind", list(FP8))
def test_float8_paged_prefill_matches_jax_lax(kind, use_kernel):
    H, G, hs, BS, MB, n_slots = 8, 2, 16, 8, 6, 3
    (tk, tv), (jk, jv), tables, rng = fp8_case(kind, G, H, hs, BS, MB, n_slots, seed=5)
    T = 25
    q = rng.standard_normal((1, H, T, hs)).astype(np.float32)
    q_slot = np.zeros(T, np.int32)
    q_pos = np.full(T, MB * BS, np.int32)
    q_start, q_len = np.array([0, 21, 1], np.int32), np.array([1, 0, 20], np.int32)
    q_pos[0], q_pos[1:21] = 30, np.arange(3, 23)
    q_slot[1:21] = 2
    want = np.asarray(jax_paged_prefill(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(q_slot),
        jnp.asarray(q_start), jnp.asarray(q_len), jnp.asarray(q_pos), use_kernel=False))
    t = torch.from_numpy
    got = tpa.paged_prefill(t(q), tk, tv, t(tables), t(q_slot), t(q_start), t(q_len),
                            t(q_pos), use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(got[:, :, :21], want[:, :, :21], **TOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("kind", list(FP8))
def test_float8_paged_attention_matches_jax_lax(kind, use_kernel):
    H, G, hs, BS, MB, B, Tq = 8, 2, 16, 4, 8, 3, 5
    (tk, tv), (jk, jv), tables, rng = fp8_case(kind, G, H, hs, BS, MB, B, seed=6)
    q = rng.standard_normal((B, H, Tq, hs)).astype(np.float32)
    q_pos = np.array([np.arange(p, p + Tq) for p in (0, 13, MB * BS - Tq)], np.int32)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(q_pos), use_kernel=False))
    got = tpa.paged_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
                              torch.from_numpy(q_pos), use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_forward_writes_through_layer_views_like_jax():
    """A 3-layer forward over a stacked int8 pool: `run_blocks` must hand
    each layer views of its slice, so every layer's writes land in the
    pool.  The K/V written come out of two packages' float32 products,
    which differ in the last bits, so the pool the JAX forward returns is
    matched to 1e-5 (scales, relative) and one step of rounding (bytes);
    the logits agree within 2e-5."""
    tiny = dict(name="q8-tiny", block_size=64, vocab_size=96, padded_vocab_size=96,
                n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
                parallel_residual=False, bias=False, norm_class_name="RMSNorm",
                mlp_class_name="LLaMAMLP", intermediate_size=64)
    jc, tc = JConfig(**tiny), TConfig(**tiny)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    tables = np.array([[3, 1, 4], [2, 5, 6]], np.int32)
    tokens = np.random.default_rng(7).integers(1, 96, (2, 6)).astype(np.int32)
    pos0 = np.array([0, 3], np.int32)
    kv = ttf.init_paged_kv_cache(tc, 7, 4, dtype="int8")
    assert kv["k"]["q"].shape == (3, 7, 4, 2, 8) and kv["k"]["q"].dtype == torch.int8
    assert kv["k"]["scale"].shape == (3, 7, 2) and kv["k"]["scale"].dtype == torch.float32
    logits = ttf.forward(tc, tp, torch.from_numpy(tokens), torch.from_numpy(pos0), kv,
                         torch.from_numpy(tables))
    jlogits, jkv = jtf.forward(jc, jp, jnp.asarray(tokens), jnp.asarray(pos0),
                               kv=jtf.init_paged_kv_cache(jc, 7, 4, dtype="int8"),
                               paged_tables=jnp.asarray(tables), paged_kernel=False)
    for side in ("k", "v"):
        assert (kv[side]["scale"][:, 1:] > 0).sum() > 0
        for layer in range(3):
            assert (kv[side]["scale"][layer, [3, 1, 2, 5]] > 0).all(), f"layer {layer} missed"
        np.testing.assert_allclose(kv[side]["scale"].numpy(), np.asarray(jkv[side]["scale"]),
                                   rtol=1e-5, atol=0)
        diff = kv[side]["q"].int().numpy() - np.asarray(jkv[side]["q"], np.int32)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
