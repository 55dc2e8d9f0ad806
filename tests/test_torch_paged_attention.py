"""Kernel K1's plain version and the port's paged attention against the
JAX package, on the CPU.

- The plain version of K1 (`ragged_paged_attention_plain`, also what the
  wrapper runs on a CPU tensor) is held against the JAX Pallas kernel
  `ragged_paged_attention(..., interpret=True)` — the same call
  tests/test_paged_attention.py makes on the CPU — on every row a slot
  owns, over mha/gqa/mqa x fp/int8 pools x span width {1, 7, 16, 33}
  with a decode lane, an absent slot and padding rows packed beside it.
  Tolerance: float32, atol/rtol 2e-5 (the tolerance the JAX tests hold
  their kernel to).  Rows no slot owns must be exactly zero in the port.
- `paged_update` (with the trash-block redirect) must write exactly what
  the JAX version writes; `paged_prefill`/`paged_attention` on both the
  plain route and the kernel route must match the JAX lax route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from mdi_llm_tpu.ops.paged_attention import paged_prefill as jax_paged_prefill
from mdi_llm_tpu.ops.paged_attention import paged_update as jax_paged_update
from mdi_llm_tpu.ops.ragged_paged_attention import ragged_paged_attention as jax_k1
from mdi_llm_tpu_torch.ops import paged_attention as tpa
from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_plain,
)

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
HEADS = [(8, 8), (8, 2), (4, 1)]
HEAD_IDS = ["mha", "gqa", "mqa"]


def make_pool(n_slots, G, hs, BS, MB, seed):
    """Random pools with shuffled block ids (block 0 never handed out)."""
    rng = np.random.default_rng(seed)
    NB = 1 + n_slots * MB + 2
    k = rng.standard_normal((NB, BS, G, hs)).astype(np.float32)
    v = rng.standard_normal((NB, BS, G, hs)).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB))[: n_slots * MB].reshape(n_slots, MB)
    return k, v, tables.astype(np.int32)


def make_q8_pool(shape, seed):
    """An int8 pool {"q", "scale"} of random payloads in [-127, 127] and
    random positive per-(block, group) scales, as numpy arrays."""
    rng = np.random.default_rng(seed)
    NB, _, G, _ = shape
    return {"q": rng.integers(-127, 128, shape).astype(np.int8),
            "scale": rng.uniform(0.5, 2.5, (NB, G)).astype(np.float32) / 127}


def pack(spans, n_slots, H, hs, T, seed, pad_pos):
    """spans: [(slot, first position, n_tokens)] packed slot-major; the tail
    up to T pads with rows no slot owns, at position `pad_pos`."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, T, hs)).astype(np.float32)
    q_slot = np.zeros(T, np.int32)
    q_pos = np.full(T, pad_pos, np.int32)
    q_start = np.zeros(n_slots, np.int32)
    q_len = np.zeros(n_slots, np.int32)
    off = 0
    for slot, p0, n in spans:
        q_slot[off:off + n] = slot
        q_pos[off:off + n] = np.arange(p0, p0 + n)
        q_start[slot], q_len[slot] = off, n
        off += n
    q_start[q_len == 0] = off  # an absent slot's offset points anywhere
    lens = q_pos[np.clip(q_start, 0, T - 1)] + q_len
    return q, q_slot, q_start, q_len, lens.astype(np.int32), q_pos, off


def t(a):
    if isinstance(a, dict):
        return {key: t(x) for key, x in a.items()}
    return torch.from_numpy(np.array(a))


def j(a):
    if isinstance(a, dict):
        return {key: jnp.asarray(x) for key, x in a.items()}
    return jnp.asarray(a)


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("Tq", [1, 7, 16, 33])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_plain_k1_matches_jax_kernel_interpret(heads, Tq, kv):
    H, G = heads
    hs, BS, MB, n_slots = 16, 8, 8, 4
    k, v, tables = make_pool(n_slots, G, hs, BS, MB, seed=Tq)
    if kv == "int8":
        k, v = make_q8_pool(k.shape, seed=Tq + 1), make_q8_pool(v.shape, seed=Tq + 2)
    # slot 0: a span of width Tq deep in its table; slot 1: absent;
    # slot 2: a decode lane; slot 3: a span crossing a block boundary
    spans = [(0, MB * BS - Tq, Tq), (2, 21, 1), (3, 5, 6)]
    T = Tq + 1 + 6 + 3  # + 3 padding rows
    q, _, q_start, q_len, lens, q_pos, off = pack(
        spans, n_slots, H, hs, T, seed=Tq + 100, pad_pos=MB * BS)
    scale = hs ** -0.5
    want = np.asarray(jax_k1(
        jnp.asarray(q), j(k), j(v), jnp.asarray(tables),
        jnp.asarray(q_start), jnp.asarray(q_len), jnp.asarray(lens),
        jnp.asarray(q_pos), scale=scale, interpret=True,
    ))
    args = [t(x) for x in (q, k, v, tables, q_start, q_len, lens, q_pos)]
    got = ragged_paged_attention_plain(*args, scale=scale).numpy()
    np.testing.assert_allclose(got[:, :, :off], want[:, :, :off], **TOL)
    assert not got[:, :, off:].any(), "rows no slot owns must be zero"
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    before = ragged_paged_attention.launches
    np.testing.assert_array_equal(ragged_paged_attention(*args, scale=scale).numpy(), got)
    assert ragged_paged_attention.launches == before


def test_wrapper_refuses_int8_pools():
    """The wrapper takes a well-formed int8 pool and refuses malformed
    ones: a scale of the wrong shape or dtype, a payload that is not int8,
    an int8 payload without scales, and an int8 k pool beside an fp v."""
    q = torch.randn(1, 4, 2, 16)
    pool = t(make_q8_pool((3, 4, 2, 16), seed=0))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    meta = (torch.zeros(1, dtype=torch.int32), torch.tensor([2], dtype=torch.int32),
            torch.tensor([7], dtype=torch.int32), torch.tensor([5, 6], dtype=torch.int32))
    out = ragged_paged_attention(q, pool, pool, tables, *meta, scale=0.25)
    assert out.shape == q.shape and torch.isfinite(out).all()
    bad = [
        ({"q": pool["q"], "scale": torch.ones(3, 3)}, "scale"),
        ({"q": pool["q"], "scale": torch.ones(3, 2, dtype=torch.float64)}, "scale"),
        ({"q": pool["q"].float(), "scale": pool["scale"]}, "int8"),
        (pool["q"], "scales"),
    ]
    for kp, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ragged_paged_attention(q, kp, kp, tables, *meta, scale=0.25)
    with pytest.raises(ValueError, match="both"):
        ragged_paged_attention(q, pool, pool["q"].float(), tables, *meta, scale=0.25)


def test_paged_update_matches_jax_including_trash_redirect():
    B, T, G, hs, BS, MB, NB = 2, 3, 2, 4, 4, 3, 8
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((NB, BS, G, hs)).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    # row 1's last position lies past its table: it must land in block 0
    pos = np.array([[5, 6, 7], [10, 11, MB * BS + 1]], np.int32)
    new = rng.standard_normal((B, T, G, hs)).astype(np.float32)
    jk, jv = jax_paged_update(jnp.asarray(pool), jnp.asarray(pool),
                              jnp.asarray(new), jnp.asarray(new * 2),
                              jnp.asarray(tables), jnp.asarray(pos))
    tk, tv = t(pool), t(pool)
    out = tpa.paged_update(tk, tv, t(new), t(new * 2), t(tables), t(pos))
    assert out[0] is tk and out[1] is tv, "the update is in place"
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[0, 1], new[1, 2])  # trash block


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_paged_prefill_matches_jax_lax(heads, use_kernel):
    H, G = heads
    hs, BS, MB, n_slots = 16, 8, 6, 3
    k, v, tables = make_pool(n_slots, G, hs, BS, MB, seed=7)
    q, q_slot, q_start, q_len, _, q_pos, off = pack(
        [(0, 30, 1), (2, 3, 20)], n_slots, H, hs, 25, seed=8, pad_pos=MB * BS)
    want = np.asarray(jax_paged_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(q_slot), jnp.asarray(q_start), jnp.asarray(q_len),
        jnp.asarray(q_pos), use_kernel=False))
    got = tpa.paged_prefill(t(q), t(k), t(v), t(tables), t(q_slot), t(q_start),
                            t(q_len), t(q_pos), use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(got[:, :, :off], want[:, :, :off], **TOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("Tq", [1, 5])
def test_paged_attention_matches_jax_lax(Tq, use_kernel):
    H, G, hs, BS, MB, B = 8, 2, 16, 4, 8, 3
    k, v, tables = make_pool(B, G, hs, BS, MB, seed=9)
    rng = np.random.default_rng(10)
    q = rng.standard_normal((B, H, Tq, hs)).astype(np.float32)
    q_pos = np.array([np.arange(p, p + Tq) for p in (0, 13, MB * BS - Tq)], np.int32)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(q_pos), use_kernel=False))
    got = tpa.paged_attention(t(q), t(k), t(v), t(tables), t(q_pos),
                              use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# K1's split-KV arithmetic: the host-side plan and the merge of partials.
TINY_LLAMA_K1 = dict(n_head=32, G=4, hs=64, BS=16, MB=128)  # the chip phases' geometry
K1_SHAPES = {"decode": (8, 8), "mixed": (136, 8), "verify": (40, 8)}  # label: (T, S)


@pytest.mark.parametrize("label", list(K1_SHAPES))
def test_split_plan_comes_from_static_shapes(label):
    """The plan at the decode, mixed and verify shapes the chip phases run:
    16 chunks of 128 keys over a 2048-key table, 32 of 64 for the pure
    decode step (T <= S); the same plan from meta tensors, which hold no
    data, so the wrapper's plan reads none."""
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    T, S = K1_SHAPES[label]
    g = TINY_LLAMA_K1
    plan = rpa.split_plan(g["n_head"], g["G"], T, S, g["BS"], g["MB"], g["hs"])
    row_tiles = -(-(g["n_head"] // g["G"]) * T // rpa.ROW_TILE)
    chunk, n = (64, 32) if label == "decode" else (128, 16)
    assert plan == {"chunk": chunk, "n_chunks": n, "grid": (row_tiles * n, g["G"], S),
                    "workspace": n * g["n_head"] * T * (g["hs"] + 2)}
    meta = dict(device="meta")
    got = rpa.plan_for(torch.empty(1, g["n_head"], T, g["hs"], **meta),
                       torch.empty(1 + S * g["MB"], g["BS"], g["G"], g["hs"], **meta),
                       torch.empty(S, g["MB"], dtype=torch.int32, **meta))
    assert got == plan
    if label == "decode":
        # the decode case's live blocks (depths 37-2000, as the chip phase):
        # at least ~2 per SM of an H100's 132
        depths = (37, 250, 511, 800, 1203, 1500, 1777, 2000)
        live = g["G"] * sum(-(-(d + 1) // plan["chunk"]) for d in depths)
        assert live >= 2 * 132


def test_split_plan_bounds_the_chunk_count():
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    for T, S, least, most in ((4, 3, rpa.MIN_CHUNK, rpa.MAX_CHUNKS),
                              (3, 4, rpa.DECODE_CHUNK, rpa.DECODE_MAX_CHUNKS)):
        for width in (8, 128, 129, 2048, 2049, 8192, 131072):
            plan = rpa.split_plan(8, 2, T, S, 16, -(-width // 16), 32)
            chunk, n = plan["chunk"], plan["n_chunks"]
            assert chunk % rpa.KEY_TILE == 0 and chunk >= least
            assert n <= most <= 32, "the merge kernel holds one chunk per lane"
            assert (n - 1) * chunk < -(-width // 16) * 16 <= n * chunk
            assert (plan["workspace"] == 0) == (n == 1)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_split_merge_matches_unsplit_plain_and_jax_kernel(heads, kv, chunk):
    """Per-chunk partials merged by log-sum-exp (`split_attention_plain`,
    the kernel's split arithmetic) against the unsplit plain version and
    the JAX kernel in interpret mode, float32 at 2e-5.  Slot 0 spans 7
    tokens deep in its table (its walk spans every chunk), slot 1 is
    absent, slot 2 is a decode lane at position 2 * chunk - 1 (its walk ends
    exactly on a chunk boundary), slot 3 a decode lane at 9 (the later chunks hold
    no valid key for it); 3 padding rows no slot owns."""
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import split_attention_plain

    H, G = heads
    hs, BS, MB, n_slots = 16, 8, 8, 4
    k, v, tables = make_pool(n_slots, G, hs, BS, MB, seed=chunk)
    if kv == "int8":
        k, v = make_q8_pool(k.shape, seed=chunk + 1), make_q8_pool(v.shape, seed=chunk + 2)
    spans = [(0, MB * BS - 7, 7), (2, 2 * chunk - 1, 1), (3, 9, 1)]
    q, _, q_start, q_len, lens, q_pos, off = pack(
        spans, n_slots, H, hs, 12, seed=chunk + 100, pad_pos=MB * BS)
    scale = hs ** -0.5
    args = [t(x) for x in (q, k, v, tables, q_start, q_len, lens, q_pos)]
    got = split_attention_plain(*args, scale=scale, chunk=chunk).numpy()
    plain = ragged_paged_attention_plain(*args, scale=scale).numpy()
    want = np.asarray(jax_k1(
        jnp.asarray(q), j(k), j(v), jnp.asarray(tables), jnp.asarray(q_start),
        jnp.asarray(q_len), jnp.asarray(lens), jnp.asarray(q_pos), scale=scale,
        interpret=True))
    np.testing.assert_allclose(got[:, :, :off], plain[:, :, :off], **TOL)
    np.testing.assert_allclose(got[:, :, :off], want[:, :, :off], **TOL)
    assert not got[:, :, off:].any(), "rows no slot owns must be zero"
