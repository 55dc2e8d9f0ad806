"""The port's ring attention (`mdi_llm_tpu_torch/ops/ring_attention.py`)
against the JAX package's, on the CPU.

The JAX side runs as tests/test_ring_attention.py runs it: a `shard_map`
over the sp axis of the virtual CPU devices (tests/conftest.py), its flash
body through the Pallas kernels in interpret mode.  The port takes the
ranks' chunks as lists (every rank on the CPU), K2-K4 as their plain
versions.  Inputs are float32 draws from a numpy seed; P in {2, 4} ranks,
GQA groups in {1, n_head}:

- `ring_attention`, plain and flash bodies, equals JAX's within 1e-5, and
  the flash body runs K2 P^2 times (its plain version counted);
- `ring_decode` over cache shards with empty (sentinel) slots equals
  JAX's within 1e-5;
- the flash ring's gradients (K3/K4 with the LSE's cotangent) equal the
  plain ring's and `jax.grad` of the JAX ring's within 1e-5;
- a gated-out rotated chunk adds exactly 0: a batch row whose queries
  precede every key of the other chunks equals the single-chunk result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mdi_llm_tpu.ops import ring_attention as jring
from mdi_llm_tpu.parallel.mesh import make_mesh as jmake_mesh
from mdi_llm_tpu_torch.ops import flash as tflash
from mdi_llm_tpu_torch.ops.ring_attention import NEG_INF, ring_attention, ring_decode

torch.set_num_threads(1)
TOL = 1e-5
B, H, HS = 2, 4, 16


def _draws(seed, T, G, n=3):
    rng = np.random.default_rng(seed)
    shapes = [(B, H, T, HS), (B, G, T, HS), (B, G, T, HS), (B, H, T, HS)][:n]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _split(x, P_sp, axis=2):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in np.split(x, P_sp, axis=axis)]


def _jax_ring(devices, P_sp, use_flash):
    spec = P(None, None, "sp", None)
    return jax.shard_map(
        lambda q, k, v, qp, kp: jring.ring_attention(
            q, k, v, qp, kp, "sp", use_flash=use_flash, flash_interpret=True),
        mesh=jmake_mesh({"sp": P_sp}, devices[:P_sp]),
        in_specs=(spec, spec, spec, P(None, "sp"), P(None, "sp")),
        out_specs=spec, check_vma=False)


def _torch_ring(q, k, v, pos, P_sp, use_flash):
    qs, ks, vs = (_split(x, P_sp) for x in (q, k, v))
    ps = _split(pos, P_sp, axis=1)
    return ring_attention(qs, ks, vs, ps, ps, use_flash=use_flash)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("groups", [1, H])
@pytest.mark.parametrize("P_sp", [2, 4])
def test_ring_attention_matches_jax(devices, P_sp, groups, use_flash):
    T = 8 * P_sp
    q, k, v = _draws(P_sp * 10 + groups, T, groups)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    want = np.asarray(jax.jit(_jax_ring(devices, P_sp, use_flash))(q, k, v, pos, pos))
    tflash.flash_attention_plain.calls = 0
    got = _torch_ring(q, k, v, pos, P_sp, use_flash)
    assert tflash.flash_attention_plain.calls == (P_sp * P_sp if use_flash else 0)
    np.testing.assert_allclose(torch.cat(got, dim=2).numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("groups", [1, H])
@pytest.mark.parametrize("P_sp", [2, 4])
def test_ring_decode_matches_jax(devices, P_sp, groups):
    """Each rank's shard of C slots, about a third of them empty (the
    sentinel position), the rest stamped with distinct positions."""
    C = 6
    rng = np.random.default_rng(P_sp + groups)
    q = rng.standard_normal((B, H, 1, HS)).astype(np.float32)
    kc = rng.standard_normal((B, groups, P_sp * C, HS)).astype(np.float32)
    vc = rng.standard_normal((B, groups, P_sp * C, HS)).astype(np.float32)
    kp = np.stack([rng.permutation(P_sp * C) for _ in range(B)]).astype(np.int32)
    kp[rng.random(kp.shape) < 0.35] = 1 << 30
    qp = np.full((B, 1), P_sp * C - 3, np.int32)
    spec = P(None, None, "sp", None)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda q, k, v, kp, qp: jring.ring_decode(q, k, v, kp, qp, "sp"),
        mesh=jmake_mesh({"sp": P_sp}, devices[:P_sp]),
        in_specs=(P(), spec, spec, P(None, "sp"), P()), out_specs=P(),
        check_vma=False))(q, kc, vc, kp, qp))
    tq = torch.from_numpy(q)
    got = ring_decode([tq] * P_sp, _split(kc, P_sp), _split(vc, P_sp),
                      [x.long() for x in _split(kp, P_sp, axis=1)],
                      [torch.from_numpy(qp).long()] * P_sp)
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("groups", [1, H])
@pytest.mark.parametrize("P_sp", [2, 4])
def test_ring_flash_grads_match_plain_and_jax(devices, P_sp, groups):
    T = 8 * P_sp
    q, k, v, co = _draws(P_sp * 7 + groups, T, groups, n=4)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)

    def jloss(use_flash):
        ring = _jax_ring(devices, P_sp, use_flash)
        return lambda q, k, v: jnp.sum(ring(q, k, v, pos, pos) * co)

    want = jax.jit(jax.grad(jloss(True), argnums=(0, 1, 2)))(q, k, v)

    def tgrads(use_flash):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        qs, ks, vs = ([c for c in x.chunk(P_sp, dim=2)] for x in leaves)
        ps = _split(pos, P_sp, axis=1)
        out = torch.cat(ring_attention(qs, ks, vs, ps, ps, use_flash=use_flash), dim=2)
        (out * torch.from_numpy(co)).sum().backward()
        return [x.grad.numpy() for x in leaves]

    tflash.flash_dq_plain.calls = tflash.flash_dkv_plain.calls = 0
    flash = tgrads(True)
    assert tflash.flash_dq_plain.calls == tflash.flash_dkv_plain.calls == P_sp * P_sp
    plain = tgrads(False)
    for name, f, p, w in zip("qkv", flash, plain, want):
        np.testing.assert_allclose(f, p, rtol=TOL, atol=TOL, err_msg=f"d{name}: flash vs plain")
        np.testing.assert_allclose(f, np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}: flash vs jax.grad")


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_gated_out_chunks_add_exactly_zero(use_flash):
    """Rank 0's queries precede every key of rank 1's chunk: their rows
    equal causal attention over rank 0's chunk alone, bit for bit on the
    flash body (the gate multiplies the chunk's weight by 0) and within
    1e-6 on the plain one (its masked scores are NEG_INF)."""
    T = 8
    q, k, v = _draws(3, 2 * T, 2)
    pos = np.broadcast_to(np.arange(2 * T), (B, 2 * T)).astype(np.int32)
    got = _torch_ring(q, k, v, pos, 2, use_flash)[0]
    alone = ring_attention(*([torch.from_numpy(x[:, :, :T].copy())] for x in (q, k, v)),
                           [torch.from_numpy(pos[:, :T].copy())] * 1,
                           [torch.from_numpy(pos[:, :T].copy())] * 1, use_flash=use_flash)[0]
    if use_flash:
        assert torch.equal(got, alone)
    else:
        np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=1e-6, atol=1e-6)
    assert NEG_INF == jring.NEG_INF


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_sp_forward_matches_jax(devices, use_flash):
    """The cache-less sp forward (`transformer.SPRanks.forward`: each rank
    its chunk, ring attention inside every layer) equals the JAX forward
    under `shard_map` with `sp_axis` within 1e-5, and the unsplit forward;
    gradients flow to the weights through the ring."""
    from mdi_llm_tpu.models import init_params as jinit_params
    from mdi_llm_tpu.models import transformer as jtf
    from mdi_llm_tpu_torch.config import Config as TConfig
    from mdi_llm_tpu_torch.convert import params_from_numpy
    from mdi_llm_tpu_torch.models import transformer as ttf
    from tests.test_model import tiny_config

    P_sp, Bt, T = 4, 2, 32
    jc = tiny_config(block_size=64, n_layer=2)
    jp = jinit_params(jc, jax.random.PRNGKey(1))
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (Bt, T)).astype(np.int32)

    def local(params, x):
        start = jax.lax.axis_index("sp") * x.shape[1]
        ip = jnp.full((x.shape[0],), start, jnp.int32)
        return jtf.forward(jc, params, x, ip, sp_axis="sp")[0]

    want = np.asarray(jax.jit(jax.shard_map(
        local, mesh=jmake_mesh({"sp": P_sp}, devices[:P_sp]),
        in_specs=(jax.tree_util.tree_map(lambda _: P(), jp), P(None, "sp")),
        out_specs=P(None, "sp")))(jp, toks))
    tc = TConfig(**jc.asdict())
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    ranks = ttf.SPRanks(tc, [tp] * P_sp)
    chunks = list(torch.from_numpy(toks).long().chunk(P_sp, dim=1))
    starts = [torch.full((Bt,), r * (T // P_sp)) for r in range(P_sp)]
    got = torch.cat(ranks.forward(chunks, starts, use_flash=use_flash), dim=1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    whole = ttf.forward(tc, tp, torch.from_numpy(toks).long(), torch.zeros(Bt, dtype=torch.long))
    np.testing.assert_allclose(got.detach().numpy(), whole.numpy(), rtol=1e-4, atol=1e-4)
    w = tp["blocks"]["attn"]["qkv"]["weight"].requires_grad_(True)
    ranks = ttf.SPRanks(tc, [tp] * P_sp)
    torch.cat(ranks.forward(chunks, starts, use_flash=use_flash), dim=1).square().mean().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all()) and w.grad.abs().sum() > 0
