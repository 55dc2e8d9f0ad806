"""Kernel K2's plain version against the JAX package's Pallas flash kernel,
on the CPU.

- `flash_attention` / `flash_attention_lse` on CPU tensors (the plain
  version) are held against `mdi_llm_tpu.ops.flash.flash_attention(...,
  interpret=True)` and `flash_attention_lse(..., interpret=True)`, causal
  and not, over MHA/GQA/MQA (groups, T, hs) = (4, 64, 16), (2, 100, 16),
  (1, 32, 8) with 32-wide Pallas tiles (T=100 pads to 128 and masks the
  tail).  Tolerance: float32, atol/rtol 2e-5 (the tolerance the JAX tests
  hold their kernel to).
- The masking hazards: the plain core (`masked_attention`) under the
  Pallas kernel's own key mask `k < seq_len (& k <= q)`, including
  seq_len 0 where every row sees no key (out 0, LSE exactly NEG_INF), and
  the rows past seq_len that the wrapper slices off.
- On a CPU tensor the wrapper never reaches the CUDA kernel, and inputs
  that require grad flow through the autograd Function's own backward
  (the plain versions of K3 and K4), not through torch's autograd of the
  plain forward.
- K3/K4's plain versions, through that backward, against the JAX
  package's FlashAttention-2 VJP (the Pallas dQ and dK/dV kernels in
  interpret mode): MHA T=64, GQA T=100 (pads to the Pallas tiles), MQA
  T=48 with mixed 16/32 tiles; and `flash_attention_lse` non-causal with a
  cotangent on the LSE.  Tolerance: float32, atol/rtol 2e-4 (the JAX
  tests' own for the VJP).
- The Function under `torch.utils.checkpoint` (remat) recomputes K2 in
  the backward and gives the same gradients.
- K3/K4's plain versions called directly, with the LSE and D that the
  JAX package's `_flash_bwd_impl` (the Pallas dQ and dK/dV kernels in
  interpret mode) forms from the same forward: dQ, and dK/dV summed over
  each KV group, within 2e-4 over MHA/GQA/MQA, ragged T, causal and
  non-causal with an LSE cotangent.
- `chip_smoke.flash_bwd_bf16_limits`, the element-wise bound the card
  holds the tensor-core K3/K4 to: an emulation of the kernels' roundings
  (P and dS rounded to bfloat16 before their products, dQ rounded once)
  lies within it over several seeds, and an error of 4x the limit
  planted at one element is caught.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.ops import flash as jflash
from mdi_llm_tpu_torch import kernels
from mdi_llm_tpu_torch.ops import flash as tflash
from mdi_llm_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
GRID = [(4, 64, 16), (2, 100, 16), (1, 32, 8)]
GRID_IDS = ["mha", "gqa", "mqa"]
B, H = 2, 4


def make_qkv(groups, T, hs, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, hs)).astype(np.float32)
    k = rng.standard_normal((B, groups, T, hs)).astype(np.float32)
    v = rng.standard_normal((B, groups, T, hs)).astype(np.float32)
    return q, k, v


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("groups,T,hs", GRID, ids=GRID_IDS)
def test_plain_k2_matches_jax_kernel_interpret(groups, T, hs):
    q, k, v = make_qkv(groups, T, hs, seed=T + groups)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=32, block_k=32, interpret=True))
    before = tflash.flash_attention_plain.calls
    got = tflash.flash_attention(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tflash.flash_attention_plain.calls == before + 1


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("groups,T,hs", GRID, ids=GRID_IDS)
def test_plain_k2_lse_matches_jax_kernel_interpret(groups, T, hs, causal):
    q, k, v = make_qkv(groups, T, hs, seed=3 * T + groups)
    scale = 0.3  # an explicit scale reaches both the same way
    want_o, want_lse = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        block_q=32, block_k=32, interpret=True, causal=causal)
    got_o, got_lse = tflash.flash_attention_lse(t(q), t(k), t(v), scale=scale,
                                                causal=causal)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (B, H, T)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("seq_len", [0, 37, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_masked_core_matches_pallas_seq_len_mask_and_neg_inf_rows(causal, seq_len):
    """The Pallas kernel over a padded T=64 with keys valid below seq_len:
    every row of the padded output and LSE, including rows past seq_len and
    (seq_len 0) rows that see no key, where the LSE is NEG_INF and the
    output 0."""
    groups, T, hs = 2, 64, 16
    q, k, v = make_qkv(groups, T, hs, seed=seq_len + 5)
    scale = hs ** -0.5
    want_o, want_lse = jflash._flash_call(
        scale, 32, 32, True, causal, seq_len,
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    idx = torch.arange(T)
    mask = idx[None, :] < seq_len
    if causal:
        mask = mask & (idx[None, :] <= idx[:, None])
    got_o, got_lse = tflash.masked_attention(t(q), t(k), t(v), mask, scale)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    if seq_len == 0:
        assert (got_lse.numpy() == NEG_INF).all() and not got_o.numpy().any()
        assert (np.asarray(want_lse) == NEG_INF).all()


def test_cpu_tensors_never_reach_the_cuda_wrapper(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the CUDA kernel was reached on the CPU")

    monkeypatch.setattr(tflash, "_launch", no_kernel)
    monkeypatch.setattr(kernels, "library", no_kernel)
    q, k, v = (t(x) for x in make_qkv(2, 40, 16, seed=1))
    launches = tflash.flash_attention.launches
    calls = tflash.flash_attention_plain.calls
    tflash.flash_attention(q, k, v)
    tflash.flash_attention_lse(q, k, v, causal=False)
    assert tflash.flash_attention.launches == launches
    assert tflash.flash_attention_plain.calls == calls + 2
    # asking for the kernel on the CPU raises; it does not fall back
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel for cpu"):
        tflash.flash_attention(q, k, v, use_kernel=True)


def test_gradients_flow_through_the_function_on_cpu():
    q, k, v = (t(x).requires_grad_(True) for x in make_qkv(1, 32, 8, seed=2))
    calls = (tflash.flash_attention_plain.calls, tflash.flash_dq_plain.calls,
             tflash.flash_dkv_plain.calls)
    out = tflash.flash_attention(q, k, v)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_FlashCoreBackward"
    dq, dk, dv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert (tflash.flash_attention_plain.calls, tflash.flash_dq_plain.calls,
            tflash.flash_dkv_plain.calls) == (calls[0] + 1, calls[1] + 1, calls[2] + 1)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    # the same gradients as torch's autograd of the plain forward
    ref = tflash.masked_attention(q, k, v, tflash._chunk_mask(32, True, "cpu"), 8 ** -0.5)[0]
    want = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=2e-5)
    with torch.no_grad():  # no grad mode: K2 alone, as before
        np.testing.assert_allclose(tflash.flash_attention(q, k, v).numpy(),
                                   out.detach().numpy(), atol=0, rtol=0)


def _jax_vjp(fn, q, k, v, co, co_lse=None):
    def loss(q, k, v):
        o = fn(q, k, v)
        if co_lse is None:
            return jnp.sum(o * co)
        return jnp.sum(o[0] * co) + jnp.sum(o[1] * co_lse)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("groups,T,hs,bq,bk", [
    (4, 64, 16, 32, 32),   # MHA, aligned T
    (2, 100, 16, 32, 32),  # GQA, T not a multiple of the tiles
    (1, 48, 8, 16, 32),    # MQA, mixed tile sizes
], ids=GRID_IDS)
def test_plain_k3_k4_match_jax_vjp_interpret(groups, T, hs, bq, bk):
    q, k, v = make_qkv(groups, T, hs, seed=7 * T + groups)
    co = np.random.default_rng(T).standard_normal((B, H, T, hs)).astype(np.float32)
    want = _jax_vjp(lambda q, k, v: jflash.flash_attention(
        q, k, v, block_q=bq, block_k=bk, interpret=True), q, k, v, co)
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    calls = tflash.flash_dq_plain.calls, tflash.flash_dkv_plain.calls
    got = torch.autograd.grad((tflash.flash_attention(tq, tk, tv) * t(co)).sum(),
                              (tq, tk, tv))
    assert (tflash.flash_dq_plain.calls, tflash.flash_dkv_plain.calls) == (
        calls[0] + 1, calls[1] + 1)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} mismatch")


def test_plain_lse_vjp_noncausal_matches_jax_interpret():
    """`flash_attention_lse(causal=False)` with cotangents on both outputs:
    the LSE's folds into D (dS = P * (dP - (D - dlse)))."""
    q, k, v = make_qkv(2, 48, 16, seed=11)
    rng = np.random.default_rng(12)
    co = rng.standard_normal((B, H, 48, 16)).astype(np.float32)
    co_lse = rng.standard_normal((B, H, 48)).astype(np.float32)
    want = _jax_vjp(lambda q, k, v: jflash.flash_attention_lse(
        q, k, v, block_q=16, block_k=16, interpret=True, causal=False),
        q, k, v, co, co_lse)
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tflash.flash_attention_lse(tq, tk, tv, causal=False)
    got = torch.autograd.grad((out * t(co)).sum() + (lse * t(co_lse)).sum(), (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} mismatch")


def test_lse_alone_carries_gradients():
    """A loss of the LSE alone: the output's cotangent arrives as None and
    the backward takes dO = 0, giving torch's gradients of the plain LSE."""
    q, k, v = (t(x).requires_grad_(True) for x in make_qkv(2, 40, 8, seed=5))
    co_lse = t(np.random.default_rng(6).standard_normal((B, H, 40)).astype(np.float32))
    _, lse = tflash.flash_attention_lse(q, k, v, causal=False)
    got = torch.autograd.grad((lse * co_lse).sum(), (q, k, v))
    mask = tflash._chunk_mask(40, False, "cpu")
    ref = tflash.masked_attention(q, k, v, mask, 8 ** -0.5)[1]
    want = torch.autograd.grad((ref * co_lse).sum(), (q, k))
    for name, g, w in zip("qk", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name} mismatch")
    assert not got[2].any()  # the LSE does not depend on v


def test_remat_recomputes_k2_and_keeps_the_gradients():
    """Under non-reentrant checkpointing the backward reruns the forward
    (one more plain K2 call) and the Function saves what the recompute
    produced: the gradients equal those without remat."""
    from torch.utils.checkpoint import checkpoint

    q, k, v = (t(x).requires_grad_(True) for x in make_qkv(2, 40, 16, seed=4))

    def f(q, k, v):
        return tflash.flash_attention(q * 1.5, k, v).square().sum()

    want = torch.autograd.grad(f(q, k, v), (q, k, v))
    before = tflash.flash_attention_plain.calls
    loss = checkpoint(f, q, k, v, use_reentrant=False)
    got = torch.autograd.grad(loss, (q, k, v))
    assert tflash.flash_attention_plain.calls == before + 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=0, rtol=0)


def test_cpu_backward_never_reaches_the_cuda_kernels(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CUDA kernel was reached on the CPU")

    monkeypatch.setattr(tflash, "_call", no_kernel)
    monkeypatch.setattr(kernels, "library", no_kernel)
    q, k, v = (t(x).requires_grad_(True) for x in make_qkv(2, 40, 16, seed=1))
    counts = tflash.flash_dq.launches, tflash.flash_dkv.launches
    out, lse = tflash.flash_attention_lse(q, k, v)
    torch.autograd.grad(out.sum() + lse.sum(), (q, k, v))
    assert (tflash.flash_dq.launches, tflash.flash_dkv.launches) == counts
    monkeypatch.undo()
    lse = lse.detach()
    args = (q.detach(), k.detach(), v.detach(), q.detach(), lse, lse, 0.25)
    for fn in (tflash.flash_dq, tflash.flash_dkv):
        with pytest.raises(ValueError, match="no kernel for cpu"):
            fn(*args, use_kernel=True)


def test_shape_errors():
    q, k, v = (t(x) for x in make_qkv(2, 32, 8, seed=3))
    with pytest.raises(ValueError, match="one chunk"):
        tflash.flash_attention(q, k[:, :, :16], v[:, :, :16])
    with pytest.raises(ValueError, match="multiple of G"):
        tflash.flash_attention(q[:, :3], k, v)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal-dlse"])
@pytest.mark.parametrize("groups,T,hs,bq,bk", [
    (4, 64, 16, 32, 32),   # MHA, aligned T
    (2, 100, 16, 32, 32),  # GQA, T not a multiple of the tiles
    (1, 48, 8, 16, 32),    # MQA, mixed tile sizes
], ids=GRID_IDS)
def test_plain_k3_k4_per_group_match_jax_bwd_impl(groups, T, hs, bq, bk, causal):
    """K4's plain version returns dK/dV already summed over each KV group,
    as `_flash_bwd_impl` does after its kernel; both take the same LSE (the
    JAX forward's) and the same D = rowsum(dO * O) - dlse."""
    q, k, v = make_qkv(groups, T, hs, seed=5 * T + groups)
    rng = np.random.default_rng(T + groups)
    do = rng.standard_normal((B, H, T, hs)).astype(np.float32)
    dlse = None if causal else rng.standard_normal((B, H, T)).astype(np.float32)
    scale = hs ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jflash._flash_fwd_impl(scale, bq, bk, True, causal, jq, jk, jv, True)
    want = [np.asarray(g) for g in jflash._flash_bwd_impl(
        scale, bq, bk, True, causal, (jq, jk, jv, out, lse), jnp.asarray(do),
        None if dlse is None else jnp.asarray(dlse))]
    lse_t = t(np.asarray(lse)[:, :, :T])
    dsum = (t(do) * t(np.asarray(out))).sum(-1)
    if dlse is not None:
        dsum = dsum - t(dlse)
    args = (t(q), t(k), t(v), t(do), lse_t, dsum, scale, causal)
    dq = tflash.flash_dq_plain(*args)
    dk, dv = tflash.flash_dkv_plain(*args)
    assert dk.shape == dv.shape == (B, groups, T, hs) and dk.dtype == torch.float32
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} mismatch")


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_case(seed, causal, groups=2, T=40, hs=16):
    """bfloat16 inputs, the forward's LSE and D, and the plain versions'
    float32 (dQ, dK, dV) on them."""
    q, k, v = (t(x).bfloat16() for x in make_qkv(groups, T, hs, seed=seed))
    rng = np.random.default_rng(seed + 100)
    do = t(rng.standard_normal((B, H, T, hs)).astype(np.float32)).bfloat16()
    scale = hs ** -0.5
    out, lse = tflash.flash_attention_plain(q.float(), k.float(), v.float(), scale, causal)
    dsum = (do.float() * out).sum(-1)
    if not causal:
        dsum = dsum - t(rng.standard_normal((B, H, T)).astype(np.float32))
    args = (q, k, v, do, lse, dsum, scale, causal)
    f32 = [x.float() for x in (q, k, v, do)] + [lse, dsum, scale, causal]
    ref = (tflash.flash_dq_plain(*f32),) + tflash.flash_dkv_plain(*f32)
    return args, ref


def _emulate_kernel_roundings(q, k, v, do, lse, dsum, scale, causal):
    """K3/K4's arithmetic on bfloat16 inputs: float32 S, dP, P and dS; P
    and dS rounded to bfloat16 as operands of dV, dK and dQ; dQ rounded to
    bfloat16 once."""
    qg, dog, p, ds = tflash._bwd_terms(q.float(), k.float(), v.float(), do.float(),
                                       lse, dsum, scale, causal)
    p_b, ds_b = p.bfloat16().float(), ds.bfloat16().float()
    dq = scale * torch.einsum("bgrts,bgsh->bgrth", ds_b, k.float())
    dk = scale * torch.einsum("bgrts,bgrth->bgsh", ds_b, qg)
    dv = torch.einsum("bgrts,bgrth->bgsh", p_b, dog)
    return dq.reshape(q.shape).bfloat16(), dk, dv


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal-dlse"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_limits_hold_for_the_kernels_roundings(seed, causal):
    cs = _chip_smoke()
    args, ref = _bf16_case(seed, causal)
    limits = cs.flash_bwd_bf16_limits(*args, ref)
    got = _emulate_kernel_roundings(*args)
    for name, g, r, lim in zip(("dq", "dk", "dv"), got, ref, limits):
        assert lim.shape == r.shape and (lim > 0).all()
        err, ratio = cs.err_ratio(g, r, lim)
        assert err > 0, f"{name}: the emulation made no rounding"
        assert ratio <= 1.0, f"{name}: {ratio} x the limit"


def test_bf16_limits_catch_a_planted_error():
    cs = _chip_smoke()
    args, ref = _bf16_case(7, True)
    limits = cs.flash_bwd_bf16_limits(*args, ref)
    got = _emulate_kernel_roundings(*args)
    for i, (g, r, lim) in enumerate(zip(got, ref, limits)):
        bad = g.float().clone()
        idx = tuple(int(n) // 2 for n in bad.shape)
        bad[idx] = r[idx] + 4 * lim[idx]
        _, ratio = cs.err_ratio(bad, r, lim)
        assert ratio > 1.0, f"output {i}: a 4x error was not caught ({ratio})"
