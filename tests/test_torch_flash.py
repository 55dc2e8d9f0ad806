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
  that require grad are refused (the backward kernels K3/K4 are not
  ported).
"""

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


def test_inputs_that_require_grad_are_refused():
    q, k, v = (t(x) for x in make_qkv(1, 32, 8, seed=2))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K3/K4"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="K3/K4"):
        tflash.flash_attention_lse(q, k, v)
    with torch.no_grad():
        out = tflash.flash_attention(q, k, v)
    assert out.shape == q.shape


def test_shape_errors():
    q, k, v = (t(x) for x in make_qkv(2, 32, 8, seed=3))
    with pytest.raises(ValueError, match="one chunk"):
        tflash.flash_attention(q, k[:, :, :16], v[:, :, :16])
    with pytest.raises(ValueError, match="multiple of G"):
        tflash.flash_attention(q[:, :3], k, v)
