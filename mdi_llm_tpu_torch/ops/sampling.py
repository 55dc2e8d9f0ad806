"""Token sampling: temperature, top-k, top-p.

Port of `mdi_llm_tpu/ops/sampling.py`.  The filters are the same math;
the random draw comes from an explicit `torch.Generator` instead of a
`jax.random` key, so sampled streams follow the same distribution but not
the same draws.  Greedy decoding (temperature 0) is exact argmax — the
mode in which the port's streams equal the JAX package's token for token.
`mode`/`top_k` keep their role as the only knobs that change the code
path; temperature and top_p ride as float32 tensors on the device.
`speculative_verify` is the serving engine's accept/resample rule for
speculative decoding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def logits_to_probs(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Softmax with temperature and optional top-k clamp (scale, top-k
    filter, softmax)."""
    logits = logits.float()
    if temperature > 0:
        logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        logits = _topk_filter(logits, top_k)
    return torch.softmax(logits, dim=-1)


def _nucleus_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Mask logits outside the smallest set whose cumulative probability
    exceeds `top_p` (always keeping the most probable token)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    exceeded = (cum - sorted_probs) > top_p
    # Python scalars in `torch.where`: a device tensor made from a scalar
    # is a host-to-device copy, which a CUDA graph capture refuses
    cutoff = torch.where(exceeded, float("inf"), sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, float("-inf"), logits)


def _topk_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def sample(
    logits: torch.Tensor,  # (..., V)
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Next token ids from Python-valued knobs (the first token of a run,
    drawn from the prefill logits): argmax at temperature 0, else one draw
    with `generator` — nucleus when 0 < top_p < 1, else temperature +
    top-k, in the JAX package's branch order."""
    t_op, p_op = sampling_operands(temperature, top_p, device=logits.device)
    return sample_traced(
        logits, generator, t_op, p_op,
        mode=sample_mode(temperature, top_k, top_p), top_k=top_k,
    )


def sample_mode(
    temperature: float, top_k: Optional[int] = None, top_p: Optional[float] = None
) -> str:
    """The dispatch key for `sample_traced`, in the JAX package's branch
    order: greedy, then top-p, then temperature + top-k."""
    if temperature == 0.0:
        return "greedy"
    if top_p is not None and 0.0 < top_p < 1.0:
        return "top_p"
    return "top_k"


def operand_values(temperature: float, top_p: Optional[float]) -> Tuple[float, float]:
    """The values of `sampling_operands`: unused knobs get a harmless 1.0
    so every mode takes the same arguments."""
    t = temperature if temperature and temperature > 0 else 1.0
    p = top_p if top_p is not None else 1.0
    return float(t), float(p)


def sampling_operands(
    temperature: float, top_p: Optional[float], device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 operands for `sample_traced` (`operand_values` on
    `device`)."""
    t, p = operand_values(temperature, top_p)
    return (
        torch.tensor(t, dtype=torch.float32, device=device),
        torch.tensor(p, dtype=torch.float32, device=device),
    )


def filtered_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    *,
    mode: str,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """The float32 logits the sampler draws from: temperature-scaled, then
    nucleus- or top-k-filtered per `mode`."""
    logits = logits.float()
    if mode == "greedy":
        return logits
    logits = logits / temperature
    if mode == "top_p":
        logits = _nucleus_filter(logits, top_p)
    elif top_k is not None and 0 < top_k < logits.shape[-1]:
        logits = _topk_filter(logits, top_k)
    return logits


def sample_traced(
    logits: torch.Tensor,  # (B, V)
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    *,
    mode: str,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Next token per row of `logits`: argmax for greedy, else one draw
    from the filtered distribution with `generator`.  Stays on the device:
    no host read."""
    if mode == "greedy":
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(
        filtered_logits(logits, temperature, top_p, mode=mode, top_k=top_k),
        dim=-1,
    )
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def speculative_verify(
    logits: torch.Tensor,  # (B, K+1, V): row i scores input position i
    draft: torch.Tensor,  # (B, K) int: draft[:, i] proposes position i+1
    draft_len: torch.Tensor,  # (B,) int: valid drafts per row (0..K)
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    *,
    mode: str,
    top_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampled speculative verify for deterministic drafts (an
    n-gram lookup or a greedy draft model: `p_draft` is one-hot), the JAX
    package's `speculative_verify`.  Draft token d is accepted with
    probability p(d), else one token is drawn from p with d masked out, so
    every emitted token is distributed as the per-step sampler's draw;
    `mode == "greedy"` is the exact-match accept against the argmax.  The
    draws come from `generator`, so they follow the same law as JAX's but
    are not the same draws.

    Returns (out (B, K+1) int32, n_emit (B,) int32): row b emits
    `out[b, :n_emit[b]]`, its accepted draft prefix and then one resampled
    (on a rejection) or bonus token."""
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    draft = draft.long()
    f = filtered_logits(logits, temperature, top_p, mode=mode, top_k=top_k)
    valid = torch.arange(K, device=dev)[None, :] < draft_len[:, None]
    if mode == "greedy":
        g = torch.argmax(f, dim=-1)  # (B, K+1)
        match = (g[:, :K] == draft) & valid
        a = torch.cumprod(match.int(), dim=-1).sum(dim=-1)
        return g.int(), (a + 1).int()
    probs = torch.softmax(f, dim=-1)  # the verify distribution p
    u = torch.rand((B, K), generator=generator, device=dev)
    p_draft_tok = probs[:, :K].gather(-1, draft[..., None])[..., 0]  # p_i(d_i)
    accept = (u < p_draft_tok) & valid
    a = torch.cumprod(accept.int(), dim=-1).sum(dim=-1)  # leading accepts
    # position a's draw: the residual (rejected token masked) after a
    # rejection, the untouched bonus distribution after full acceptance
    row_f = f.gather(1, a[:, None, None].expand(B, 1, V))[:, 0]
    if K > 0:
        rej_tok = draft.gather(1, a.clamp(max=K - 1)[:, None])[:, 0]
        masked = torch.where(
            torch.arange(V, device=dev)[None, :] == rej_tok[:, None], float("-inf"), row_f,
        )
        row_f = torch.where((a < draft_len)[:, None], masked, row_f)
    last = torch.multinomial(torch.softmax(row_f, dim=-1), 1, generator=generator)[:, 0]
    cols = torch.arange(K1, device=dev)[None, :]
    padded = torch.nn.functional.pad(draft, (0, 1))  # (B, K+1)
    out = torch.where(cols < a[:, None], padded, torch.zeros_like(padded))
    out = torch.where(cols == a[:, None], last[:, None], out)
    return out.int(), (a + 1).int()
