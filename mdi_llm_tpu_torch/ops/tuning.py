"""Tuning tables for kernel K1's split of the key walk.

Port of `mdi_llm_tpu/ops/tuning.py` for the CUDA kernel
(`csrc/ragged_paged_attention.cu`).  The Pallas kernel's parameters
(`kv_step`, `q_pack`, `scratch_width`) have no meaning there; what shapes
the CUDA kernel's work at run time is the split plan of
`ops/ragged_paged_attention.split_plan`, and its four knobs are the
fields of `KernelParams`:

- ``min_chunk`` / ``max_chunks`` — a step with more packed tokens than
  slots (a mixed or verify step) walks each slot's keys in chunks of at
  least ``min_chunk`` keys, doubled until at most ``max_chunks`` chunks
  cover the table;
- ``decode_chunk`` / ``decode_max_chunks`` — the same for a pure decode
  step (at most one token per slot), whose key walk is all there is to
  spread over the card.

The tiles (``ROW_TILE`` x ``KEY_TILE``) are compiled into the kernel and
are not tuning parameters.  A chunk must be a positive multiple of
``KEY_TILE``; the merge kernel holds one chunk per lane, so at most
``K1_MAX_CHUNKS`` (32) chunks; and the float32 workspace of the partials
must fit in ``WORKSPACE_LIMIT_BYTES`` (`validate_kernel_params`).

Resolution (`resolve_kernel_params`) runs on the host, once per process,
geometry and table (`kernel_params_for`, which the wrapper calls before
any CUDA graph of a step is captured: the engines' warm-up runs every
step eagerly first), so the resolved values are static in every captured
graph.  Precedence, as in the JAX package:

1. explicit ``params=`` at `ragged_paged_attention(...)`,
2. the JSON table named by the ``MDI_TUNE_TABLE`` environment variable
   (written by ``python -m mdi_llm_tpu_torch.ops.tuning``),
3. the committed defaults below, measured on the card they name,
4. `DEFAULT_PARAMS`, the kernel's constants: correct on anything.

An entry that fails validation raises, naming the entry; it never gives
way to a lower level.  A table whose entries carry the JAX package's
fields is refused.

``python -m mdi_llm_tpu_torch.ops.tuning --model NAME`` records the steps
of a serve (the serve CLI's flags; `record_serve_steps` on a one-layer
stand-in: the steps depend on the trace and the engine's knobs, not the
weights), sweeps `candidate_params` on the card over those steps, each
weighted by how often it occurs (`trace_cases`, `autotune`), holds every
candidate against the plain version of K1 before timing it with CUDA
events, and writes the winner as a table.  On the CPU (``--device cpu``)
it runs the plain split arithmetic (`split_attention_plain`) with each
candidate's chunk instead: the flow, not a measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

__all__ = [
    "TUNE_TABLE_ENV",
    "KernelParams",
    "DEFAULT_PARAMS",
    "BUILTIN_TUNING_TABLE",
    "geometry_key",
    "resolve_kernel_params",
    "kernel_params_for",
    "global_kernel_params",
    "validate_kernel_params",
    "load_tuning_table",
    "save_tuning_table",
    "candidate_params",
    "SERVE_TRACE_CASES",
    "autotune",
    "main",
]

TUNE_TABLE_ENV = "MDI_TUNE_TABLE"
K1_MAX_CHUNKS = 32  # csrc/ragged_paged_attention.cu: kMaxChunks
WORKSPACE_LIMIT_BYTES = 1 << 30
# the packed tokens a step's workspace is checked at: the serving engine's
# default token budget (8 slots + a 128-token prefill chunk) rounded up
WORKSPACE_TOKENS = 256
JAX_FIELDS = frozenset({"kv_step", "q_pack", "scratch_width"})
# keys an entry may carry besides its parameters: where it was measured
ENTRY_NOTES = frozenset({"card", "measured_by"})


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """One tuning-table entry: K1's split knobs (module docstring)."""

    min_chunk: int = rpa.MIN_CHUNK
    max_chunks: int = rpa.MAX_CHUNKS
    decode_chunk: int = rpa.DECODE_CHUNK
    decode_max_chunks: int = rpa.DECODE_MAX_CHUNKS

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], where: str = "entry") -> "KernelParams":
        """The entry's parameters; JAX fields, unknown fields and missing
        ones raise, naming `where`."""
        jax_fields = sorted(JAX_FIELDS & set(d))
        if jax_fields:
            raise ValueError(
                f"{where}: fields {jax_fields} are the JAX package's Pallas "
                "kernel parameters; the CUDA kernel's table takes "
                f"{[f.name for f in dataclasses.fields(cls)]}"
            )
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names - ENTRY_NOTES)
        missing = sorted(names - set(d))
        if unknown or missing:
            raise ValueError(f"{where}: unknown fields {unknown}, missing fields {missing}")
        return cls(**{k: d[k] for k in names})


DEFAULT_PARAMS = KernelParams()

# Committed defaults, keyed by `geometry_key` (the card's name first).
# An entry other than the constants is committed only once a whole serve
# ran faster with it than with the constants in both pairs of default,
# winner, winner, default serves (`chip_smoke.py` tune); until then an
# entry holds the constants.  So far both hold them: in `chip_smoke.py`
# tune on an NVIDIA H100 80GB HBM3 at 700.00 W, the sweep over the serve
# trace's 99 steps found splits with 2.8% (tiny-llama-1.1b) and 21%
# (Mixtral-8x7B) less K1 time than the constants', and neither served the
# trace faster in both pairs (Mixtral at 16 layers: default 275.82 and
# 269.63 tokens/s, winner 275.37 and 274.02).
_H100 = "NVIDIA H100 80GB HBM3"
_MEASURED = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "measured_by": "chip_smoke.py tune"}
BUILTIN_TUNING_TABLE: Dict[str, Dict[str, Any]] = {
    f"{_H100}|32h4g64hs|bs16|q=bfloat16|kv=bfloat16": dict(
        min_chunk=128, max_chunks=16, decode_chunk=64, decode_max_chunks=32, **_MEASURED),
    f"{_H100}|32h8g128hs|bs16|q=bfloat16|kv=bfloat16": dict(
        min_chunk=128, max_chunks=16, decode_chunk=64, decode_max_chunks=32, **_MEASURED),
}


def geometry_key(device: str, n_head: int, n_groups: int, head_size: int,
                 block_size: int, q_dtype, kv_dtype) -> str:
    """The table key of one attention geometry on one card: the card's
    name (`torch.cuda.get_device_name()`), heads, KV groups, head size,
    pool block size, q's dtype and the pool's storage dtype."""
    return (f"{device}|{n_head}h{n_groups}g{head_size}hs|bs{block_size}"
            f"|q={_dtype_name(q_dtype)}|kv={_dtype_name(kv_dtype)}")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def load_tuning_table(path: str) -> Dict[str, Any]:
    """A table written by `save_tuning_table`: ``{"device_kind", "entries":
    {geometry_key: entry}}`` (a bare entries mapping is accepted too)."""
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict):
        raise ValueError(f"tuning table {path}: expected a JSON object")
    return d if "entries" in d else {"device_kind": None, "entries": d}


def save_tuning_table(path: str, device_kind: Optional[str], entries: Dict[str, Any],
                      timings_ms: Optional[Dict[str, Any]] = None) -> None:
    doc: Dict[str, Any] = {"device_kind": device_kind, "entries": entries}
    if timings_ms:
        doc["timings_ms"] = timings_ms
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def validate_kernel_params(params: KernelParams, n_head: int, head_size: int,
                           n_tokens: int = WORKSPACE_TOKENS) -> List[str]:
    """The problems of one entry, as strings (empty: valid): chunks that
    are no positive multiple of KEY_TILE, chunk counts outside [1,
    K1_MAX_CHUNKS], a workspace of `n_tokens` packed tokens over
    `max_chunks` chunks larger than WORKSPACE_LIMIT_BYTES."""
    problems = []
    for name in ("min_chunk", "decode_chunk"):
        v = getattr(params, name)
        if not isinstance(v, int) or v <= 0 or v % rpa.KEY_TILE:
            problems.append(f"{name}={v!r} must be a positive multiple of "
                            f"KEY_TILE={rpa.KEY_TILE} (the kernel's key tile)")
    for name in ("max_chunks", "decode_max_chunks"):
        v = getattr(params, name)
        if not isinstance(v, int) or not 1 <= v <= K1_MAX_CHUNKS:
            problems.append(f"{name}={v!r} must lie in [1, {K1_MAX_CHUNKS}] (the "
                            "merge kernel holds one chunk per lane)")
    if not problems:
        ws = 4 * params.max_chunks * n_head * n_tokens * (head_size + 2)
        if ws > WORKSPACE_LIMIT_BYTES:
            problems.append(f"the workspace of {n_tokens} tokens over {params.max_chunks} "
                            f"chunks is {ws} B > {WORKSPACE_LIMIT_BYTES} B")
    return problems


def _checked(params: KernelParams, where: str, n_head: int, head_size: int) -> KernelParams:
    problems = validate_kernel_params(params, n_head, head_size)
    if problems:
        raise ValueError(f"invalid K1 tuning {where}: " + "; ".join(problems))
    return params


@functools.lru_cache(maxsize=None)
def checked_params(params: KernelParams, n_head: int, head_size: int) -> KernelParams:
    """Explicit `params=` of a K1 call, validated once per geometry."""
    return _checked(params, "params=", n_head, head_size)


def resolve_kernel_params(
    n_head: int, n_groups: int, head_size: int, block_size: int, q_dtype, kv_dtype,
    device_kind: Optional[str] = None, table_path: Optional[str] = None,
    params: Optional[KernelParams] = None,
) -> Tuple[KernelParams, Dict[str, Any]]:
    """K1's parameters for one geometry, host-side, by the module
    docstring's precedence.  Returns (params, meta) with meta = {"tuned",
    "table_source", "key"}; `tuned` is True only for an entry of a user
    table.  An invalid entry raises, naming it."""
    key = geometry_key(device_kind or "unknown", n_head, n_groups, head_size, block_size,
                       q_dtype, kv_dtype)
    meta: Dict[str, Any] = {"tuned": False, "table_source": None, "key": key}
    if params is not None:
        meta["table_source"] = "explicit"
        return checked_params(params, n_head, head_size), meta
    path = table_path or os.environ.get(TUNE_TABLE_ENV)
    if path:
        entries = load_tuning_table(path).get("entries", {})
        for k, entry in entries.items():  # the whole table is checked, not only this key
            where = f"entry {k!r} of {path}"
            _checked(KernelParams.from_dict(entry, where), where, n_head, head_size)
        if key in entries:
            meta.update(tuned=True, table_source=f"file:{path}")
            return KernelParams.from_dict(entries[key]), meta
    if key in BUILTIN_TUNING_TABLE:
        where = f"committed entry {key!r}"
        meta["table_source"] = "builtin"
        p = KernelParams.from_dict(BUILTIN_TUNING_TABLE[key], where)
        return _checked(p, where, n_head, head_size), meta
    meta["table_source"] = "conservative"
    return DEFAULT_PARAMS, meta


# the card a trace on meta tensors plans K1's split for (the
# compiled-program analysis, `analysis/ir.py`): set by `planned_device`
_planned = [_H100]


@contextlib.contextmanager
def planned_device(kind: str):
    """Within this context a K1 call on meta tensors resolves its knobs
    for the card `kind` (`torch.cuda.get_device_name()`); outside it, for
    the NVIDIA H100 80GB HBM3.  Reads no card."""
    _planned.append(str(kind))
    try:
        yield
    finally:
        _planned.pop()


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _device_name(device: torch.device) -> str:
    if device.type == "meta":
        return _planned[-1]
    return _card_name(device.index or 0)


@functools.lru_cache(maxsize=None)
def _resolved(device, n_head, n_groups, head_size, block_size, q_dtype, kv_dtype,
              table_path) -> KernelParams:
    return resolve_kernel_params(n_head, n_groups, head_size, block_size, q_dtype,
                                 kv_dtype, device_kind=device, table_path=table_path)[0]


def kernel_params_for(q: torch.Tensor, k_payload: torch.Tensor) -> KernelParams:
    """The resolved parameters of one K1 call on the card, memoised per
    (card, geometry, dtypes, `MDI_TUNE_TABLE`): the table is read and
    checked once, at the first call of that geometry."""
    _, n_head, _, hs = q.shape
    _, BS, G, _ = k_payload.shape
    return _resolved(_device_name(q.device), n_head, G, hs, BS,
                     _dtype_name(q.dtype), _dtype_name(k_payload.dtype),
                     os.environ.get(TUNE_TABLE_ENV) or None)



def global_kernel_params(n_head: int, n_groups: int, head_size: int, block_size: int,
                         q_dtype, kv_dtype, device: torch.device) -> KernelParams:
    """K1's parameters for a tensor-parallel rank's calls, resolved on the
    model's whole geometry (`n_head` heads over `n_groups` KV groups), as
    the JAX package resolves them outside its shard_map (`mdi_llm_tpu/ops/
    paged_attention.py:256-259`); memoised like `kernel_params_for`."""
    return _resolved(_device_name(device), n_head, n_groups, head_size,
                     block_size, _dtype_name(q_dtype), _dtype_name(kv_dtype),
                     os.environ.get(TUNE_TABLE_ENV) or None)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def candidate_params() -> List[KernelParams]:
    """The sweep grid, `DEFAULT_PARAMS` first (a tie keeps it): mixed-step
    chunks of 64-512 keys in at most 4-32 chunks, decode chunks of 32-128
    keys in at most 8-32 chunks."""
    grid = [KernelParams(mc, mx, dc, dm)
            for mc in (64, 128, 256, 512) for mx in (4, 8, 16, 32)
            for dc in (32, 64, 128) for dm in (8, 16, 32)]
    return [DEFAULT_PARAMS] + [p for p in grid if p != DEFAULT_PARAMS]


# A case is (spans, T, weight): one (first position, tokens) span per slot
# ((0, 0): the slot is absent), T packed rows, and how many of a serve's
# steps it stands for.
Case = Tuple[List[Tuple[int, int]], int, int]

DECODE_DEPTHS = (37, 250, 511, 800, 1203, 1500, 1777, 2000)
# Three spot steps over 8 slots and 2048-key tables, one of each kind: a
# pure decode step, a mixed step (6 decode lanes, a 128-token prefill chunk,
# an absent slot: the default 136-token budget) and a verify step (spans of
# 5).  They time K1 at fixed shapes (the kernel's rows in PERF.md); the
# sweep's objective is a recorded serve (`record_serve_steps`).
SERVE_TRACE_CASES: Dict[str, Case] = {
    "decode": ([(d, 1) for d in DECODE_DEPTHS], 8, 1),
    "mixed": ([(d, 1) for d in (64, 700, 1400, 1999, 333, 1024)] + [(300, 128), (0, 0)], 136, 1),
    "verify": ([(d, 5) for d in (10, 400, 900, 1300, 1700, 2040, 555)] + [(0, 0)], 40, 1),
}


def record_serve_steps(gen, trace, serving) -> Tuple[List[Tuple[tuple, int]], int]:
    """K1's work in every step of one serve: `trace` ((rid, prompt, new
    tokens) requests without stop sequences) through an eager engine over
    `gen` with `serving`'s knobs, K1 on its wrapper (the plain version on
    the CPU).  Returns (steps, table width in blocks), one (spans, T) per
    target forward.  Which steps a serve takes depends on the trace and
    the knobs, not on the weights, so a one-layer model of the same
    vocabulary records a full-size model's steps."""
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.serving.engine import ServingEngine

    if serving.spec_k or serving.draft_model:
        raise ValueError("record_serve_steps: speculative serves interleave draft forwards; "
                         "record a serve without --spec-k")
    engine = ServingEngine(gen, dataclasses.replace(serving, use_kernel=True), _graphs=False)
    for rid, prompt, new in trace:
        engine.add_request(rid, prompt, new)
    calls, real = [], pa.ragged_paged_attention

    def recording(q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos, **kw):
        spans = tuple((ln - n, n) if n else (0, 0)
                      for n, ln in zip(q_len.tolist(), lens.tolist()))
        calls.append((spans, q.shape[2]))
        return real(q, k_pool, v_pool, block_tables, q_start, q_len, lens, q_pos, **kw)

    forwards = engine.forward_calls
    pa.ragged_paged_attention = recording
    try:
        engine.run()
    finally:
        pa.ragged_paged_attention = real
    L, forwards = gen.cfg.n_layer, engine.forward_calls - forwards
    if len(calls) != L * forwards:
        raise RuntimeError(f"record_serve_steps: {len(calls)} K1 calls over {forwards} "
                           f"forwards of {L} layers")
    return calls[::L], engine.max_blocks_per_seq


def trace_cases(steps) -> Dict[str, Case]:
    """`record_serve_steps`' steps as sweep cases: equal steps merged, each
    weighted by its count, labelled by kind ("decode": at most one token
    per slot, K1's decode plan; "mixed": any other) and first index."""
    counts: Dict[Tuple[tuple, int], int] = {}
    for step in steps:
        counts[step] = counts.get(step, 0) + 1
    return {f"{'decode' if T <= len(spans) else 'mixed'}{i}": (list(spans), T, n)
            for i, ((spans, T), n) in enumerate(counts.items())}


def make_case(spans, T, n_head, n_groups, head_size, block_size, max_blocks, dtype,
              device, seed=0):
    """A packed ragged batch over a random pool with shuffled blocks:
    spans is one (first position, n_tokens) per slot, n_tokens 0 = absent;
    rows past the spans are padding at a position past every table.
    Returns (args of the wrapper, owned rows)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    S, MB, BS = len(spans), max_blocks, block_size
    NB = 1 + S * MB
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    q = randn(1, n_head, T, head_size)
    k, v = randn(NB, BS, n_groups, head_size), randn(NB, BS, n_groups, head_size)
    tables = rng.permutation(np.arange(1, NB))[: S * MB].reshape(S, MB)
    q_start, q_len = np.zeros(S, np.int32), np.zeros(S, np.int32)
    q_pos = np.full(T, MB * BS, np.int32)
    off = 0
    for s, (p0, n) in enumerate(spans):
        q_start[s], q_len[s] = off, n
        q_pos[off:off + n] = np.arange(p0, p0 + n)
        off += n
    lens = q_pos[np.clip(q_start, 0, T - 1)] + q_len

    def ints(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    return (q, k, v, ints(tables), ints(q_start), ints(q_len), ints(lens), ints(q_pos)), off


def _time_ms(fn, reps: int, cuda: bool) -> float:
    """Mean ms of `fn()` over `reps` launches queued back to back (CUDA
    events on the card; the host clock on the CPU)."""
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    # mdi-lint: disable-next-line=host-sync -- CUDA-event timing harness: drain before queueing the launches
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000 * reps)  # the card waits while the launches queue
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1.5e-2}


def autotune(
    n_head: int, n_groups: int, head_size: int, cases: Dict[str, Case],
    block_size: int = 16, max_blocks: int = 128, dtype=torch.bfloat16, device="cuda",
    reps: int = 20, candidates: Optional[List[KernelParams]] = None,
) -> Tuple[KernelParams, List[Dict[str, Any]]]:
    """Sweep `candidates` (default `candidate_params()`) for one geometry
    over `cases` (label: (spans, T, weight), e.g. `trace_cases` of a
    recorded serve) and return (winner, results).  In each case every
    distinct plan the candidates give is held against K1's plain version
    (run in float32 on the same inputs; float32 within 1e-4, bfloat16
    within 1.5e-2, rows no slot owns zero), and raises if it disagrees,
    then timed once; one case's inputs are alive at a time.  Results: one
    {"params", "ms": {kind: weighted ms}, "total_ms", "max_abs_err"} per
    candidate, a kind being a label without its trailing digits; the
    winner has the least weighted total, the earliest of equals
    (`DEFAULT_PARAMS` comes first)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    candidates = candidate_params() if candidates is None else candidates
    for cand in candidates:
        problems = validate_kernel_params(cand, n_head, head_size)
        if problems:
            raise ValueError(f"candidate {cand}: " + "; ".join(problems))
    scale = head_size ** -0.5
    results = [{"params": c.to_dict(), "ms": {}, "max_abs_err": 0.0} for c in candidates]
    for i, (label, (spans, T, weight)) in enumerate(cases.items()):
        args, owned = make_case(spans, T, n_head, n_groups, head_size, block_size,
                                max_blocks, dtype, device, seed=i + 1)
        ref_args = [a.float() if a.is_floating_point() else a for a in args]
        ref = rpa.ragged_paged_attention_plain(*ref_args, scale=scale)
        del ref_args
        kind = label.rstrip("0123456789")
        measured: Dict[Tuple[int, int], Tuple[float, float]] = {}
        for cand, row in zip(candidates, results):
            plan = rpa.plan_for(args[0], args[1], args[3], cand)
            key = (plan["chunk"], plan["n_chunks"])
            if key not in measured:
                if cuda:
                    def run(cand=cand):
                        return rpa.ragged_paged_attention(*args, scale=scale, params=cand)
                else:
                    def run(chunk=plan["chunk"]):
                        return rpa.split_attention_plain(*args, scale=scale, chunk=chunk)
                out = run()
                # mdi-lint: disable-next-line=host-sync -- sweep correctness check, off the timed path
                err = (out.float()[:, :, :owned] - ref[:, :, :owned]).abs().max().item()
                # mdi-lint: disable-next-line=host-sync -- sweep correctness check, off the timed path
                pad = out[:, :, owned:].abs().max().item() if owned < out.shape[2] else 0.0
                if not err <= TOLERANCE[dtype] or pad != 0.0:
                    raise RuntimeError(
                        f"K1 with {cand} disagrees with its plain version on the "
                        f"{label} case: max |err| {err} (tolerance {TOLERANCE[dtype]}), "
                        f"rows no slot owns up to {pad}")
                measured[key] = (_time_ms(run, reps, cuda), err)
            ms, err = measured[key]
            row["ms"][kind] = row["ms"].get(kind, 0.0) + weight * ms
            row["max_abs_err"] = max(row["max_abs_err"], err)
        del args, ref
    for row in results:
        row["total_ms"] = sum(row["ms"].values())
    best = min(results, key=lambda r: r["total_ms"])  # min keeps the earliest of equals
    return KernelParams.from_dict(best["params"]), results


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "unknown"


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Record a serve's steps, sweep K1's split parameters over them for
    the model's geometry, and write the winner as a tuning table (read
    back through MDI_TUNE_TABLE)."""
    from mdi_llm_tpu_torch.cli import serve as serve_cli
    from mdi_llm_tpu_torch.cli._common import DTYPES, config_overrides
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator, resolve_device
    from mdi_llm_tpu_torch.models import transformer

    ap = serve_cli.build_parser()
    ap.prog = "python -m mdi_llm_tpu_torch.ops.tuning"
    ap.description = (
        "Autotune kernel K1's split of the key walk (min_chunk, max_chunks, decode_chunk, "
        "decode_max_chunks) for --model's geometry on this card: the serve the flags "
        "describe (the serve CLI's; default 16 synthetic requests, 64 new tokens, a "
        "2048-token window) is recorded on a one-layer stand-in of the model, and every "
        "candidate is timed over its steps, each weighted by how often it occurs.  The "
        "winner is written as a JSON tuning table; point MDI_TUNE_TABLE at it to serve "
        "with it.  The parameters are resolved before any step graph is captured, so "
        "they add no capture after warm-up.  The pool is swept in --dtype.")
    ap.add_argument("--reps", type=int, default=20, help="launches timed per plan and step")
    ap.add_argument("--out", default="k1-tune.json", help="tuning table to write")
    ap.set_defaults(synthetic=16, n_tokens=64, sequence_length=2048)
    args = ap.parse_args(argv)
    if not args.model or args.ckpt:
        ap.error("--model NAME (with --override KEY=VALUE) names the geometry; no --ckpt")
    if (not args.synthetic or args.spec_k or args.draft_model or args.kv_dtype != "auto"
            or args.quantize != "none"):
        ap.error("the sweep records a --synthetic serve over a pool of --dtype, without "
                 "--spec-k, --draft-model, --kv-dtype or --quantize")
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = Config.from_name(args.model, **config_overrides(args.override))
    stand_in = dataclasses.replace(cfg, n_layer=1)
    gen = Generator(stand_in, transformer.init_params(stand_in, args.seed, dtype=dtype,
                                                      device=device),
                    max_seq_length=args.sequence_length, device=device)
    trace = serve_cli.synthetic_trace(args.synthetic, cfg.vocab_size, args.sequence_length,
                                      args.n_tokens)
    steps, max_blocks = record_serve_steps(gen, trace, serve_cli.make_serving_config(args))
    del gen
    cases = trace_cases(steps)
    card = _device_name(device) if device.type == "cuda" else "cpu"
    where = power_limit() if device.type == "cuda" else "cpu"
    best, results = autotune(cfg.n_head, cfg.n_query_groups, cfg.head_size, cases,
                             args.block_size, max_blocks, dtype=dtype, device=device,
                             reps=args.reps)
    key = geometry_key(card, cfg.n_head, cfg.n_query_groups, cfg.head_size, args.block_size,
                       dtype, dtype)
    entry = {**best.to_dict(), "card": where,
             "measured_by": "python -m mdi_llm_tpu_torch.ops.tuning"}
    save_tuning_table(args.out, card, {key: entry}, timings_ms={key: results})
    default = results[0]
    won = next(r for r in results if r["params"] == best.to_dict())
    alike: Dict[tuple, List[Dict[str, Any]]] = {}  # the same plan in every step
    for r in results:
        alike.setdefault(tuple(sorted(r["ms"].items())), []).append(r)
    for rows in sorted(alike.values(), key=lambda rows: rows[0]["total_ms"]):
        mark = " <-- winner" if won in rows else ""
        print(f"  {len(rows)} candidates timed alike, first {rows[0]['params']}: "
              f"{json.dumps({k: round(v, 5) for k, v in rows[0]['ms'].items()})} total "
              f"{rows[0]['total_ms']:.5f} ms{mark}")
    print(f"{key}: winner {best.to_dict()} {won['total_ms']:.5f} ms against the default's "
          f"{default['total_ms']:.5f} ms of K1 per layer over the {len(steps)} steps of "
          f"{args.synthetic} requests ({len(cases)} distinct; {len(results)} candidates); "
          f"on {where}; wrote {args.out}")
    return {"key": key, "winner": best, "results": results, "card": where,
            "steps": len(steps), "cases": cases}


if __name__ == "__main__":  # pragma: no cover
    main()
    sys.exit(0)
