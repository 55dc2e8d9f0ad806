"""The port's tuning tables for kernel K1 (`mdi_llm_tpu_torch/ops/tuning.py`)
against the JAX package's (`mdi_llm_tpu/ops/tuning.py`), on the CPU.

- Precedence: explicit `params=` over the `MDI_TUNE_TABLE` table over the
  committed entries over `DEFAULT_PARAMS`, with the JAX package's meta
  (`tuned` only for a user table's entry) in the same four situations.
- Validation: chunks that are no multiple of the key tile, chunk counts
  past the merge kernel's 32, an oversized workspace, unknown or missing
  fields all raise and name the entry; a table the JAX package's `mdi-tune`
  wrote (its `kv_step`/`q_pack`/`scratch_width` fields) is refused.
- The plan: tuned knobs change only the split; the plain split with a
  tuned chunk gives the unsplit plain version's rows and the JAX kernel's
  (interpret mode) within 2e-5.
- `kernel_params_for` resolves once per geometry and table; a serve's
  recorded K1 steps do not depend on the model that records them;
  `autotune` weighs each step by its count; `autotune` and the CLI run
  their flow on the CPU (the plain split per candidate) and write a table
  that resolves back.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.ops import tuning as jtune
from mdi_llm_tpu.ops.ragged_paged_attention import ragged_paged_attention as jax_k1
from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa
from mdi_llm_tpu_torch.ops import tuning
from tests.test_torch_paged_attention import make_pool, pack, t

torch.set_num_threads(1)
H100 = "NVIDIA H100 80GB HBM3"
GEOM = dict(n_head=32, n_groups=8, head_size=128, block_size=16)
TUNED = tuning.KernelParams(min_chunk=256, max_chunks=8, decode_chunk=128, decode_max_chunks=16)


def resolve(**kw):
    return tuning.resolve_kernel_params(
        GEOM["n_head"], GEOM["n_groups"], GEOM["head_size"], GEOM["block_size"],
        torch.bfloat16, torch.bfloat16, **kw)


def key(device=H100):
    return tuning.geometry_key(device, GEOM["n_head"], GEOM["n_groups"], GEOM["head_size"],
                               GEOM["block_size"], torch.bfloat16, torch.bfloat16)


def write_table(path, entries):
    tuning.save_tuning_table(str(path), H100, entries)
    return str(path)


def test_geometry_key_names_the_card_and_both_dtypes():
    k = key()
    assert k.startswith(H100 + "|32h8g128hs|bs16")
    assert "q=bfloat16" in k and "kv=bfloat16" in k
    other = tuning.geometry_key(H100, 32, 8, 128, 16, torch.float32, torch.int8)
    assert "q=float32" in other and "kv=int8" in other and other != k
    assert key("NVIDIA A100-SXM4-80GB") != k


@pytest.mark.parametrize("level", ["explicit", "table", "builtin", "conservative"])
def test_precedence_matches_the_jax_packages(level, tmp_path, monkeypatch):
    monkeypatch.delenv(tuning.TUNE_TABLE_ENV, raising=False)
    monkeypatch.delenv(jtune.TUNE_TABLE_ENV, raising=False)
    table = tuning.KernelParams(64, 32, 32, 32)
    builtin = tuning.KernelParams(512, 4, 128, 8)
    if level == "conservative":  # a geometry without a committed entry
        monkeypatch.delitem(tuning.BUILTIN_TUNING_TABLE, key(), raising=False)
    else:
        monkeypatch.setitem(tuning.BUILTIN_TUNING_TABLE, key(), builtin.to_dict())
    kw, jkw = {}, {}
    if level in ("explicit", "table"):
        path = write_table(tmp_path / "t.json", {key(): table.to_dict()})
        monkeypatch.setenv(tuning.TUNE_TABLE_ENV, path)
        jpath = str(tmp_path / "j.json")
        jk = jtune.geometry_key(32, 8, 128, None, 16)
        jtune.save_tuning_table(jpath, "TPU v5 lite", {jk: {"kv_step": 8}})
    if level == "explicit":
        kw["params"] = TUNED
        jkw["params"] = jtune.KernelParams(kv_step=8)
    got, meta = resolve(device_kind=H100, **kw)
    want = {"explicit": TUNED, "table": table, "builtin": builtin,
            "conservative": tuning.DEFAULT_PARAMS}[level]
    assert got == want and meta["key"] == key()
    assert meta["table_source"].split(":")[0] == {"table": "file"}.get(level, level)
    # the JAX package's resolution in the same situation: a user table's
    # entry is "tuned", nothing else is
    if level == "table":
        jkw["table_path"] = jpath
    jdev = "TPU v5 lite" if level == "builtin" else None
    _jp, jmeta = jtune.resolve_kernel_params(32, 8, 128, 16, device_kind=jdev, **jkw)
    assert meta["tuned"] == jmeta["tuned"] == (level == "table")


@pytest.mark.parametrize("entry,match", [
    (dict(TUNED.to_dict(), min_chunk=48), "min_chunk=48 must be a positive multiple"),
    (dict(TUNED.to_dict(), decode_chunk=0), "decode_chunk=0"),
    (dict(TUNED.to_dict(), max_chunks=64), r"max_chunks=64 must lie in \[1, 32\]"),
    (dict(TUNED.to_dict(), decode_max_chunks=0), "decode_max_chunks=0"),
    (dict(TUNED.to_dict(), chunk=64), r"unknown fields \['chunk'\]"),
    ({"min_chunk": 128}, "missing fields"),
], ids=["min_chunk", "decode_chunk", "max_chunks", "decode_max_chunks", "unknown", "missing"])
def test_an_invalid_entry_raises_and_names_it(entry, match, tmp_path, monkeypatch):
    path = write_table(tmp_path / "bad.json", {key(): entry})
    monkeypatch.setenv(tuning.TUNE_TABLE_ENV, path)
    with pytest.raises(ValueError, match=match) as e:
        resolve(device_kind=H100)
    assert key() in str(e.value) and path in str(e.value)
    # an entry of another geometry is checked too: no quiet fallback
    other = write_table(tmp_path / "other.json", {"elsewhere": entry})
    with pytest.raises(ValueError, match="'elsewhere'"):
        resolve(device_kind=H100, table_path=other)
    monkeypatch.setitem(tuning.BUILTIN_TUNING_TABLE, key(), entry)
    monkeypatch.delenv(tuning.TUNE_TABLE_ENV)
    with pytest.raises(ValueError, match="committed entry"):
        resolve(device_kind=H100)


def test_workspace_and_explicit_params_are_validated():
    assert tuning.validate_kernel_params(tuning.DEFAULT_PARAMS, 32, 128) == []
    problems = tuning.validate_kernel_params(tuning.KernelParams(128, 32, 64, 32), 32, 128,
                                             n_tokens=4096)
    assert len(problems) == 1 and "workspace" in problems[0]
    with pytest.raises(ValueError, match="params="):
        resolve(device_kind=H100, params=tuning.KernelParams(100, 16, 64, 32))
    for p in tuning.candidate_params():
        assert tuning.validate_kernel_params(p, 32, 128) == [], p


def test_a_jax_table_is_refused(tmp_path, monkeypatch):
    path = str(tmp_path / "mdi-tune.json")
    jk = jtune.geometry_key(32, 8, 128, None, 16)
    jtune.save_tuning_table(path, "TPU v5 lite",
                            {jk: jtune.KernelParams(kv_step=8, q_pack=1).to_dict()})
    monkeypatch.setenv(tuning.TUNE_TABLE_ENV, path)
    with pytest.raises(ValueError, match="JAX package's Pallas kernel parameters"):
        resolve(device_kind=H100)


def test_tuned_knobs_change_only_the_split():
    T, S, MB = 136, 8, 128
    default = rpa.split_plan(32, 8, T, S, 16, MB, 128, tuning.DEFAULT_PARAMS)
    tuned = rpa.split_plan(32, 8, T, S, 16, MB, 128, TUNED)
    assert (tuned["chunk"], tuned["n_chunks"]) == (256, 8)
    assert (default["chunk"], default["n_chunks"]) == (128, 16)
    decode = rpa.split_plan(32, 8, 8, S, 16, MB, 128, TUNED)
    assert (decode["chunk"], decode["n_chunks"]) == (128, 16)
    assert tuned["workspace"] == 8 * 32 * T * 130


@pytest.mark.parametrize("params", [TUNED, tuning.KernelParams(64, 4, 32, 8)],
                         ids=["256x8", "64x4"])
def test_plain_split_with_a_tuned_chunk_matches_the_dense_route_and_jax(params):
    """The split arithmetic with the tuned plan's chunk (a 512-key table:
    the mixed plan's chunk and count change) against the unsplit plain
    version and the JAX kernel in interpret mode, float32 at 2e-5."""
    H, G, hs, BS, MB, n_slots = 8, 2, 16, 8, 64, 3
    k, v, tables = make_pool(n_slots, G, hs, BS, MB, seed=11)
    spans = [(0, MB * BS - 9, 9), (2, 300, 1)]
    q, _, q_start, q_len, lens, q_pos, off = pack(spans, n_slots, H, hs, 14, seed=12,
                                                  pad_pos=MB * BS)
    args = [t(x) for x in (q, k, v, tables, q_start, q_len, lens, q_pos)]
    plan = rpa.plan_for(args[0], args[1], args[3], params)
    assert plan["n_chunks"] > 1
    scale = hs ** -0.5
    got = rpa.split_attention_plain(*args, scale=scale, chunk=plan["chunk"]).numpy()
    dense = rpa.ragged_paged_attention_plain(*args, scale=scale).numpy()
    want = np.asarray(jax_k1(*(jnp.asarray(x) for x in (q, k, v, tables, q_start, q_len,
                                                         lens, q_pos)),
                             scale=scale, interpret=True))
    np.testing.assert_allclose(got[:, :, :off], dense[:, :, :off], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[:, :, :off], want[:, :, :off], atol=2e-5, rtol=2e-5)
    assert not got[:, :, off:].any()
    # the CPU wrapper takes the plain version whatever the params
    np.testing.assert_array_equal(
        rpa.ragged_paged_attention(*args, scale=scale, params=params).numpy(), dense)


def test_kernel_params_for_resolves_once_per_geometry_and_table(tmp_path, monkeypatch):
    calls = []
    real = tuning.resolve_kernel_params
    monkeypatch.setattr(tuning, "resolve_kernel_params",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    monkeypatch.setattr(tuning, "_device_name", lambda index: H100)
    monkeypatch.setattr(tuning, "BUILTIN_TUNING_TABLE", {})
    monkeypatch.delenv(tuning.TUNE_TABLE_ENV, raising=False)
    tuning._resolved.cache_clear()
    q = torch.empty(1, 32, 8, 128, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(9, 16, 8, 128, dtype=torch.bfloat16, device="meta")
    try:
        for _ in range(3):
            assert tuning.kernel_params_for(q, pool) == tuning.DEFAULT_PARAMS
        assert len(calls) == 1
        monkeypatch.setenv(tuning.TUNE_TABLE_ENV,
                           write_table(tmp_path / "t.json", {key(): TUNED.to_dict()}))
        assert tuning.kernel_params_for(q, pool) == TUNED
        assert tuning.kernel_params_for(q, pool) == TUNED
        assert len(calls) == 2
    finally:
        tuning._resolved.cache_clear()


def test_autotune_flow_on_the_cpu():
    cases = {"decode0": ([(40, 1), (200, 1), (255, 1)], 3, 2),
             "mixed1": ([(3, 1), (100, 9), (0, 0)], 12, 1)}
    cands = [tuning.DEFAULT_PARAMS, TUNED, tuning.KernelParams(64, 4, 32, 8)]
    best, results = tuning.autotune(4, 2, 16, cases, block_size=8, max_blocks=32,
                                    dtype=torch.float32, device="cpu", reps=1,
                                    candidates=cands)
    assert best in cands and [r["params"] for r in results] == [c.to_dict() for c in cands]
    for r in results:
        assert set(r["ms"]) == {"decode", "mixed"} and r["total_ms"] > 0
        assert r["max_abs_err"] <= 1e-4
    won = min(results, key=lambda r: r["total_ms"])
    assert best.to_dict() == won["params"]


def test_autotune_weighs_each_case_by_its_count(monkeypatch):
    """The objective is K1's time summed over a serve's steps: a case
    stands for `weight` steps.  With a stand-in clock that charges a plan
    its chunk, a plan's time in a case is its chunk times the weight."""
    monkeypatch.setattr(tuning, "_time_ms", lambda fn, reps, cuda: float(fn.__defaults__[0]))
    decode, mixed = ([(40, 1), (200, 1)], 2), ([(3, 1), (100, 9)], 10)
    small, large = tuning.KernelParams(32, 32, 32, 32), tuning.KernelParams(64, 32, 256, 32)
    for wd, wm in ((5, 1), (1, 5)):
        cases = {"decode0": (*decode, wd), "mixed1": (*mixed, wm)}
        best, results = tuning.autotune(4, 2, 16, cases, block_size=8, max_blocks=32,
                                        dtype=torch.float32, device="cpu", reps=1,
                                        candidates=[large, small])
        assert results[0]["ms"] == {"decode": 256.0 * wd, "mixed": 64.0 * wm}
        assert results[1]["ms"] == {"decode": 32.0 * wd, "mixed": 32.0 * wm}
        assert results[1]["total_ms"] == 32.0 * (wd + wm) and best == small


def tiny_mixtral(n_layer, n_embd):
    from mdi_llm_tpu_torch.config import Config

    return Config.from_name("Mixtral-8x7B-v0.1", n_layer=n_layer, n_embd=n_embd, n_head=4,
                            n_query_groups=2, intermediate_size=32, vocab_size=96,
                            padded_vocab_size=96)


def record(cfg, seed):
    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.config import ServingConfig
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer

    gen = Generator(cfg, transformer.init_params(cfg, seed, dtype=torch.float32, device="cpu"),
                    max_seq_length=128, device="cpu")
    trace = synthetic_trace(4, 96, 128, 12)
    serving = ServingConfig(block_size=8, max_batch=2, decode_chunk=4)
    return (*tuning.record_serve_steps(gen, trace, serving), trace)


def test_a_serves_steps_do_not_depend_on_the_model():
    """A serve's K1 steps, recorded on two stand-ins of other depths,
    widths and weights, are the same steps; they feed every request's
    tokens (prompt + new tokens - 1 each; a decode step feeds every slot,
    idle lanes too), and the decode steps carry at most one token for each
    slot.  `trace_cases` merges equal steps into weights."""
    steps, mb, trace = record(tiny_mixtral(2, 32), seed=1)
    again, mb2, _ = record(tiny_mixtral(1, 64), seed=2)
    assert steps == again and mb == mb2 == 16
    fed = sum(n for spans, _T in steps for _p, n in spans)
    assert fed >= sum(len(p) + new - 1 for _rid, p, new in trace)
    for spans, T in steps:
        assert len(spans) == 2 and sum(n for _p, n in spans) <= T
        if T <= len(spans):
            assert all(n <= 1 for _p, n in spans)
    cases = tuning.trace_cases(steps + steps[:3])
    assert sum(w for _s, _T, w in cases.values()) == len(steps) + 3
    assert [w for _s, _T, w in cases.values()][:3] == [2, 2, 2]
    assert {label.rstrip("0123456789") for label in cases} == {"decode", "mixed"}


def test_tuning_cli_on_the_cpu_writes_a_table_that_resolves(tmp_path, monkeypatch, capsys):
    out = tmp_path / "k1.json"
    res = tuning.main(["--model", "Mixtral-8x7B-v0.1", "--override", "n_embd=64",
                       "--override", "n_head=4", "--override", "n_query_groups=2",
                       "--override", "intermediate_size=32", "--synthetic", "3",
                       "--n-tokens", "8", "--sequence-length", "128", "--block-size", "8",
                       "--max-batch", "2", "--dtype", "float32", "--reps", "1",
                       "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert doc["device_kind"] == "cpu" and list(doc["entries"]) == [res["key"]]
    assert res["key"].startswith("cpu|4h2g16hs|bs8|")
    assert len(doc["timings_ms"][res["key"]]) == len(tuning.candidate_params())
    assert sum(w for _s, _T, w in res["cases"].values()) == res["steps"] > 0
    assert "winner" in capsys.readouterr().out
    monkeypatch.setenv(tuning.TUNE_TABLE_ENV, str(out))
    got, meta = tuning.resolve_kernel_params(4, 2, 16, 8, torch.float32, torch.float32,
                                             device_kind="cpu")
    assert got == res["winner"] and meta["tuned"]


def test_tuning_cli_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        tuning.main(["--model", "tiny-llama-1.1b", "--out", str(tmp_path / "x.json")])


def test_committed_entries_are_valid_and_name_their_card():
    """The committed H100 entries (tiny-llama-1.1b's and Mixtral-8x7B's
    geometries, bf16) pass validation, carry the card's name and power
    limit, and resolve at precedence 3."""
    for name, (H, G, hs) in {"tiny-llama-1.1b": (32, 4, 64), "Mixtral-8x7B-v0.1": (32, 8, 128)}.items():
        k = tuning.geometry_key(H100, H, G, hs, 16, torch.bfloat16, torch.bfloat16)
        entry = tuning.BUILTIN_TUNING_TABLE[k]
        assert entry["card"].startswith(H100) and entry["card"].endswith("W")
        p = tuning.KernelParams.from_dict(entry, k)
        assert tuning.validate_kernel_params(p, H, hs) == []
        got, meta = tuning.resolve_kernel_params(H, G, hs, 16, torch.bfloat16, torch.bfloat16,
                                                 device_kind=H100)
        assert got == p and meta["table_source"] == "builtin" and not meta["tuned"], name
    # another card, or another dtype, falls to the constants
    got, meta = tuning.resolve_kernel_params(32, 8, 128, 16, torch.float32, torch.float32,
                                             device_kind=H100)
    assert got == tuning.DEFAULT_PARAMS and meta["table_source"] == "conservative"
