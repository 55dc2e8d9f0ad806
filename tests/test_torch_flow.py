"""The port's `flow` (`mdi_llm_tpu_torch/analysis/liveness.py`) and `check`
(`analysis/check.py`) against the JAX package's `mdi-flow` and
`mdi-check`, on the CPU.

- every rule has a planted fixture it must catch and a clean twin it must
  pass; the storage model's traps each have a case with its exact bytes:
  a view adds nothing and keeps its base alive, an in-place op returns
  its argument's storage, K1's operator counts its output and its split
  workspace as temporaries at its node;
- per step, the params and pool bytes in float32 and bfloat16 equal the
  JAX `ExecProfile`'s arithmetic over the JAX engine's specs, per device
  under tp; so do hbm-over-budget's params and pool terms (single, tp 2,
  pp 2, an int8 pool);
- the committed port goldens (`mdi_llm_tpu_torch/analysis/
  flow-goldens.json`) match the current compile set of the JAX goldens'
  origins;
- `check --model pythia-14m` is clean and never touches a backend (the
  kernel loader and CUDA's entry points trip-wired);
- `audit --liveness` takes the flow's worst temporaries' peak;
- the CLIs: exit codes, `--format json`, goldens round trip, budget,
  suppression, `--list-checks`, `--skip`.
"""

import json
from pathlib import Path

import jax
import pytest
import torch

from mdi_llm_tpu.analysis import ir as jir
from mdi_llm_tpu.analysis import liveness as jlv
from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.config import ServingConfig as JServing
from mdi_llm_tpu_torch.analysis import check, ir
from mdi_llm_tpu_torch.analysis import liveness as lv
from mdi_llm_tpu_torch.config import Config, ServingConfig
from mdi_llm_tpu_torch.obs.device import StepSpec
from mdi_llm_tpu_torch.ops.ragged_paged_attention import OP as K1

torch.set_num_threads(1)
MODEL = "pythia-14m"
META = torch.device("meta")
REPO = Path(__file__).resolve().parent.parent
MiB = 2**20


def rules_of(findings):
    return sorted({f.rule for f in findings})


def empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


class Owner:
    def __init__(self):
        self.w = empty(4, 256, 256)  # four "layers" of stacked weights
        self.pool = empty(2, 512, 256)  # 1 MiB


def spec_of(body, owner=None, writes=("kv",), **inputs):
    owner = owner or Owner()
    args = {"params": owner.w, "kv": owner.pool, **inputs}
    return StepSpec("t", (1,), body, owner, args, None, {"params": "params", "kv": "kv"},
                    ("params", "kv"), writes)


# ---------------------------------------------------------------------------
# rules: planted / clean
# ---------------------------------------------------------------------------


def returns_a_new_pool(o, x):
    return o.pool * 2


def updates_the_pool(o, x):
    o.pool.mul_(2)
    return x.sum()


def carries_dead_payload(o, x):
    dead = x.repeat(4, 1)  # 4 MiB, read again only after every layer
    for layer in range(4):
        x = x @ o.w[layer]
    return (x + dead[:1024]).sum(0)


def reads_it_every_layer(o, x):
    live = x.repeat(4, 1)
    for layer in range(4):
        x = x @ o.w[layer] + live[:1024]
    return x.sum(0)


def explodes(o, x):
    raise RuntimeError("boom")


X = dict(x=empty(1024, 256))  # 1 MiB

FIXTURES = {
    "missed-donation": (spec_of(returns_a_new_pool, writes=(), **X),
                        spec_of(updates_the_pool, **X)),
    "live-range-bloat": (spec_of(carries_dead_payload, **X),
                         spec_of(reads_it_every_layer, **X)),
    "trace-failure": (spec_of(explodes, **X), spec_of(updates_the_pool, **X)),
}


def test_every_rule_has_a_fixture_pair():
    tested = set(FIXTURES) | {"hbm-over-budget", "peak-memory-regression", "graph-drift"}
    assert tested == set(lv.FLOW_RULES)
    # the JAX names, jaxpr-drift renamed: the port's graphs are fx graphs
    assert [r if r != "graph-drift" else "jaxpr-drift" for r in lv.FLOW_RULES] == list(
        jlv.FLOW_RULES)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_planted_fixture_caught_and_clean_twin_passes(rule):
    planted, clean = FIXTURES[rule]
    findings, _ = lv.analyze_flow([planted], origin="t")
    assert rules_of(findings) == [rule], [f.message for f in findings]
    findings, profiles = lv.analyze_flow([clean], origin="t")
    assert findings == [] and len(profiles) == 1


def test_live_range_bloat_names_the_site_and_min_bytes_silences_it():
    findings, _ = lv.analyze_flow([FIXTURES["live-range-bloat"][0]], origin="t")
    assert "aten.repeat" in findings[0].message and "3 whole unrolled" in findings[0].message
    findings, _ = lv.analyze_flow([FIXTURES["live-range-bloat"][0]], origin="t",
                                  min_bytes=8 * MiB)
    assert findings == []


def test_goldens_rules_regression_and_drift(tmp_path):
    _, profiles = lv.analyze_flow([FIXTURES["missed-donation"][1]], origin="t")
    (p,) = profiles
    path = tmp_path / "g.json"
    data = lv.write_goldens(path, "t", profiles)
    assert lv._check_goldens(profiles, lv.load_goldens(path), "t") == []
    data["budgets"]["t::t(1)"].update(peak_bytes=p.peak_bytes // 2, digest="0" * 16,
                                      ops={"aten.mul_.Tensor": 3})
    findings = lv._check_goldens(profiles, data, "t")
    assert rules_of(findings) == ["graph-drift", "peak-memory-regression"]
    assert "-2 aten.mul_.Tensor" in [f for f in findings if f.rule == "graph-drift"][0].message
    lv.write_goldens(path, "other", profiles)  # other origins are kept
    assert set(lv.load_goldens(path)["budgets"]) == {"t::t(1)", "other::t(1)"}
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="budgets"):
        lv.load_goldens(tmp_path / "bad.json")


# ---------------------------------------------------------------------------
# the storage model's traps, byte for byte
# ---------------------------------------------------------------------------


def views_only(o, x):
    y = x * 2  # the one temporary: 1 MiB
    v = y.view(256, 1024).t().unsqueeze(0).expand(2, -1, -1)[0]
    return v.sum()


def in_place(o, x):
    y = x * 2
    y.add_(1).mul_(3)
    y.transpose(0, 1)[0].zero_()
    return y.sum()


def k1_workspace(o, q, k, v, tables, q_start, q_len, lens, q_pos):
    out, ws = K1(q, k, v, None, None, tables, q_start, q_len, lens, q_pos, 0.125, 64, 4)
    return out.sum()


@pytest.mark.parametrize("body,temp", [
    (views_only, MiB), (in_place, MiB),
    # K1's output (1, 8, 16, 64) f32 and its split workspace, 4 chunks of
    # 8 heads x 16 rows x (64 + 2) f32
    (k1_workspace, 8 * 16 * 64 * 4 + 4 * 8 * 16 * 66 * 4),
], ids=["view", "in-place", "k1-workspace"])
def test_temporaries_follow_storage_not_nodes(body, temp):
    i32 = torch.int32
    inputs = dict(X) if body is not k1_workspace else dict(
        q=empty(1, 8, 16, 64), k=empty(32, 16, 2, 64), v=empty(32, 16, 2, 64),
        tables=empty(4, 8, dtype=i32), q_start=empty(4, dtype=i32),
        q_len=empty(4, dtype=i32), lens=empty(4, dtype=i32), q_pos=empty(16, dtype=i32))
    _, (p,) = lv.analyze_flow([spec_of(body, writes=(), **inputs)], origin="t")
    # the returned scalar is an output; every other value lives in `temp`
    assert p.temp_peak_bytes == temp
    assert p.output_bytes == 4 and p.alias_bytes == 0


def test_profile_counts_in_place_pool_writes_as_aliases():
    _, (p,) = lv.analyze_flow([FIXTURES["missed-donation"][1]], origin="t")
    assert p.pool_bytes == p.alias_bytes == MiB and p.params_bytes == 4 * 256 * 256 * 4
    assert p.peak_bytes == p.argument_bytes + 4  # pool updated in place, scalar out


# ---------------------------------------------------------------------------
# bytes against the JAX package
# ---------------------------------------------------------------------------

_ENGINES = {}


def engines(serving, tp=1, pp=1, dtype="bfloat16"):
    key = (json.dumps(serving, sort_keys=True), tp, pp, dtype)
    if key not in _ENGINES:
        _ENGINES[key] = (
            jir.trace_serving(JConfig.from_name(MODEL), JServing(**serving), tp=tp, pp=pp,
                              dtype=dtype, max_seq_length=256),
            ir.trace_serving(Config.from_name(MODEL), ServingConfig(**serving), tp=tp, pp=pp,
                             dtype=dtype, max_seq_length=256))
    return _ENGINES[key]


def jax_role_bytes(jeng, spec):
    """(params, pool, params per device, pool per device) of a JAX spec,
    as `profile_executable` attributes them: the pool by its declared
    sharding, the params by `_params_device_fraction` of the whole tree
    (the JAX profile applies the fraction leaf by leaf and truncates each
    product, a few bytes under; the fraction of the whole is exact)."""
    fraction = jlv._params_device_fraction(jeng.gen)
    out = [0, 0, 0, 0]
    for argnum, role in (spec.roles or {}).items():
        for leaf in jax.tree_util.tree_leaves(spec.args[argnum]):
            nb = jlv._aval_nbytes(leaf)
            if role == "params":
                out[0] += nb
            elif role == "kv":
                out[1] += nb
                out[3] += nb // jir.sharding_denom(leaf)
    out[2] = round(out[0] * fraction) if fraction is not None else out[0]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [1, 2])
def test_params_and_pool_bytes_equal_the_jax_profiles(devices, dtype, tp):
    jeng, teng = engines(dict(decode_chunk=2), tp=tp, dtype=dtype)
    want = {s.name: jax_role_bytes(jeng, s) for s in jeng.enumerate_executables()}
    report = lv.flow_preflight(teng, origin="t")
    assert report.findings == []
    got = {p.name: [p.params_bytes, p.pool_bytes, p.device_params_bytes, p.device_pool_bytes]
           for p in report.profiles}
    assert got == want
    if tp > 1:
        assert all(p.device_peak_bytes < p.peak_bytes for p in report.profiles)


@pytest.mark.parametrize("serving,tp,pp", [
    (dict(), 1, 1), (dict(), 2, 1), (dict(), 1, 2), (dict(kv_dtype="int8"), 2, 1),
    (dict(host_pool_mib=1), 1, 1),
], ids=["single", "tp2", "pp2", "int8-tp2", "host-tier"])
def test_hbm_budget_terms_equal_the_jax_ones(devices, serving, tp, pp):
    jeng, teng = engines(serving, tp=tp, pp=pp)
    want, got = {}, {}
    assert jlv._check_hbm_budget(jeng, [], "t", 1e-6, want)
    assert lv._check_hbm_budget(teng, [], "t", 1e-6, got)
    want, got = want["per_device"], got["per_device"]
    if pp > 1:
        # the JAX ring pads every stage to the largest (l_max layers per
        # device); the port's stage 0 holds its own, fewer, layers beside
        # the head: the difference is those layers' bytes
        counts = teng._stage_counts
        per_layer = sum(x.numel() * x.element_size()
                        for x in lv.leaves_of(teng.gen.params["blocks"])) // sum(counts)
        assert got["params_bytes"] == want["params_bytes"] - (
            max(counts) - counts[0]) * per_layer > 0
        got["params_bytes"] = want["params_bytes"]
    for k in ("params_bytes", "pool_bytes", "host_credit_bytes"):
        assert got[k] == want[k], k


def test_hbm_over_budget_and_its_breakdown():
    _, teng = engines(dict(decode_chunk=2))
    report = lv.flow_preflight(teng, origin="t", hbm_gb=0.01)
    assert rules_of(report.findings) == ["hbm-over-budget"]
    dev = report.breakdown["per_device"]
    worst = max(report.profiles, key=lambda p: p.temp_peak_bytes)
    assert dev["worst_executable"] == worst.name
    assert dev["high_water_bytes"] > dev["params_bytes"] + dev["pool_bytes"]
    assert lv.flow_preflight(teng, origin="t", hbm_gb=1).findings == []


# ---------------------------------------------------------------------------
# goldens, the self-check, audit --liveness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("origin,kw", [
    (MODEL, dict()), (f"{MODEL}@tp2", dict(tp=2)), (f"{MODEL}@pp2", dict(pp=2)),
    (f"{MODEL}@spec4@draft", dict(serving=ServingConfig(spec_k=4, temperature=0.8,
                                                        draft_model=MODEL))),
])
def test_committed_goldens_match_the_current_compile_set(origin, kw):
    """The port's goldens stay in sync with the compile set of the JAX
    goldens' origins; drift means: review the churn, then `flow --model
    pythia-14m [--tp 2 | --pp 2 | --spec-k 4 --temperature 0.8
    --draft-model pythia-14m] --update-goldens` deliberately."""
    goldens = lv.load_goldens(lv.DEFAULT_GOLDENS)
    engine = ir.trace_serving(Config.from_name(MODEL), kw.pop("serving", None), **kw)
    report = lv.flow_preflight(engine, origin=origin, goldens=goldens)
    assert report.findings == [], "\n".join(f.message for f in report.findings)
    assert {f"{origin}::{p.name}" for p in report.profiles} <= set(goldens["budgets"])
    want = {k.split("::")[0] for k in json.loads(
        (REPO / "goldens" / "flow-goldens.json").read_text())["budgets"]}
    assert {k.split("::")[0] for k in goldens["budgets"]} == want


def test_check_is_clean_and_never_touches_a_backend(monkeypatch, capsys):
    from mdi_llm_tpu_torch import kernels

    def boom(*a, **k):
        raise AssertionError("the analysis touched a backend")

    for name in ("init", "is_available", "get_device_properties", "get_device_name",
                 "current_device", "device_count", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(kernels, "library", boom)
    monkeypatch.setattr(kernels, "build", boom)
    assert check.main(["--model", MODEL]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "check: PASS"
    assert all(f"  {fam:<6} clean" in out for fam in check.FAMILIES)


def test_check_json_skip_usage_and_list_checks(capsys):
    argv = ["--model", MODEL, "--seq-len", "256", "--decode-chunk", "2", "--skip", "lint"]
    assert check.main(argv + ["--skip", "audit", "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["families"]) == {"ir", "flow"} and out["errors"] == 0
    assert set(out["families"]["flow"]["peak_bytes"]) == {"mixed(8,136)", "decode_chunk(8,2)"}
    assert check.main(argv + ["--hbm-gb", "0.01", "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["families"]["flow"]["errors"] == 1 and out["families"]["audit"]["errors"] >= 1
    assert check.main(["--skip", "audit", "--skip", "ir", "--skip", "flow", "--paths",
                       str(REPO / "mdi_llm_tpu_torch" / "analysis")]) == 0
    capsys.readouterr()
    assert check.main([]) == 2 and "need --model" in capsys.readouterr().err
    assert check.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert {line.split(":")[0] for line in out.splitlines()} == set(check.FAMILIES)
    assert "flow:graph-drift" in out and "ir:dropped-donation" in out


def test_audit_liveness_takes_the_flows_worst_temporaries():
    """`audit --liveness` replaces the analytic activation term with the
    flow's worst temporaries' peak on the same engine tuple, and keeps the
    heuristic where no engine can be enumerated."""
    from mdi_llm_tpu_torch.analysis.audit import main as audit_main, preflight

    cfg = Config.from_name(MODEL)
    serving = ServingConfig(decode_chunk=2)
    rep = preflight(cfg, serving=serving, seq_len=256, origin="t", liveness=True)
    dev = rep.breakdown["per_device"]
    assert dev["act_source"] == "liveness"
    _, teng = engines(dict(decode_chunk=2))
    _, profiles = lv.analyze_flow(ir.trace_engine(teng))
    assert dev["act_bytes"] == max(p.temp_peak_bytes for p in profiles)
    heur = preflight(cfg, serving=serving, seq_len=256, origin="t")
    assert heur.breakdown["per_device"]["act_source"] == "heuristic"
    dense = preflight(cfg, seq_len=256, origin="t", liveness=True)
    assert dense.breakdown["per_device"]["act_source"] == "heuristic"
    assert audit_main(["--model", MODEL, "--serve", "--seq-len", "256", "--liveness",
                       "--format", "json"]) == 0


# ---------------------------------------------------------------------------
# the flow CLI
# ---------------------------------------------------------------------------

FAST = ["--model", MODEL, "--seq-len", "256", "--decode-chunk", "2"]


def test_flow_cli(capsys, tmp_path):
    assert lv.main(FAST + ["--tp", "2"]) == 0
    assert "findings: none" in capsys.readouterr().out
    assert lv.main(FAST + ["--hbm-gb", "0.01", "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["errors"] == 1 and out["findings"][0]["rule"] == "hbm-over-budget"
    assert lv.main(FAST + ["--hbm-gb", "0.01", "--suppress",
                           "hbm-over-budget=a small card, known"]) == 0
    capsys.readouterr()
    gold = tmp_path / "g.json"
    assert lv.main(FAST + ["--goldens", str(gold), "--update-goldens", "--sequential",
                           "--batch", "2", "--prompt-len", "8", "--new-tokens", "5",
                           "--chunk-size", "4"]) == 0
    assert "wrote 4 budget(s)" in capsys.readouterr().out
    assert set(lv.load_goldens(gold)["budgets"]) == {
        f"{MODEL}::mixed(8,136)", f"{MODEL}::decode_chunk(8,2)",
        f"{MODEL}:generate::prefill(2,16)", f"{MODEL}:generate::decode_chunk(2,4)"}
    assert lv.main(FAST + ["--goldens", str(gold)]) == 0
    capsys.readouterr()
    base = tmp_path / "base.json"
    assert lv.main(FAST + ["--hbm-gb", "0.01", "--update-baseline", str(base)]) == 0
    capsys.readouterr()
    assert lv.main(FAST + ["--hbm-gb", "0.01", "--baseline", str(base)]) == 0
    capsys.readouterr()
    assert lv.main(FAST + ["--suppress", "hbm-over-budget"]) == 2
    assert "justification" in capsys.readouterr().err
    assert lv.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert all(r in out for r in lv.FLOW_RULES)
    assert lv.main(["--model", MODEL, "--goldens", str(tmp_path / "missing.json")]) == 2
