"""The port's plan audit (`mdi_llm_tpu_torch/analysis/audit.py`) against
the JAX package's (`mdi_llm_tpu/analysis/audit.py`), on the CPU.

- every registry config under the default plan, and a set of plans (tp 2
  and 3, pp 2, the ring at S 4, int8/w8a8/int4 weights, bf16 and int8
  pools, tp and draft pools, the host tier, over-budget and bad
  schedules): the same finding codes as the JAX `audit_plan`, and the
  same params, kv_pool, draft and blocks-that-fit bytes wherever the two
  packages store the same layout; where a layout differs (the pp pool:
  the JAX ring pads every stage to the largest, the port's stages hold
  their own layers) the test states the byte difference;
- the byte estimates against the port's live trees on the CPU: the
  abstract parameters against `init_params` (+ `quantize_params`), the
  pool against the engine's (fp, int8, per tp rank, per pp stage, the
  draft pool), the params per tp rank against the Generator's shards;
- the port's counterparts of the JAX `test_audit.py` cases: the bad
  plans, K1's checks (tuning entry, head size, pool dtype, shared
  memory), the CLI exit codes against the JAX CLI's, the example plans,
  the serve / server / starter refusals (the starter's through the abort
  sentinel), `liveness`, `ir`/`flow`/`check` and `Generator(abstract=
  True)` running (their numbers: tests/test_torch_ir.py and
  tests/test_torch_flow.py);
- a tripwire: the whole audit, bad plans included, with `torch.cuda.init`,
  `is_available`, `get_device_properties` and `get_device_name` patched
  to raise.
"""

import json
import logging
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mdi_llm_tpu.analysis import audit as jaudit
from mdi_llm_tpu.analysis import plan as jplan
from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.config import ServingConfig as JServing
from mdi_llm_tpu_torch.analysis import audit, plan
from mdi_llm_tpu_torch.analysis.core import Baseline
from mdi_llm_tpu_torch.config import Config, ServingConfig, name_to_config

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TINY_LLAMA = "tiny-llama-1.1b"
EXAMPLE_PLANS = sorted(
    list((REPO / "examples" / "mesh_configs").glob("*.json"))
    + list((REPO / "examples" / "node_configs").glob("*.json"))
)


def codes(report):
    return [f.rule for f in report.findings]


def both(name, serving=None, mesh=None, **kw):
    """(JAX report, port report) of one plan described once."""
    reports = []
    for C, S, P, M, mod in ((JConfig, JServing, jplan.PlanSpec, jplan.MeshSpec, jaudit),
                            (Config, ServingConfig, plan.PlanSpec, plan.MeshSpec, audit)):
        cfg = C.from_name(name)
        sv = S(**serving) if serving is not None else None
        m = M.from_dict(mesh or {})
        reports.append(mod.audit_plan(P(cfg=cfg, serving=sv, mesh=m, **kw)))
    return reports


# ---------------------------------------------------------------------------
# the same codes and bytes as the JAX audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(name_to_config))
def test_registry_default_plan_matches_jax(name):
    j, t = both(name)
    assert codes(t) == codes(j) == []
    assert t.breakdown["per_device"] == j.breakdown["per_device"]


PLANS = {
    "tp2": dict(mesh={"tp": 2}, tp_axis="tp"),
    "tp3": dict(mesh={"tp": 3}, tp_axis="tp"),
    "tp8-groups": dict(mesh={"tp": 8}, tp_axis="tp"),
    "pp2": dict(n_stages=2, n_samples=2, mesh={"pipe": 2}, shard_head=False),
    "ring-S4": dict(n_stages=4, n_samples=8, samples_per_slot=2, mesh={"pipe": 4, "tp": 2},
                    tp_axis="tp", shard_head=False, hbm_gb=16),
    "ring-S4-underfill": dict(n_stages=4, n_samples=2, mesh={"pipe": 4}, shard_head=False),
    "stages-over-layers": dict(n_stages=23, n_samples=32, shard_head=False),
    "int8": dict(quantize="int8", hbm_gb=16),
    "w8a8-tp2": dict(quantize="w8a8", mesh={"tp": 2}, tp_axis="tp"),
    "int4-tp2": dict(quantize="int4", mesh={"tp": 2}, tp_axis="tp", hbm_gb=16),
    "unknown-axis": dict(mesh={"data": 8}, tp_axis="tp"),
    "bad-axis-size": dict(mesh={"tp": 0}, tp_axis="tp"),
    "dense-budget": dict(batch=4, max_seq_length=2048, hbm_gb=2.2),
    "serve-bf16": dict(serving=dict(max_batch=8), max_seq_length=2048, hbm_gb=16),
    "serve-int8-pool": dict(serving=dict(max_batch=8, kv_dtype="int8"), max_seq_length=2048,
                            hbm_gb=16),
    "serve-int8-tp2": dict(serving=dict(max_batch=8, kv_dtype="int8"), mesh={"tp": 2},
                           tp_axis="tp", hbm_gb=16, quantize="int8"),
    "serve-int4": dict(serving=dict(max_batch=4), quantize="int4", hbm_gb=8),
    "serve-draft": dict(serving=dict(spec_k=4, draft_model="NanoLlama", max_blocks=400),
                        hbm_gb=16),
    "serve-over-budget": dict(serving=dict(max_batch=64), hbm_gb=0.5),
    "serve-host-tier": dict(serving=dict(host_pool_mib=2048), host_gb=0.25),
    "serve-token-budget": dict(serving=dict(max_batch=8, token_budget=8)),
    "serve-server-thrash": dict(serving=dict(block_size=4, decode_chunk=16, max_batch=8,
                                             max_blocks=40, admission_queue=32)),
    "serve-tp3-mesh": dict(serving=dict(), mesh={"tp": 3}, tp_axis="tp"),
    "serve-dp2-mesh": dict(serving=dict(), mesh={"dp": 2}, dp_axis="dp"),
    "unmatched-permute": dict(n_stages=4, n_samples=8, ring_perm=((0, 1), (1, 2), (2, 3))),
    "broken-ring": dict(n_stages=4, n_samples=8, ring_perm=((0, 1), (1, 0), (2, 3), (3, 2))),
}


@pytest.mark.parametrize("label", sorted(PLANS))
def test_plan_matches_jax(label):
    kw = dict(PLANS[label])
    j, t = both(TINY_LLAMA, **kw)
    assert codes(t) == codes(j), (t.render_findings(), j.render_findings())
    assert t.breakdown.get("per_device") == j.breakdown.get("per_device")
    assert t.breakdown.get("fits") == j.breakdown.get("fits")
    for k in ("stage_layers", "ring_lanes", "bubble_fraction"):
        assert t.breakdown.get(k) == j.breakdown.get(k)
    if "kv_pool" in j.breakdown:
        jp, tp = j.breakdown["kv_pool"], t.breakdown["kv_pool"]
        for k in ("num_blocks", "pool_bytes", "scale_bytes", "pool_bytes_per_device",
                  "blocks_at_budget", "host_pool_bytes", "host_blocks", "token_budget",
                  "reserve_headroom_blocks", "draft_num_blocks", "draft_pool_bytes",
                  "draft_pool_bytes_per_device"):
            assert tp.get(k) == jp.get(k), k


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pp_pool_differs_from_jax_by_the_stage_padding(kv_dtype):
    """The serving pool over pp 2 on tiny-llama-1.1b (22 layers, stages of
    10 and 12): the JAX pool pads each stage to l_max = 12 layers, the
    port's stage 0 holds its 10.  The per-device bytes (the largest
    stage's) agree; the totals differ by 2 layers of every block."""
    j, t = both(TINY_LLAMA, serving=dict(max_batch=8, kv_dtype=kv_dtype), mesh={"pp": 2},
                max_seq_length=2048, hbm_gb=16)
    assert codes(t) == codes(j) == []
    jp, tp = j.breakdown["kv_pool"], t.breakdown["kv_pool"]
    assert tp["stage_layers"] == jp["stage_layers"] == [10, 12]
    assert tp["pool_bytes_per_device"] == jp["pool_bytes_per_device"]
    assert t.breakdown["per_device"] == j.breakdown["per_device"]
    per_layer = ServingConfig(kv_dtype=kv_dtype).block_bytes(
        Config.from_name(TINY_LLAMA))["total_bytes"] // 22
    assert jp["pool_bytes"] - tp["pool_bytes"] == (2 * 12 - 22) * per_layer * jp["num_blocks"]
    assert tp["pool_bytes_per_stage"] == [10 * per_layer * jp["num_blocks"],
                                          12 * per_layer * jp["num_blocks"]]


def test_preflight_matches_jax():
    cfg, jcfg = Config.from_name(TINY_LLAMA), JConfig.from_name(TINY_LLAMA)
    kw = dict(n_stages=4, tp=2, n_samples=8, samples_per_slot=2, seq_len=2048,
              quantize="int8", hbm_gb=16)
    t, j = audit.preflight(cfg, **kw), jaudit.preflight(jcfg, **kw)
    assert codes(t) == codes(j) == []
    assert t.breakdown == j.breakdown
    assert audit.audit_detail(t) == jaudit.audit_detail(j)


# ---------------------------------------------------------------------------
# the estimates against the port's live trees
# ---------------------------------------------------------------------------


def _shapes(tree):
    return {p: (tuple(x.shape), x.dtype, int(x.nbytes)) for p, x in plan.iter_leaves(tree)}


@pytest.mark.parametrize("quantize", [None, "int8", "w8a8", "int4"])
@pytest.mark.parametrize("name", ["pythia-14m", "tiny-moe", "tiny-gemma"])
def test_abstract_params_mirror_the_live_tree(name, quantize):
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params

    if name == "tiny-moe":
        cfg = Config.from_name("Mixtral-8x7B-v0.1", n_layer=2, n_embd=64, n_head=4,
                               n_query_groups=2, intermediate_size=128)
    elif name == "tiny-gemma":
        cfg = Config.from_name("Gemma-2b", n_layer=2, n_embd=64, n_head=4,
                               n_query_groups=1, head_size=16, intermediate_size=128,
                               padded_vocab_size=512, vocab_size=512)
    else:
        cfg = Config.from_name(name)
    live = transformer.init_params(cfg, 0, dtype=torch.bfloat16)
    if quantize:
        live = quantize_params(live, mode=FLAG_TO_MODE[quantize])
    stub = plan.abstract_params(cfg, "bfloat16", quantize)
    assert _shapes(stub) == _shapes(live)
    assert all(x.device.type == "meta" for _, x in plan.iter_leaves(stub))
    assert plan.tree_bytes(stub) == plan.tree_bytes(live)


def _tiny():
    from tests.test_torch_tp_serving import tiny_config

    return tiny_config(block_size=128)


@pytest.mark.parametrize("case", ["fp", "int8", "tp2", "tp2-int8", "pp2", "pp2-tp2", "draft"])
def test_pool_and_params_estimates_equal_the_live_engine(case):
    """kv_pool bytes against the engine's pool tensors (scales included),
    per tp rank and per pp stage; the params per device against the
    weights (each tp rank's shard tree); the draft pool's bytes."""
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    cfg = _tiny()
    tp = 2 if "tp2" in case else 1
    pp = 2 if "pp2" in case else 1
    kw = dict(block_size=8, max_batch=2, decode_chunk=4)
    if case == "draft":  # a draft shares the target's vocabulary
        cfg = tiny()
        kw.update(spec_k=2, draft_model="pythia-14m", max_blocks=40)
    sv = ServingConfig(kv_dtype="int8" if "int8" in case else None, **kw)
    axes = {k: v for k, v in (("pp", pp), ("tp", tp)) if v > 1}
    r = audit.audit_plan(plan.PlanSpec(
        cfg=cfg, serving=sv, max_seq_length=64, dtype="float32",
        mesh=plan.MeshSpec.from_dict(axes), tp_axis="tp" if tp > 1 else None,
        device_kind="cpu"))
    assert codes(r) == []
    params = transformer.init_params(cfg, 0, dtype=torch.float32)
    mesh = make_mesh(axes, ["cpu"]) if axes else None
    draft = None
    if case == "draft":
        dcfg = Config.from_name("pythia-14m")
        draft = Generator(dcfg, transformer.init_params(dcfg, 1), device="cpu",
                          max_seq_length=64)
    gen = Generator(cfg, params, mesh=mesh, device="cpu", max_seq_length=64)
    engine = gen.serve(serving=sv, draft_gen=draft) if draft else gen.serve(serving=sv)
    pool = r.breakdown["kv_pool"]
    nbytes = lambda tree: sum(int(x.nbytes) for x in transformer.tree_leaves(tree))
    assert nbytes(engine._kv) == pool["pool_bytes"]
    if tp > 1 and pp == 1:
        ranks = engine._kv
        assert sorted(ranks) == [0, 1]
        assert {nbytes(ranks[i]) for i in ranks} == {pool["pool_bytes_per_device"]}
        assert {nbytes(s) for s in gen._shards.values()} == {
            r.breakdown["per_device"]["params_bytes"]}
    elif pp > 1:
        stages = engine._kv
        per_stage = [nbytes(stages[s]) for s in sorted(stages)]
        assert per_stage == pool["pool_bytes_per_stage"]
        assert max(per_stage) // tp == pool["pool_bytes_per_device"]
    else:
        assert nbytes(engine._kv) == pool["pool_bytes_per_device"]
        assert nbytes(gen.params) == r.breakdown["per_device"]["params_bytes"]
    if case == "draft":
        assert nbytes(engine._draft_kv) == pool["draft_pool_bytes"]
        assert pool["draft_num_blocks"] == engine.draft_pool.num_blocks
    assert pool["num_blocks"] == engine.pool.num_blocks


# ---------------------------------------------------------------------------
# bad plans (the JAX test_audit.py fixtures)
# ---------------------------------------------------------------------------


def tiny():
    return Config.from_name("pythia-14m")


def test_good_plans_are_clean():
    cfg = Config.from_name(TINY_LLAMA)
    r = audit.preflight(cfg, n_stages=4, tp=2, n_samples=8, samples_per_slot=2,
                        seq_len=2048, hbm_gb=16)
    assert r.findings == [] and r.breakdown["stage_layers"] == [4, 6, 6, 6]
    assert r.breakdown["bubble_fraction"] == 0.0
    r = audit.audit_plan(plan.PlanSpec(cfg=cfg, serving=ServingConfig(max_batch=8), hbm_gb=16))
    assert r.findings == []


def test_indivisible_dims_name_the_axis_and_the_group_count():
    cfg = Config.from_name(TINY_LLAMA)
    r = audit.audit_plan(plan.PlanSpec(cfg=cfg, mesh=plan.MeshSpec.from_dict({"tp": 3}),
                                       tp_axis="tp"))
    assert codes(r) == ["indivisible-dim"] and "'tp' (size 3)" in r.findings[0].message
    r = audit.audit_plan(plan.PlanSpec(cfg=cfg, mesh=plan.MeshSpec.from_dict({"tp": 8}),
                                       tp_axis="tp"))
    assert codes(r) == ["indivisible-dim"] and "n_query_groups=4" in r.findings[0].message


def test_schedule_divergence_and_underfill():
    ring = [("send", "pipe", plan.ring_permutation(2))] * 4
    diverged = list(ring)
    diverged[2] = ("all_reduce", "pipe", None)
    r = audit.audit_plan(plan.PlanSpec(cfg=tiny(), n_stages=2, n_samples=4,
                                       rank_programs=[ring, diverged]))
    assert codes(r) == ["schedule-divergence"] and "step 2" in r.findings[0].message
    r = audit.preflight(tiny(), n_stages=4, n_samples=2)
    assert codes(r) == ["pipeline-underfill"] and r.errors == []
    assert r.breakdown["bubble_fraction"] == 0.5
    r = audit.preflight(tiny(), n_stages=7, n_samples=8)
    assert codes(r) == ["bad-stage-split"]


def test_duplicate_axis_and_missing_spec(monkeypatch):
    import mdi_llm_tpu_torch.parallel.sharding as sharding

    real = sharding.param_specs

    def doubled(cfg, tp_axis="tp", ep_axis=None):
        specs = real(cfg, tp_axis, ep_axis)
        specs["blocks"]["attn"]["qkv"]["weight"] = sharding.P(None, tp_axis, tp_axis)
        return specs

    monkeypatch.setattr(sharding, "param_specs", doubled)
    r = audit.audit_plan(plan.PlanSpec(cfg=tiny(), mesh=plan.MeshSpec.from_dict({"tp": 2}),
                                       tp_axis="tp"))
    assert "duplicate-axis" in codes(r)

    def dropped(cfg, tp_axis="tp", ep_axis=None):
        specs = real(cfg, tp_axis, ep_axis)
        del specs["ln_f"]
        return specs

    monkeypatch.setattr(sharding, "param_specs", dropped)
    r = audit.audit_plan(plan.PlanSpec(cfg=tiny()))
    assert set(codes(r)) == {"missing-spec"}
    assert any("ln_f.weight" in f.message for f in r.findings)


def test_serving_walls():
    def sv_codes(**kw):
        return codes(audit.audit_plan(plan.PlanSpec(cfg=tiny(), serving=ServingConfig(**kw))))

    assert sv_codes(block_size=16, max_blocks=1) == ["bad-serving-config"]
    assert "bad-serving-config" in sv_codes(block_size=0)
    assert sv_codes(block_size=16, admission_queue=0) == ["bad-server-config"]
    assert "bad-serving-config" in sv_codes(block_size=8, draft_model="pythia-14m")
    assert "bad-serving-config" in sv_codes(block_size=8, spec_k=4,
                                            draft_model="no-such-model")
    assert "bad-serving-config" in sv_codes(block_size=4, spec_k=4, temperature=0.8,
                                            spec_sampled=False)
    assert "bad-serving-config" not in sv_codes(block_size=4, spec_k=4, temperature=0.8)
    assert sv_codes(max_batch=8, token_budget=3) == ["bad-token-budget"]


def test_findings_reuse_the_lint_baseline():
    p = plan.PlanSpec(cfg=Config.from_name(TINY_LLAMA), mesh=plan.MeshSpec.from_dict({"tp": 3}),
                      tp_axis="tp")
    b = Baseline.from_findings(audit.audit_plan(p).findings)
    new, old = b.split(audit.audit_plan(p).findings)
    assert new == [] and len(old) == 1


# ---------------------------------------------------------------------------
# K1 on the card
# ---------------------------------------------------------------------------


def test_k1_breakdown_and_shared_memory():
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    r = audit.audit_plan(plan.PlanSpec(cfg=Config.from_name(TINY_LLAMA),
                                       serving=ServingConfig(max_batch=8)))
    pool = r.breakdown["kv_pool"]
    assert pool["kernel_variant"] == "auto" and pool["tuned"] is False
    assert pool["kernel_table_source"] == "builtin"
    assert pool["kernel_key"] == "NVIDIA H100 80GB HBM3|32h4g64hs|bs16|q=bfloat16|kv=bfloat16"
    # 16 rows x 64 x 4 + 4 stages x 32 keys x (2 x 64 x 2 + 16) + 4 x 2 x 32 x 4
    assert pool["k1_smem_bytes"] == rpa.smem_bytes(64, 2) == 4096 + 34816 + 1024
    assert pool["k1_smem_limit"] == 227 * 1024
    int8 = audit.audit_plan(plan.PlanSpec(
        cfg=Config.from_name(TINY_LLAMA), serving=ServingConfig(kv_dtype="int8")))
    assert int8.breakdown["kv_pool"]["k1_smem_bytes"] == rpa.smem_bytes(64, 1)


def test_k1_smem_formula_follows_the_kernel_source():
    """`smem_bytes` prices the launch's request from the source's own
    constants: the tiles and stages it names must be the source's."""
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    src = (REPO / "mdi_llm_tpu_torch" / "csrc" / "ragged_paged_attention.cu").read_text()
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    rows = consts["kWarps"] * consts["kRowsPerWarp"]
    assert (rows, consts["kKeys"], consts["kStages"]) == (rpa.ROW_TILE, rpa.KEY_TILE,
                                                          rpa.K1_STAGES)
    assert "(size_t)kRows * HS * sizeof(float) +" in src
    assert "(size_t)kStages * kKeys * (2 * HS * sizeof(KV) + 16) +" in src
    assert "const size_t smem = smem_bytes<KV, HS>();" in src


@pytest.mark.parametrize("case", ["table-entry", "unreadable", "head-size", "pool-dtype",
                                  "smem-limit"])
def test_bad_kernel_tuning(case, tmp_path, monkeypatch):
    from mdi_llm_tpu_torch.ops.tuning import TUNE_TABLE_ENV, save_tuning_table

    cfg, sv, dtype = Config.from_name(TINY_LLAMA), ServingConfig(), "bfloat16"
    if case == "table-entry":
        key = "NVIDIA H100 80GB HBM3|32h4g64hs|bs16|q=bfloat16|kv=bfloat16"
        path = tmp_path / "t.json"
        save_tuning_table(str(path), "x", {key: dict(min_chunk=100, max_chunks=16,
                                                      decode_chunk=64, decode_max_chunks=32)})
        monkeypatch.setenv(TUNE_TABLE_ENV, str(path))
    elif case == "unreadable":
        monkeypatch.setenv(TUNE_TABLE_ENV, str(tmp_path / "missing.json"))
    elif case == "head-size":
        cfg = Config.from_name("phi-2")  # head size 80
    elif case == "pool-dtype":
        dtype, sv = "float32", ServingConfig(kv_dtype="bfloat16")
    else:
        monkeypatch.setitem(plan.SMEM_OPTIN_BYTES, plan.H100, 1024)
    p = plan.PlanSpec(cfg=cfg, serving=sv, dtype=dtype)
    r = audit.audit_plan(p)
    assert codes(r) == ["bad-kernel-tuning"], r.render_findings()
    # the plain route (a CPU plan, or use_kernel=False) runs no K1
    if case not in ("unreadable", "table-entry"):
        p.device_kind = "cpu"
        assert codes(audit.audit_plan(p)) == []
        p.device_kind, p.serving = plan.H100, ServingConfig(use_kernel=False,
                                                              kv_dtype=sv.kv_dtype)
        assert codes(audit.audit_plan(p)) == []


# ---------------------------------------------------------------------------
# the CLI, against the JAX CLI's exit codes
# ---------------------------------------------------------------------------

CLI_CASES = {
    "clean": ["--model", TINY_LLAMA],
    "ring": ["--model", TINY_LLAMA, "--stages", "4", "--n-samples", "8", "--hbm-gb", "16"],
    "tp3": ["--model", TINY_LLAMA, "--tp", "3"],
    "mesh-tp0": ["--model", TINY_LLAMA, "--mesh", "tp=0"],
    "underfill": ["--model", TINY_LLAMA, "--stages", "4", "--n-samples", "1"],
    "serve-json": ["--model", TINY_LLAMA, "--serve", "--hbm-gb", "16", "--format", "json"],
    "serve-int8": ["--model", TINY_LLAMA, "--serve", "--kv-dtype", "int8", "--hbm-gb", "1"],
    "over-budget": ["--model", TINY_LLAMA, "--serve", "--max-batch", "64", "--hbm-gb", "0.5"],
    "host-tier": ["--model", TINY_LLAMA, "--serve", "--host-pool-mib", "2048",
                  "--host-gb", "0.25"],
    "no-model": [],
    "unknown-model": ["--model", "no-such-model"],
    "list-checks": ["--list-checks"],
}


@pytest.mark.parametrize("label", sorted(CLI_CASES))
def test_cli_exit_codes_match_jax(label, capsys):
    argv = CLI_CASES[label]
    rc_j = jaudit.main(argv)
    out_j = capsys.readouterr().out
    rc_t = audit.main(argv)
    out_t = capsys.readouterr().out
    assert rc_t == rc_j, (out_t, out_j)
    if "--format" in argv:
        dj, dt = json.loads(out_j), json.loads(out_t)
        assert (dt["errors"], dt["warnings"]) == (dj["errors"], dj["warnings"])
        assert dt["breakdown"]["per_device"] == dj["breakdown"]["per_device"]
    if label == "list-checks":
        assert list(audit.AUDIT_RULES) == list(jaudit.AUDIT_RULES)
        assert {k: v[0] for k, v in audit.AUDIT_RULES.items()} == {
            k: v[0] for k, v in jaudit.AUDIT_RULES.items()}


@pytest.mark.parametrize("plan_file", EXAMPLE_PLANS, ids=lambda p: p.name)
def test_example_plans_audit_clean_as_in_jax(plan_file, capsys):
    argv = ["--model", TINY_LLAMA, "--plan", str(plan_file)]
    assert audit.main(argv) == jaudit.main(argv) == 0, capsys.readouterr().out


def test_liveness_and_the_compiled_program_tools_are_refused(capsys):
    """Refused until the compiled-program analysis was ported; now each
    runs: `liveness=True` on a plan that serves nothing keeps the
    heuristic (the liveness term itself: tests/test_torch_flow.py),
    `--liveness` exits 0, the `ir`, `flow` and `check` subcommands exit 2
    only on a usage error (no model) and list their rules, and
    `Generator(abstract=True)` builds on the meta device."""
    from mdi_llm_tpu_torch.analysis.cli import dispatch
    from mdi_llm_tpu_torch.analysis.plan import abstract_params
    from mdi_llm_tpu_torch.generation import Generator

    rep = audit.audit_plan(plan.PlanSpec(cfg=tiny()), liveness=True)
    assert rep.breakdown["per_device"]["act_source"] == "heuristic"
    assert audit.main(["--model", TINY_LLAMA, "--liveness"]) == 0
    for sub in ("ir", "flow", "check"):
        assert dispatch([sub]) == 2
        assert "need --model" in capsys.readouterr().err
        assert dispatch([sub, "--list-checks"]) == 0
        assert "trace-failure" in capsys.readouterr().out
    cfg = tiny()
    gen = Generator(cfg, abstract_params(cfg, "bfloat16"), abstract=True)
    assert gen.device.type == "meta" and gen.abstract


def test_module_entry_point_audits():
    proc = subprocess.run(
        [sys.executable, "-m", "mdi_llm_tpu_torch.analysis", "audit", "--model", TINY_LLAMA],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and "findings: none" in proc.stdout, proc.stderr


# ---------------------------------------------------------------------------
# no CUDA context
# ---------------------------------------------------------------------------


def test_audit_never_touches_cuda(monkeypatch, capsys):
    def boom(*a, **k):
        raise AssertionError("the audit touched CUDA")

    for name in ("init", "is_available", "get_device_properties", "get_device_name",
                 "current_device", "device_count"):
        monkeypatch.setattr(torch.cuda, name, boom)
    cfg = Config.from_name(TINY_LLAMA)
    r = audit.preflight(cfg, n_stages=4, tp=2, n_samples=8, seq_len=2048,
                        quantize="int8", hbm_gb=16)
    assert r.findings == []
    r = audit.audit_plan(plan.PlanSpec(cfg=cfg, serving=ServingConfig(max_batch=8),
                                       hbm_gb=16, quantize="int4"))
    assert r.findings == [] and r.breakdown["kv_pool"]["k1_smem_bytes"] > 0
    for label in sorted(PLANS):
        kw = dict(PLANS[label])
        sv, mesh = kw.pop("serving", None), kw.pop("mesh", {})
        audit.audit_plan(plan.PlanSpec(
            cfg=cfg, serving=ServingConfig(**sv) if sv is not None else None,
            mesh=plan.MeshSpec.from_dict(mesh), **kw))
    assert audit.main(["--model", TINY_LLAMA, "--tp", "3"]) == 1
    assert audit.main(CLI_CASES["over-budget"]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the preflights of cli.serve, cli.server and cli.starter
# ---------------------------------------------------------------------------

SERVE = ["--device", "cpu", "--model", "pythia-14m", "--synthetic", "2", "--n-tokens", "4",
         "--sequence-length", "64", "--max-batch", "2", "--block-size", "8"]


def _no_load(monkeypatch, module):
    def load_model(*a, **k):
        raise AssertionError("a refused plan loaded the weights")

    monkeypatch.setattr(module, "load_model", load_model)


@pytest.mark.parametrize("cli", ["serve", "server"])
def test_refused_serve_loads_no_weight(cli, monkeypatch, capsys):
    from mdi_llm_tpu_torch.cli import serve as serve_cli
    from mdi_llm_tpu_torch.cli import server as server_cli

    _no_load(monkeypatch, serve_cli)
    main = serve_cli.main if cli == "serve" else server_cli.main
    with pytest.raises(SystemExit, match=f"cli.{cli}: mdi-audit preflight refused"):
        main(SERVE + ["--hbm-gb", "0.0001"])
    err = capsys.readouterr().err
    assert f"cli.{cli}: preflight: " in err and "hbm-over-budget" in err


def test_serve_preflight_passes_or_warns(capsys):
    from mdi_llm_tpu_torch.cli import serve as serve_cli

    line = serve_cli.main(SERVE + ["--hbm-gb", "16"])
    err = capsys.readouterr().err
    assert line["requests"] == 2 and "preflight" not in err
    assert "cli.serve: KV pool 17 blocks x 8 tokens" in err
    line = serve_cli.main(SERVE + ["--hbm-gb", "0.0001", "--no-preflight"])
    err = capsys.readouterr().err
    assert line["requests"] == 2 and "error: hbm-over-budget" in err
    assert "refused" not in err


def test_serve_engine_carries_its_audit():
    from mdi_llm_tpu_torch.cli import serve as serve_cli
    from mdi_llm_tpu_torch.models import transformer

    args = serve_cli.build_parser().parse_args(SERVE + ["--kv-dtype", "int8", "--dtype",
                                                        "float32"])
    engine, _tok = serve_cli.build_engine(args, need_tokenizer=False)
    rep = engine.audit
    nbytes = lambda tree: sum(int(x.nbytes) for x in transformer.tree_leaves(tree))
    assert rep.breakdown["kv_pool"]["pool_bytes"] == nbytes(engine._kv)
    assert rep.breakdown["per_device"]["params_bytes"] == nbytes(engine.gen.params)
    assert rep.breakdown["kv_pool"]["kernel_variant"] == "auto"
    assert rep.plan.device_kind == "cpu"


STARTER = ["--model", "pythia-14m", "--device", "cpu", "--greedy", "--n-tokens", "4",
           "--n-samples", "2", "--seed", "10137"]


def test_starter_refusal_goes_out_as_the_abort_sentinel(monkeypatch):
    """A refused plan raises before the checkpoint load, and `_run` ships
    the refusal, with every finding, to the secondaries through the
    run-spec broadcast."""
    from mdi_llm_tpu_torch.cli import starter as starter_cli
    from mdi_llm_tpu_torch.parallel.nodes import parse_nodes_config

    _no_load(monkeypatch, starter_cli)
    sent = []
    monkeypatch.setattr(starter_cli, "broadcast_run_spec",
                        lambda spec, ring: sent.append(spec) or spec)
    cfg_path = REPO / "examples" / "node_configs" / "standalone.json"
    args = starter_cli.build_parser().parse_args(
        STARTER + ["--nodes-config", str(cfg_path), "--pipeline-stages", "7"])
    with pytest.raises(SystemExit, match="cli.starter: mdi-audit preflight refused"):
        starter_cli._run(args, parse_nodes_config(cfg_path), 0, object(),
                         logging.getLogger("test"))
    assert len(sent) == 1 and "bad-stage-split" in sent[0]["abort"]
    assert sent[0]["abort"].startswith("cli.starter: mdi-audit preflight refused")


def test_starter_preflight_flags(monkeypatch):
    from mdi_llm_tpu_torch.cli import sample as sample_cli
    from mdi_llm_tpu_torch.cli import starter as starter_cli

    cfg_path = str(REPO / "examples" / "node_configs" / "standalone.json")
    want = sample_cli.main(STARTER)
    assert starter_cli.main(STARTER + ["--nodes-config", cfg_path, "--hbm-gb", "16"]) == want
    with pytest.raises(SystemExit, match="refused"):
        starter_cli.main(STARTER + ["--nodes-config", cfg_path, "--hbm-gb", "0.00001"])
    outs = starter_cli.main(STARTER + ["--nodes-config", cfg_path, "--hbm-gb", "0.00001",
                                       "--no-preflight"])
    assert outs == want
