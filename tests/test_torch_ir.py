"""The port's `ir` (`mdi_llm_tpu_torch/analysis/ir.py`) against the JAX
package's `mdi-ir` (`mdi_llm_tpu/analysis/ir.py`), on the CPU.

- every rule has a planted fixture it must catch and a clean twin it must
  pass: small owners of meta tensors and bodies written for the purpose
  (a functional pool update, a host read, a pool copy in a ranked step,
  a bf16 -> f32 matmul operand, a baked tensor, a body that raises), and
  for compile-set-closure an engine whose enumeration forgets a step or
  adds a dead one;
- the enumeration seams against the JAX engine's, both built abstractly:
  the (label, key) set of every ServingConfig case of `tests/test_ir.py`,
  a host tier, pp = 2 and tp = 2, and the port's `reachable_serving_set`
  against the JAX one; `Generator.enumerate_executables` against the JAX
  Generator's for several workloads;
- the traced steps hold one K1 node per layer per forward, in-place pool
  writes, and K2 in a flash prefill; the recorder's operators are
  `make_fx`'s over the same step;
- the CLI: exit codes 0/1/2, `--format json`, the baseline round trip,
  `--suppress` needing a justification, `--list-checks`.
"""

import json

import pytest
import torch

from mdi_llm_tpu.analysis import ir as jir
from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.config import ServingConfig as JServing
from mdi_llm_tpu_torch.analysis import ir
from mdi_llm_tpu_torch.analysis.plan import abstract_params
from mdi_llm_tpu_torch.analysis.trace import kernel_nodes, leaves_of, trace_step
from mdi_llm_tpu_torch.config import Config, ServingConfig
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.obs.device import StepSpec
from mdi_llm_tpu_torch.ops.flash import OP as K2_OP

torch.set_num_threads(1)
MODEL = "pythia-14m"
META = torch.device("meta")
bf16 = torch.bfloat16


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# per-rule planted / clean fixtures
# ---------------------------------------------------------------------------


class Owner:
    """A step owner: weights and a pool on the meta device."""

    def __init__(self, ranked=False):
        self.w = torch.empty(64, 64, dtype=bf16, device=META)
        pool = lambda: torch.empty(4, 8, 64, dtype=bf16, device=META)  # noqa: E731
        self.pool = {0: pool(), 1: pool()} if ranked else pool()
        self.big = torch.empty(3 * 2**20, device=META)  # 12 MiB


def spec_of(body, owner=None, extra=None, writes=("kv",), pool=True):
    owner = owner or Owner()
    args = {"params": owner.w}
    if pool:
        args["kv"] = owner.pool
    args.update(x=torch.empty(8, 64, dtype=bf16, device=META),
                idx=torch.zeros(8, dtype=torch.long, device=META))
    args.update(extra or {})
    owned = ("params", "kv") + tuple(extra or {}) if pool else ("params",)
    return StepSpec("t", (1,), body, owner, args, None,
                    {"params": "params", "kv": "kv"}, owned, writes)


def write_in_place(o, x, idx):
    o.pool[0].index_put_((idx,), x @ o.w)
    return x.sum(0)


def write_functional(o, x, idx):
    return o.pool.index_put((torch.zeros_like(idx), idx), x @ o.w)


def read_host(o, x, idx):
    return x * x.float().sum().item()


def branch_on_tensor(o, x, idx):
    return x if bool((x > 0).any()) else -x


def data_dependent(o, x, idx):
    return x.nonzero()


def copy_to_cpu(o, x, idx):
    return x.cpu()


def ranked_in_place(o, x, idx):
    for r in (0, 1):
        o.pool[r][0].index_put_((idx,), x @ o.w)
    return x.sum(0)


def ranked_copy(o, x, idx):
    ranked_in_place(o, x, idx)
    return o.pool[1].clone().sum()


def upcast_matmul(o, x, idx):
    o.pool[0].index_put_((idx,), x)
    return x.float() @ o.w.float()


def compute_dtype_matmul(o, x, idx):
    o.pool[0].index_put_((idx,), x)
    return x @ o.w


def reads_big(o, x, idx):
    o.pool[0].index_put_((idx,), x)
    return x.float().sum() + o.big.sum()


def explodes(o, x, idx):
    raise RuntimeError("boom")


CASES = {
    "dropped-donation": (lambda: spec_of(write_functional),
                         lambda: spec_of(write_in_place)),
    "callback-in-executable": (lambda: spec_of(read_host),
                               lambda: spec_of(write_in_place)),
    "sharding-constraint-drift": (lambda: spec_of(ranked_copy, Owner(ranked=True)),
                                  lambda: spec_of(ranked_in_place, Owner(ranked=True))),
    "dtype-promotion-leak": (lambda: spec_of(upcast_matmul),
                             lambda: spec_of(compute_dtype_matmul)),
    "baked-constant-bloat": (lambda: spec_of(reads_big),
                             lambda: (lambda o: spec_of(reads_big, o, {"big": o.big}))(Owner())),
    "trace-failure": (lambda: spec_of(explodes), lambda: spec_of(write_in_place)),
}


def test_every_rule_has_a_fixture_pair():
    assert set(CASES) | {"compile-set-closure"} == set(ir.IR_RULES)
    assert list(ir.IR_RULES) == list(jir.IR_RULES)
    assert {k: v[0] for k, v in ir.IR_RULES.items()} == {
        k: v[0] for k, v in jir.IR_RULES.items()}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_planted_fixture_caught_and_clean_twin_passes(rule):
    planted, clean = CASES[rule]
    findings, records = ir.analyze_executables([planted()], origin="t", compute_dtype=bf16,
                                               max_const_bytes=8 * 2**20)
    assert rules_of(findings) == [rule], [f.message for f in findings]
    findings, records = ir.analyze_executables([clean()], origin="t", compute_dtype=bf16,
                                               max_const_bytes=8 * 2**20)
    assert findings == [], [f.message for f in findings]
    assert records[0]["donated"] >= 1 and records[0]["nodes"] > 0


@pytest.mark.parametrize("body,op", [
    (read_host, "item"), (branch_on_tensor, "item"), (data_dependent, "nonzero"),
    (copy_to_cpu, "copy to the CPU"),
])
def test_host_round_trip_names_the_operation_and_the_source_line(body, op):
    """A host read cannot be traced on meta tensors: a finding with the
    body's line, never a crash."""
    findings, records = ir.analyze_executables([spec_of(body)], origin="t")
    (f,) = findings
    assert f.rule == "callback-in-executable" and f"`{op}`" in f.message
    assert "tests/test_torch_ir.py:" in f.message and "error" in records[0]


def test_dropped_donation_sees_a_missed_in_place_write():
    """A step that writes the pool but never in place (here: it forgets
    it) is caught by the writes the spec promises; `writes=()` (the
    tier's fetch) promises none."""
    (f,) = ir.analyze_executables([spec_of(lambda o, x, idx: x @ o.w)], origin="t")[0]
    assert f.rule == "dropped-donation" and "updated in place" in f.message
    spec = spec_of(lambda o, x, idx: x @ o.w, writes=())
    assert ir.analyze_executables([spec], origin="t")[0] == []


def test_enforce_and_detail():
    findings, records = ir.analyze_executables([spec_of(explodes)], origin="gate")
    broken = ir.IrReport("gate", findings, records)
    emitted = []
    with pytest.raises(SystemExit, match="no-preflight"):
        ir.enforce_ir_preflight(broken, "cli.serve", emit=emitted.append)
    assert any("trace-failure" in line for line in emitted)
    assert ir.enforce_ir_preflight(broken, "cli.serve", allow=True, emit=emitted.append)
    d = ir.ir_detail(broken)
    assert d["findings"] == 1 and d["executables"] == {"t(1)": None}


# ---------------------------------------------------------------------------
# compile-set closure against the JAX engine's
# ---------------------------------------------------------------------------


def jax_engine(serving, tp=1, pp=1, dtype="bfloat16"):
    return jir.trace_serving(JConfig.from_name(MODEL), JServing(**serving), tp=tp, pp=pp,
                             dtype=dtype, max_seq_length=256)


def port_engine(serving, tp=1, pp=1, dtype="bfloat16"):
    return ir.trace_serving(Config.from_name(MODEL), ServingConfig(**serving), tp=tp, pp=pp,
                            dtype=dtype, max_seq_length=256)


SERVING_CASES = [
    dict(), dict(decode_chunk=1), dict(spec_k=3), dict(spec_k=3, decode_chunk=1),
    dict(spec_k=3, temperature=0.8), dict(spec_k=3, draft_model=MODEL),
    dict(spec_k=3, temperature=0.8, top_p=0.95, draft_model=MODEL),
    dict(host_pool_mib=4, swap_chunk_blocks=4),
]


@pytest.mark.parametrize("serving,tp,pp", [(s, 1, 1) for s in SERVING_CASES] + [
    (dict(spec_k=3), 1, 2), (dict(decode_chunk=4), 2, 1), (dict(), 2, 2)],
    ids=lambda v: str(v))
def test_enumeration_equals_the_jax_engines(devices, serving, tp, pp):
    """The port engine's (label, key) set equals the JAX engine's and its
    own `reachable_serving_set`, which equals the JAX one's."""
    if tp > 1 and pp > 1:
        jeng = None  # the JAX serving engine composes pp x tp in one mesh
    else:
        jeng = jax_engine(serving, tp, pp)
    teng = port_engine(serving, tp, pp)
    got = {(s.label, tuple(s.key)) for s in teng.enumerate_executables()}
    reach = ir.reachable_serving_set(teng.cfg, teng.scheduler.max_batch, teng.token_budget)
    assert got == reach == set(teng.reachable_signatures())
    if jeng is not None:
        want = {(s.label, tuple(s.key)) for s in jeng.enumerate_executables()}
        assert got == want
        assert reach == jir.reachable_serving_set(
            jeng.cfg, jeng.scheduler.max_batch, jeng.token_budget)


@pytest.mark.parametrize("kind", ["missing", "unreachable"])
def test_planted_compile_set_hole_and_dead_warmup(monkeypatch, kind):
    teng = port_engine(dict(spec_k=3, decode_chunk=2))
    real = type(teng).enumerate_executables

    def planted(self):
        specs = real(self)
        if kind == "missing":  # forgets the speculative verify
            return [s for s in specs if s.label != "verify"]
        return specs + [specs[0]._replace(label="decode", key=(8,))]

    monkeypatch.setattr(type(teng), "enumerate_executables", planted)
    report = ir.ir_preflight(teng, origin="hole")
    assert [f.rule for f in report.findings] == ["compile-set-closure"]
    assert report.findings[0].line_text.startswith(kind)


@pytest.mark.parametrize("workload", [
    dict(batch_size=1, prompt_len=5, max_new_tokens=9, chunk_size=4),
    dict(batch_size=8, prompt_len=40, max_new_tokens=33, chunk_size=16),
    dict(batch_size=3, prompt_len=17, max_new_tokens=2, chunk_size=16, speculative=3),
    dict(batch_size=6, prompt_len=100, max_new_tokens=20, chunk_size=8, compact=False),
], ids=lambda w: f"B{w['batch_size']}")
def test_sequential_enumeration_equals_the_jax_generators(devices, workload):
    jgen = jax_engine(dict()).gen
    tgen = port_engine(dict()).gen
    want = [(s.label, tuple(s.key)) for s in jgen.enumerate_executables(**workload)]
    got = [(s.label, tuple(s.key)) for s in tgen.enumerate_executables(**workload)]
    assert got == want
    with pytest.raises(ValueError, match="max_seq_length"):
        tgen.enumerate_executables(prompt_len=250, max_new_tokens=10)


# ---------------------------------------------------------------------------
# the traced steps: kernels as operators, in-place pool writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,pp", [(1, 1), (2, 1), (1, 2)])
def test_traced_steps_hold_k1_per_layer_and_write_the_pool_in_place(tp, pp):
    """One K1 node per layer (and per tp rank) per forward, where the card
    launches it: L in the mixed step, L x K in the decode chunk; every
    pool leaf updated in place; nothing reached the plain route."""
    from mdi_llm_tpu_torch.ops import paged_attention as pa

    teng = port_engine(dict(decode_chunk=2, spec_k=2), tp=tp, pp=pp)
    plain0 = (pa._paged_prefill_plain.calls, pa._paged_attention_plain.calls)
    report = ir.ir_preflight(teng, origin="t")
    assert report.findings == []
    L = teng.gen.cfg.n_layer
    per = {"mixed": L, "decode_chunk": 2 * L, "verify": L}
    for spec in teng.enumerate_executables():
        runs = getattr(spec.owner, "stage_layer_runs", 0)
        traced = trace_step(spec)
        k = kernel_nodes(traced.graph)
        if pp > 1:  # the ring's stage layers, bubbles included (the twin's count)
            assert k["ragged_paged_attention"] == spec.owner.stage_layer_runs - runs > per[
                spec.label], spec.name
        else:
            assert k["ragged_paged_attention"] == tp * per[spec.label], spec.name
        assert k["flash_attention"] == 0
    n_leaves = 2 * tp * pp
    assert {r["donated"] for r in report.executables} == {n_leaves}
    assert (pa._paged_prefill_plain.calls, pa._paged_attention_plain.calls) == plain0


def test_flash_prefill_traces_k2_per_layer():
    cfg = Config.from_name(MODEL)
    gen = Generator(cfg, abstract_params(cfg, "bfloat16"), abstract=True, flash_min_len=16,
                    max_seq_length=256)
    specs = gen.enumerate_executables(batch_size=2, prompt_len=20, max_new_tokens=4)
    assert [s.name for s in specs] == ["prefill(2,32)", "decode_chunk(2,3)"]
    graph = trace_step(specs[0]).graph
    k = kernel_nodes(graph)
    assert k == {"ragged_paged_attention": 0, "merge": 0, "flash_attention": cfg.n_layer}
    fx = graph.fx()  # the recorder's nodes as a torch.fx.Graph, node for node
    fx.lint()
    assert [n.op for n in fx.nodes] == [n.op for n in graph.nodes]
    assert sum(n.target is K2_OP for n in fx.nodes) == cfg.n_layer
    findings, records = ir.analyze_executables(specs, origin="gen", compute_dtype=bf16)
    assert all(r["donated"] == 2 for r in records)
    # a true finding: the dense decode attention (`ops/attention.
    # multihead_attention`) casts bf16 q and k to f32 for its QK product,
    # where the JAX package asks the einsum for f32 accumulation instead
    (f,) = findings
    assert f.rule == "dtype-promotion-leak" and f.path == "gen::decode_chunk(2,3)"


@pytest.mark.parametrize("label", ["mixed", "decode_chunk"])
def test_recorder_records_the_operators_make_fx_records(label):
    """The recorder's call nodes are `make_fx`'s, operator for operator,
    over the same step on the same meta tensors; `make_fx` bakes what the
    body reads from its owner (the weights, the pool) as constants where
    the recorder has placeholders, and drops `detach`."""
    import operator

    import torch.utils._pytree as pytree
    from torch.fx.experimental.proxy_tensor import make_fx

    teng = port_engine(dict(max_batch=1, token_budget=8, decode_chunk=2))
    (spec,) = [s for s in teng.enumerate_executables() if s.label == label]
    traced = trace_step(spec)
    passed = {n: v for n, v in spec.args.items() if n not in spec.owned}
    leaves, treedef = pytree.tree_flatten(passed)

    def body(*flat):
        with torch.no_grad():
            return spec.body(spec.owner, **(spec.static or {}),
                             **pytree.tree_unflatten(list(flat), treedef))

    gm = make_fx(body)(*leaves)

    def calls(nodes):
        return [str(n.target) for n in nodes if n.op == "call_function"
                and n.target is not operator.getitem and str(n.target) != "aten.detach.default"]

    assert calls(traced.graph.nodes) == calls(gm.graph.nodes)
    baked = {n.target for n in gm.graph.nodes if n.op == "get_attr"}
    placeholders = {id(t) for _, t in traced.inputs}
    owned = [t for n in spec.owned for t in leaves_of(spec.args[n])]
    assert len(baked) >= len(owned) and all(id(t) in placeholders for t in owned)


def test_live_engine_is_traced_on_its_meta_twin():
    """A live CPU engine: its steps traced on the twin, its counters,
    pool and generator untouched."""
    from mdi_llm_tpu_torch.models import transformer

    cfg = Config.from_name(MODEL)
    gen = Generator(cfg, transformer.init_params(cfg, 0, dtype=torch.float32), device="cpu",
                    max_seq_length=128)
    eng = gen.serve(serving=ServingConfig(max_batch=2, block_size=8, decode_chunk=2))
    state = eng._rng.get_state()
    k0 = eng._kv["k"].clone()
    report = ir.ir_preflight(eng, origin="live")
    assert report.findings == [] and eng.forward_calls == 0
    assert torch.equal(eng._rng.get_state(), state) and torch.equal(eng._kv["k"], k0)
    spec = eng.enumerate_executables()[0]
    assert spec.owner is not eng and spec.args["kv"]["k"].device.type == "meta"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

FAST = ["--model", MODEL, "--seq-len", "256", "--decode-chunk", "2"]


def test_cli_exit_codes_json_suppress_and_list_checks(monkeypatch, capsys, tmp_path):
    assert ir.main(FAST) == 0
    assert "findings: none" in capsys.readouterr().out
    assert ir.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in ir.IR_RULES)
    assert ir.main([]) == 2 and "need --model" in capsys.readouterr().err
    assert ir.main(FAST + ["--suppress", "nope=why"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    assert ir.main(FAST + ["--suppress", "trace-failure"]) == 2
    assert "justification" in capsys.readouterr().err

    # a planted finding: the decode chunk cannot trace
    from mdi_llm_tpu_torch.serving.engine import ServingEngine

    def broken(self, tok, pos, tables, limit, stop_tok):
        raise RuntimeError("planted")

    monkeypatch.setattr(ServingEngine, "_decode_chunk_body", broken)
    assert ir.main(FAST + ["--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["errors"] == 1 and out["findings"][0]["rule"] == "trace-failure"
    assert ir.main(FAST + ["--suppress", "trace-failure=known, tracked"]) == 0
    assert "suppressed: trace-failure (known, tracked)" in capsys.readouterr().out
    base = tmp_path / "base.json"
    assert ir.main(FAST + ["--update-baseline", str(base)]) == 0
    capsys.readouterr()
    assert ir.main(FAST + ["--baseline", str(base), "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["new_errors"] == 0


def test_cli_sequential_adds_the_generate_steps(capsys):
    assert ir.main(FAST + ["--sequential", "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "5", "--chunk-size", "4", "--format", "json"]) == 0
    names = [r["name"] for r in json.loads(capsys.readouterr().out)["executables"]]
    assert names == ["mixed(8,136)", "decode_chunk(8,2)", "prefill(2,16)", "decode_chunk(2,4)"]
