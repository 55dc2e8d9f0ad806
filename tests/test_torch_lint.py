"""The port's lint (`mdi_llm_tpu_torch/analysis/`) on the CPU.

- the thread rules (`threads.py`, a copy of the JAX package's) give the
  same findings as the JAX `threads.py` on the same sources: the JAX lint
  tests' thread fixtures and both packages' `server/` and `serving/`
  modules, one case per source;
- the capture detector (`core.ModuleInfo`) finds the port's real capture
  sites: the engine's, `Generator`'s and the ring's step bodies, a
  helper that relays its body argument, `.capture(fn)`, a
  `torch.cuda.graph` block and the `# mdi-lint: captured` mark;
- every torch rule triggers on a bad fixture and stays silent on its good
  twin;
- suppressions, the baseline workflow and the CLI (`lint`, `ir`/`flow`/
  `check` refused);
- the self-check: `mdi_llm_tpu_torch/` lints clean against its committed
  (empty) baseline.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from mdi_llm_tpu.analysis import lint_source as jlint_source
from mdi_llm_tpu_torch.analysis import RULES, lint_paths, lint_source
from mdi_llm_tpu_torch.analysis.cli import dispatch
from mdi_llm_tpu_torch.analysis.cli import main as lint_main
from mdi_llm_tpu_torch.analysis.core import BASELINE_PATH, Baseline, ModuleInfo
from tests.test_lint import BAD as JBAD
from tests.test_lint import GOOD as JGOOD
from tests.test_threads import SPAWNER

REPO = Path(__file__).resolve().parents[1]
THREAD_RULES = (
    "unguarded-shared-state",
    "blocking-in-event-loop",
    "lock-order-inversion",
    "loop-call-from-wrong-thread",
)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def lint_rule(src, rule):
    return lint_source(src, path="snippet.py", select=[rule])


# ---------------------------------------------------------------------------
# the thread rules against the JAX package's
# ---------------------------------------------------------------------------

_SERVER_FILES = ("server/frontend.py", "server/http.py", "server/explorer.py",
                 "serving/scheduler.py", "serving/engine.py")
THREAD_SOURCES = {
    **{f"jax-fixture-{kind}-{rule}": fixtures[rule]
       for kind, fixtures in (("bad", JBAD), ("good", JGOOD)) for rule in THREAD_RULES},
    "spawner": SPAWNER,
    **{f"{pkg}/{f}": (REPO / pkg / f).read_text()
       for pkg in ("mdi_llm_tpu", "mdi_llm_tpu_torch") for f in _SERVER_FILES},
}


def _key(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("label", sorted(THREAD_SOURCES))
def test_thread_rules_match_jax(label):
    src = THREAD_SOURCES[label]
    got = lint_source(src, path="snippet.py", select=list(THREAD_RULES))
    want = jlint_source(src, path="snippet.py", select=list(THREAD_RULES))
    assert _key(got) == _key(want)
    if "-bad-" in label:
        assert got, "the bad fixture must trigger"


# ---------------------------------------------------------------------------
# the capture detector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path,want", [
    ("serving/engine.py", {"_mixed_body", "_decode_chunk_body", "_decode_body"}),
    ("serving/pipeline.py", {"_decode_chunk_body"}),
    ("generation.py", {"_decode_steps"}),
    ("parallel/pipeline.py", {"_decode_body"}),
    ("utils/step_graph.py", {"call"}),
])
def test_capture_sites_of_the_port(path, want):
    mod = ModuleInfo(path, (REPO / "mdi_llm_tpu_torch" / path).read_text())
    assert {c.name for c in mod.captured} == want
    if path == "utils/step_graph.py":
        assert len(mod.graph_blocks) == 1  # CudaGraph.capture's torch.cuda.graph block
    if path == "serving/engine.py":  # the step helper relays StepGraph's body
        mixed = next(c for c in mod.captured if c.name == "_mixed_body")
        assert "self" not in mixed.tensor_params() and "tokens" in mixed.tensor_params()


def test_static_names_are_not_tensors():
    src = """
from mdi_llm_tpu_torch.utils.step_graph import StepGraph

class G:
    def _body(self, *, kv, n_steps: int, mode: str, tok):
        if mode == "greedy":
            return tok
        while n_steps > 0:
            n_steps -= 1
        return tok

    def step(self, key):
        return StepGraph("s", key, self, G._body, dict(tok=None),
                         static=dict(kv=None, n_steps=2, mode="greedy"), capture=True)
"""
    assert lint_rule(src, "tensor-branch") == []
    (c,) = ModuleInfo("s.py", src).captured
    assert c.tensor_params() == {"tok"}


# ---------------------------------------------------------------------------
# per-rule fixtures
# ---------------------------------------------------------------------------

STEP = "from mdi_llm_tpu_torch.utils.step_graph import StepGraph\nimport torch\nimport time\n"

BAD = {
    "host-sync-in-capture": STEP + """
class E:
    def _body(self, tok):
        n = int(tok.sum().item())
        return tok[:n]

    def build(self):
        return StepGraph("s", (1,), self, E._body, dict(tok=None), capture=True)
""",
    "host-sync": """
import torch

def decode(step, tok):
    toks = []
    for _ in range(8):
        tok = step(tok)
        toks.append(tok.tolist())  # per-token read of a device value
    torch.cuda.synchronize()
    return toks
""",
    "tensor-branch": STEP + """
class E:
    def _body(self, tok, pos):
        if pos > 0:
            return tok * 2
        return tok

    def build(self):
        return StepGraph("s", (1,), self, E._body, dict(tok=None, pos=None), capture=True)
""",
    "captured-scalar-arg": STEP + """
def body(owner, x, temperature: float = 0.7):
    return x / temperature

def build(owner):
    return StepGraph("s", (1,), owner, body, dict(x=None), capture=True)
""",
    "capture-in-loop": STEP + """
def warm(owner, body, keys):
    out = []
    for k in keys:
        out.append(StepGraph("s", k, owner, body, {}, capture=True))
    return out
""",
    "mutable-global-in-capture": STEP + """
TABLE = {"scale": 2.0}

def body(owner, x):
    return x * TABLE["scale"]

def build(owner):
    return StepGraph("s", (1,), owner, body, dict(x=None), capture=True)
""",
    "timing-in-capture": STEP + """
def run(graph, x):
    with torch.cuda.graph(graph):
        t0 = time.perf_counter()
        y = x * 2
    return y, t0
""",
    "scalar-tensor-in-capture": STEP + """
def run(graph, x, limit):
    return graph.capture(lambda: torch.minimum(x, torch.tensor(limit, device=x.device)))
""",
}

GOOD = {
    "host-sync-in-capture": STEP + """
class E:
    def _body(self, tok):
        return tok.cumsum(0)

    def build(self):
        return StepGraph("s", (1,), self, E._body, dict(tok=None), capture=True)

    def read(self, step):
        return step.run(tok=None).tolist()  # after the replay, on the host
""",
    "host-sync": """
import torch

def decode(step, tok):
    toks = []
    for _ in range(8):
        tok = step(tok)
        toks.append(tok)
    return torch.stack(toks).tolist()  # one read after the loop
""",
    "tensor-branch": STEP + """
class E:
    def _body(self, tok, pos):
        if tok.dim() == 2 and pos is not None:
            return torch.where(pos > 0, tok * 2, tok)
        return tok

    def build(self):
        return StepGraph("s", (1,), self, E._body, dict(tok=None, pos=None), capture=True)
""",
    "captured-scalar-arg": STEP + """
def body(owner, x, t_op):
    return x / t_op

def build(owner):
    return StepGraph("s", (1,), owner, body, dict(x=None, t_op=None), capture=True)
""",
    "capture-in-loop": STEP + """
def warm(steps):
    for s in steps:
        s.prime()  # each step captures once, cached per key

def build(owner, body, key):
    return StepGraph("s", key, owner, body, {}, capture=True)
""",
    "mutable-global-in-capture": STEP + """
SCALE = 2.0

def body(owner, x):
    return x * SCALE

def build(owner):
    return StepGraph("s", (1,), owner, body, dict(x=None), capture=True)
""",
    "timing-in-capture": STEP + """
def run(graph, x):
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        y = x * 2
    return y, time.perf_counter() - t0
""",
    "scalar-tensor-in-capture": STEP + """
def run(graph, x, limit):
    return graph.capture(lambda: torch.clamp(x, max=limit))
""",
}


def test_every_rule_has_fixtures():
    assert set(BAD) | set(THREAD_RULES) == set(RULES)
    assert set(GOOD) | set(THREAD_RULES) == set(RULES)


@pytest.mark.parametrize("rule", sorted(BAD))
def test_rule_triggers_on_bad_fixture(rule):
    findings = lint_rule(BAD[rule], rule)
    assert findings, f"{rule} missed its bad fixture"
    assert all(f.rule == rule and f.line >= 1 and f.message for f in findings)


@pytest.mark.parametrize("rule", sorted(GOOD))
def test_rule_passes_on_good_fixture(rule):
    assert lint_rule(GOOD[rule], rule) == [], f"{rule} false-positived"


def test_captured_mark_and_relayed_bodies():
    src = STEP + """
class Sub:
    def _body(self, tok):  # mdi-lint: captured
        return tok.tolist()

def helper(owner, name, fn, **inputs):
    return StepGraph(name, (1,), owner, fn, inputs, capture=True)

def body2(owner, tok):
    return tok.item()

def build(owner):
    return helper(owner, "x", body2, tok=None)
"""
    findings = lint_rule(src, "host-sync-in-capture")
    assert sorted(f.line for f in findings) == [7, 13]


# ---------------------------------------------------------------------------
# suppressions, baseline, CLI
# ---------------------------------------------------------------------------

VIOLATION = """
import torch

def drain():
    torch.cuda.synchronize()
"""


def test_suppressions():
    sup = VIOLATION.replace("synchronize()", "synchronize()  # mdi-lint: disable=host-sync -- ok")
    assert lint_source(sup, select=["host-sync"]) == []
    other = sup.replace("disable=host-sync", "disable=tensor-branch")
    assert rules_of(lint_source(other, select=["host-sync"])) == ["host-sync"]
    nxt = VIOLATION.replace("    torch.cuda.synchronize()",
                            "    # mdi-lint: disable-next-line=all -- drain\n"
                            "    torch.cuda.synchronize()")
    assert lint_source(nxt) == []


def test_baseline_grandfathers_then_a_new_violation_fails(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    mod.write_text(VIOLATION)
    baseline = tmp_path / "baseline.json"
    assert lint_main([str(mod), "--baseline", str(baseline), "--update-baseline"]) == 0
    assert lint_main([str(mod), "--baseline", str(baseline)]) == 0
    mod.write_text("import os\n\n" + VIOLATION + "\ndef f(x):\n    return x.item()\n")
    assert lint_main([str(mod), "--baseline", str(baseline)]) == 1
    out = capsys.readouterr().out
    assert "x.item()" not in out and "host-sync" in out and "grandfathered" in out
    findings, _ = lint_paths([mod], select=["host-sync"])
    new, old = Baseline.load(baseline).split(findings)
    assert len(old) == 1 and len(new) == 1


def test_cli_surface(tmp_path, capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in RULES)
    assert lint_main(["--select", "no-such-rule"]) == 2
    mod = tmp_path / "mod.py"
    mod.write_text(VIOLATION)
    assert lint_main([str(mod), "--no-baseline", "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["findings"][0]["rule"] == "host-sync"
    assert lint_main([str(tmp_path / "missing")]) == 2
    assert dispatch(["lint", str(mod), "--no-baseline"]) == 1
    for sub in ("ir", "flow", "check"):
        assert dispatch([sub]) == 2  # usage: no model to trace
        assert "need --model" in capsys.readouterr().err


def test_module_entry_point_lints_the_port_clean():
    """The self-check: `python -m mdi_llm_tpu_torch.analysis` from the
    repository root lints the port against the committed baseline, which
    is empty (every finding is fixed or suppressed on its line with a
    reason)."""
    assert Baseline.load(BASELINE_PATH).counts == {}
    proc = subprocess.run([sys.executable, "-m", "mdi_llm_tpu_torch.analysis"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert proc.stdout.strip().endswith("mdi-lint: 0 finding(s)")


def test_port_lints_clean_in_process():
    findings, errors = lint_paths([REPO / "mdi_llm_tpu_torch"], root=REPO)
    assert not errors
    new, _ = Baseline.load(BASELINE_PATH).split(findings)
    assert new == [], "\n".join(f.render() for f in new)
