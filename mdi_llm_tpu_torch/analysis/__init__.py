"""Static analysis of the port: the lint (`mdi-lint`'s counterpart), the
plan audit (`mdi-audit`'s), the analysis of the serving steps traced on
the meta device (`ir` and `flow`, `mdi-ir`'s and `mdi-flow`'s) and the
aggregate gate (`check`, `mdi-check`'s).

The serving and generation steps of the port are CUDA graphs
(`utils/step_graph.py`): a captured body runs once, at capture, and every
replay repeats only its device work.  One host read inside such a body,
a Python branch on a tensor or a float frozen at capture silently turns
a replayed step into a wrong or a stalled one.  The lint's rules
(`rules.py`, `threads.py`) encode those invariants; the audit
(`audit.py`) refuses a plan (model, mesh, pool, budget) that cannot run
before any weight reaches the card.  `ir.py` and `liveness.py` trace every
step a serving engine can dispatch to an fx graph on the meta device
(`trace.py`; K1 and K2 are one node per launch) and check its compile set,
its in-place pool writes, its graph hygiene and its static peak of device
memory; `check.py` runs all four over one plan.

Usage::

    python -m mdi_llm_tpu_torch.analysis                    # lint the port
    python -m mdi_llm_tpu_torch.analysis lint --list-rules
    python -m mdi_llm_tpu_torch.analysis audit --model tiny-llama-1.1b --serve --hbm-gb 80
    python -m mdi_llm_tpu_torch.analysis audit --model pythia-14m --serve --liveness
    python -m mdi_llm_tpu_torch.analysis ir --model pythia-14m --tp 2
    python -m mdi_llm_tpu_torch.analysis flow --model pythia-14m --pp 2 --hbm-gb 1
    python -m mdi_llm_tpu_torch.analysis check --model pythia-14m

Findings are suppressed per line with ``# mdi-lint: disable=rule-name`` (or
``disable-next-line=`` on the preceding line); grandfathered findings live
in the committed ``lint-baseline.json`` beside this file; the flow
goldens in ``flow-goldens.json`` (the JAX package's stay in
``goldens/flow-goldens.json``).
"""

from mdi_llm_tpu_torch.analysis.core import (  # noqa: F401
    Baseline,
    Finding,
    Rule,
    RULES,
    lint_paths,
    lint_source,
)
import mdi_llm_tpu_torch.analysis.rules  # noqa: E402,F401  (populates RULES)
import mdi_llm_tpu_torch.analysis.threads  # noqa: E402,F401  (thread-role rules)

__all__ = [
    "Baseline", "Finding", "Rule", "RULES", "lint_paths", "lint_source",
    # the audit (lazy: the bare lint needs no torch import)
    "AUDIT_RULES", "AuditReport", "MeshSpec", "PlanSpec", "audit_plan",
    "preflight",
]

_AUDIT_NAMES = {"AUDIT_RULES", "AuditReport", "audit_plan", "preflight"}
_PLAN_NAMES = {"MeshSpec", "PlanSpec"}


def __getattr__(name):
    if name in _AUDIT_NAMES:
        from mdi_llm_tpu_torch.analysis import audit

        return getattr(audit, name)
    if name in _PLAN_NAMES:
        from mdi_llm_tpu_torch.analysis import plan

        return getattr(plan, name)
    raise AttributeError(name)
