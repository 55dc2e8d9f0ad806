"""Static analysis of the port: the lint (`mdi-lint`'s counterpart) and
the plan audit (`mdi-audit`'s).

The serving and generation steps of the port are CUDA graphs
(`utils/step_graph.py`): a captured body runs once, at capture, and every
replay repeats only its device work.  One host read inside such a body,
a Python branch on a tensor or a float frozen at capture silently turns
a replayed step into a wrong or a stalled one.  The lint's rules
(`rules.py`, `threads.py`) encode those invariants; the audit
(`audit.py`) refuses a plan (model, mesh, pool, budget) that cannot run
before any weight reaches the card.

Usage::

    python -m mdi_llm_tpu_torch.analysis                    # lint the port
    python -m mdi_llm_tpu_torch.analysis lint --list-rules
    python -m mdi_llm_tpu_torch.analysis audit --model tiny-llama-1.1b --serve --hbm-gb 80

Findings are suppressed per line with ``# mdi-lint: disable=rule-name`` (or
``disable-next-line=`` on the preceding line); grandfathered findings live
in the committed ``lint-baseline.json`` beside this file.  The JAX
package's ``ir``, ``flow`` and ``check`` tools (compiled-program
analysis) are not ported yet: ROADMAP item 18.3.
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
