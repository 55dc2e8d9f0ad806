"""`python -m mdi_llm_tpu_torch.analysis [lint] ...` runs the lint,
`python -m mdi_llm_tpu_torch.analysis audit ...` the plan audit.  The JAX
package's `ir`, `flow` and `check` subcommands are refused (item 18.3)."""

import sys

from mdi_llm_tpu_torch.analysis.cli import dispatch

raise SystemExit(dispatch(sys.argv[1:]))
