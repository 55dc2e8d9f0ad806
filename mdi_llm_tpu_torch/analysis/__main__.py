"""`python -m mdi_llm_tpu_torch.analysis [lint] ...` runs the lint,
`... audit ...` the plan audit, `... ir ...` and `... flow ...` the
analysis of the traced serving steps, `... check ...` all four."""

import sys

from mdi_llm_tpu_torch.analysis.cli import dispatch

raise SystemExit(dispatch(sys.argv[1:]))
