"""Multi-prompt loading: `get_user_prompt`, copied from
`mdi_llm_tpu/utils/prompts.py`.  Prompt styles and stop-token sequences
need a tokenizer and wait for the tokenizer slice (ROADMAP Queue 1,
item 9)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List


def get_user_prompt(prompt: str, n_samples: int) -> List[str]:
    """Resolve `prompt` into exactly `n_samples` prompt strings.

    `FILE:<path>` loads a text file with one prompt per blank-line-separated
    paragraph; fewer paragraphs than samples cycle, more are truncated.
    """
    if prompt.startswith("FILE:"):
        path = Path(prompt[len("FILE:") :])
        text = path.read_text()
        paragraphs = [p.strip() for p in re.split(r"\n\s*\n", text) if p.strip()]
        if not paragraphs:
            raise ValueError(f"prompt file {path} is empty")
    else:
        paragraphs = [prompt]
    return [paragraphs[i % len(paragraphs)] for i in range(n_samples)]
