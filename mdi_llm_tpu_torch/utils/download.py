"""HuggingFace Hub checkpoint download of the port.

Port of `mdi_llm_tpu/utils/download.py`: a pattern-filtered snapshot
download (tokenizer + weights, safetensors preferred) into
`<checkpoints_dir>/<org>/<name>`, friendly errors for gated and missing
repos, then the conversion to the port's checkpoint (`params.pt` +
`model_config.yaml`, `utils/checkpoint.convert_hf_checkpoint`).

With `HF_HUB_OFFLINE=1` set before `huggingface_hub` is imported, nothing
is fetched: `snapshot_download` returns the target directory when it
already holds files (a snapshot copied there by hand), and raises
`LocalEntryNotFoundError` when it is empty.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

PathLike = Union[str, Path]

_WEIGHT_PATTERNS = ["*.safetensors*", "*.bin*", "*.json", "tokenizer.model"]
_TOKENIZER_PATTERNS = ["tokenizer*", "*.json", "*.model"]


def download_from_hub(
    repo_id: str,
    checkpoints_dir: PathLike = "checkpoints",
    access_token: Optional[str] = None,
    tokenizer_only: bool = False,
    convert: bool = True,
    dtype=None,
) -> Path:
    """Download `org/name` into `checkpoints_dir/org/name` and, unless
    `tokenizer_only` or not `convert`, convert it in place (`dtype`,
    default bfloat16).  Returns the directory."""
    from huggingface_hub import snapshot_download
    from huggingface_hub.utils import GatedRepoError, RepositoryNotFoundError

    out = Path(checkpoints_dir) / repo_id
    patterns = _TOKENIZER_PATTERNS if tokenizer_only else _WEIGHT_PATTERNS
    try:
        snapshot_download(repo_id, local_dir=out, allow_patterns=patterns, token=access_token)
    except GatedRepoError as e:
        raise RuntimeError(
            f"{repo_id} is a gated repo: accept the license on huggingface.co and "
            "pass --access-token (≡ reference gated_repo_catcher)"
        ) from e
    except RepositoryNotFoundError as e:
        raise RuntimeError(f"repository {repo_id!r} not found on the HF hub") from e

    if convert and not tokenizer_only:
        import torch

        from mdi_llm_tpu_torch.utils.checkpoint import convert_hf_checkpoint

        convert_hf_checkpoint(out, dtype=dtype or torch.bfloat16)
    return out
