"""Command-line entry points of the port (python -m mdi_llm_tpu_torch.cli.serve)."""
