"""The decoder-only transformer of the port (models/transformer.py)."""
