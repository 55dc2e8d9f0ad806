"""Host-side helpers of the port (no torch device work)."""
