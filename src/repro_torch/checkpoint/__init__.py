"""checkpoint (port of repro.checkpoint)."""
