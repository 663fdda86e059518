"""optim (port of repro.optim)."""
