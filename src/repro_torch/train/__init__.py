"""train (port of repro.train)."""
