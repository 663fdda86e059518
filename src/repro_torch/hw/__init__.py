"""Hardware-twin pieces the serving scheduler needs (admission cost and
step budget)."""
