"""Training configuration and greedy evaluation."""
