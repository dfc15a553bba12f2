"""Functional batched 2048 environment."""
