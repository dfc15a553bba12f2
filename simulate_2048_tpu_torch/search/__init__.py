"""Batched stochastic MuZero search in plain PyTorch."""
