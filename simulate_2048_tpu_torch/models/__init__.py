"""The six Stochastic MuZero networks and their bundle."""
