"""Board ops, spawn RNG, value transform and the CUDA kernels with their plain versions."""
