"""Hand-written CUDA kernels (sources in ../csrc) and their plain versions."""
