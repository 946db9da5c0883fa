"""Hand-written CUDA kernels for Hopper (sources in ../csrc), their
build and their PyTorch wrappers."""
