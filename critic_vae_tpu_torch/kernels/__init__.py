"""Hand-written CUDA kernels: build, load and launch counts."""
