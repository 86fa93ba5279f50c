"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the wrapper takes the plain version for a CPU tensor and
launches the kernel (or raises) for a CUDA tensor."""
