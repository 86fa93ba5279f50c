"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the wrapper takes the plain version for a CPU tensor (and for
a meta tensor, which the analysis tier's shape oracle hands it: nothing
is computed) and launches the kernel (or raises) for a CUDA tensor."""
