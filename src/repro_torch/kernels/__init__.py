"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; see ``_build`` for how they are compiled and bound."""
