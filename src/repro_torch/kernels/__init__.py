"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``).  A wrapper launches its kernel for a CUDA tensor
and runs the plain version for a CPU tensor."""
