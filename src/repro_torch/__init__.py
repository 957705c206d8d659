"""repro_torch: the COX system ported to PyTorch and CUDA (NVIDIA Hopper).

``repro_torch.core`` is the kernel compiler and launcher (the paper's
hierarchical collapsing, run eagerly on torch tensors);
``repro_torch.kernels`` holds the hand-written CUDA kernels with their
plain PyTorch versions.  The package imports neither ``jax`` nor
``repro``.
"""
