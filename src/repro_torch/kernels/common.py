"""Shared helpers for the kernel wrappers."""

from __future__ import annotations

import torch


def check_cuda_input(x: torch.Tensor, what: str, dtypes) -> None:
    """Raise on a tensor the CUDA kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not in {sorted(map(str, dtypes))}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input")


def stream_of(x: torch.Tensor) -> int:
    """The current stream of ``x``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(x.device).cuda_stream
