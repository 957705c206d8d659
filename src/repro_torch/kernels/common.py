"""Shared helpers for the kernel wrappers."""

from __future__ import annotations

import torch

# Devices whose tensors take a kernel's plain version: the CPU, where it
# computes, and ``meta``, where it computes nothing and gives the shapes
# alone (the dry run, ``launch/dryrun.py``).  A CUDA tensor never does.
PLAIN_DEVICES = ("cpu", "meta")


def plain_route(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain version (a CPU or meta tensor)."""
    return x.device.type in PLAIN_DEVICES


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


_SM_COUNT: dict = {}


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (cached)."""
    sms = _SM_COUNT.get(device.index)
    if sms is None:
        props = torch.cuda.get_device_properties(device)
        sms = _SM_COUNT[device.index] = props.multi_processor_count
    return sms
