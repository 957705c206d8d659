"""Decode attention: the CUDA kernel ``csrc/flash_decode.cu`` and its
wrapper.

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_decode_kernel`` (``flash_decode``).
The TPU wrapper takes one sequence and is vmapped over the batch; this one
takes the batch natively, and reads the KV cache in its ``(B, S, Hkv, D)``
layout through its strides, with no transposed copy, and splits S into
ranges that a second kernel combines (``num_splits``).  A CUDA tensor
launches the kernel; a CPU tensor takes the plain version
(``ref.decode_attention``).  ``launches`` counts the calls that launch
the kernel (with its combine kernel when S is split), and only those.
The prefill kernel (``_flash_kernel``) is not ported yet (ROADMAP B.6).
"""

from __future__ import annotations

import torch

from . import build, ref
from .common import check_cuda_input, stream_of

launches = 0

# what the kernel is compiled for: qwen2.5-14b's D = 128 and the reference
# sweeps' 64, in bf16 (serving) and f32 (the cross-checks)
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TILE_ROWS = 32  # K/V rows per tile (csrc/flash_decode.cu BK)
BLOCKS_PER_SM = 4  # the split over S aims at this many blocks per SM
MAX_SPLITS = 64

_SM_COUNT: dict = {}


def num_splits(batch: int, n_kv: int, seq_len: int, device: torch.device) -> int:
    """How many ranges of S each (batch row, kv head) is split into: enough
    blocks for BLOCKS_PER_SM on every SM, at least one tile per range at
    full length, at most MAX_SPLITS."""
    sms = _SM_COUNT.get(device.index)
    if sms is None:
        sms = _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device
        ).multi_processor_count
    want = -(-BLOCKS_PER_SM * sms // (batch * n_kv))
    tiles = -(-seq_len // TILE_ROWS)
    return max(1, min(want, tiles, MAX_SPLITS))


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
) -> torch.Tensor:
    """q: (B, H, D); caches: (B, S, Hkv, D); kv_len: (B,) int32 -> (B, H, D).

    Query head h attends to kv head ``h // (H // Hkv)`` over the positions
    ``< kv_len`` (all of them when ``kv_len > S``; zeros out when
    ``kv_len == 0``), with scale ``1/sqrt(D)``."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, kv_len)
    return flash_decode_cuda(q, k_cache, v_cache, kv_len)


def _check_cache(c: torch.Tensor, what: str, q: torch.Tensor) -> None:
    if c.device != q.device or c.dtype != q.dtype:
        raise ValueError(f"{what}: {c.dtype} on {c.device}, q is {q.dtype} on {q.device}")
    if c.dim() != 4 or c.shape[0] != q.shape[0] or c.shape[3] != q.shape[2]:
        raise ValueError(f"{what}: expected (B, S, Hkv, D), got {tuple(c.shape)}")
    # rows are read as 16-byte vectors: D contiguous, every row aligned
    vec = 16 // c.element_size()
    if c.stride(3) != 1 or any(s % vec for s in c.stride()[:3]):
        raise ValueError(f"{what}: D must be contiguous and rows 16-byte strided")
    if c.data_ptr() % 16:
        raise ValueError(f"{what}: the cache must start on a 16-byte boundary")


def flash_decode_cuda(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
) -> torch.Tensor:
    global launches
    check_cuda_input(q, "flash_decode q", DTYPES)
    if q.dim() != 3:
        raise ValueError(f"flash_decode q: expected (B, H, D), got {tuple(q.shape)}")
    B, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in {HEAD_DIMS}")
    _check_cache(k_cache, "flash_decode k_cache", q)
    _check_cache(v_cache, "flash_decode v_cache", q)
    if k_cache.shape != v_cache.shape:
        raise ValueError("flash_decode: k_cache and v_cache differ in shape")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_decode: {H} query heads over {Hkv} kv heads")
    check_cuda_input(kv_len, "flash_decode kv_len", (torch.int32,))
    if kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"flash_decode kv_len: expected ({B},) on {q.device}")
    out = torch.empty_like(q)
    nsplit = num_splits(B, Hkv, S, q.device)
    # per split: (max, sum) and acc for every query head, f32
    part = torch.empty(B * H * nsplit * (D + 2) if nsplit > 1 else 0, device=q.device)
    fn = build.library("flash_decode").cox_flash_decode
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(),
            k_cache.data_ptr(),
            v_cache.data_ptr(),
            kv_len.data_ptr(),
            out.data_ptr(),
            part.data_ptr() if nsplit > 1 else None,
            nsplit,
            B,
            H,
            Hkv,
            S,
            D,
            *k_cache.stride()[:3],
            *v_cache.stride()[:3],
            build.DTYPE_CODES[q.dtype],
            stream_of(q),
        )
    build.check(err, "cox_flash_decode")
    launches += 1
    return out
