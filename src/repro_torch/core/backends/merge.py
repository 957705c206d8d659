"""Write-mask / atomic-delta merge semantics.

Every execution level that runs CUDA code on *copies* of memory -- a
chunk of blocks (the ``vmap`` backend) or the per-warp copies of shared
and global memory under the batched ``(n_warps, W)`` warp plane
(``execute.py``) -- reconciles those copies here, under one contract:

* **plain stores** are single-writer: CUDA's race-freedom contract
  guarantees at most one copy stores to a given element between syncs,
  so the merged value is *the* writer's value, moved bit-exactly
  (:func:`select_writer`: the payload bits travel through a masked
  integer sum whose other terms are zero);
* **atomics** are order-free reductions: each copy accumulates its own
  delta buffer and the deltas are summed over the copies;
* elements nobody touched keep the carried-in value.

Delta buffers live in the "numeric image" of the array dtype
(:func:`num`: bool widens to int32).  ``u32`` is carried in int64 (see
``types``), so every sum of its deltas wraps back into ``[0, 2**32)``.

Within one merge scope blocks do not observe each other's atomic
updates.  Kernels that capture atomic old values (the ticket pattern)
would observe it, so the plan refuses them on these paths
(``LaunchPlan.check_mergeable`` / ``check_warp_batchable``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..types import U32_MASK

# floats travel as the same-width integer type
_BITS = {
    torch.float32: torch.int32,
    torch.float16: torch.int16,
    torch.bfloat16: torch.int16,
}


def num(x: torch.Tensor) -> torch.Tensor:
    """Numeric image of an array (bool -> int32) for delta arithmetic."""
    return x.to(torch.int32) if x.dtype == torch.bool else x


def denum(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`num` for a target dtype."""
    return (x != 0) if dt == torch.bool else x.to(dt)


def num_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.int32 if dt == torch.bool else dt


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Bring int64-carried u32 sums back into range."""
    return x & U32_MASK if x.dtype == torch.int64 else x


def zeros_masks(globals_: Dict[str, Any], shape=()) -> Dict[str, torch.Tensor]:
    """Write masks for ``globals_``, with leading copy axes ``shape``."""
    return {
        k: torch.zeros(tuple(shape) + v.shape[-1:], dtype=torch.bool, device=v.device)
        for k, v in globals_.items()
    }


def zeros_deltas(globals_: Dict[str, Any], shape=()) -> Dict[str, torch.Tensor]:
    """Delta accumulators for ``globals_``, already in the numeric image."""
    return {
        k: torch.zeros(
            tuple(shape) + v.shape[-1:], dtype=num_dtype(v.dtype), device=v.device
        )
        for k, v in globals_.items()
    }


def _to_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit image for exact payload transport: floats reinterpreted as
    the same-width integer type, bool widened to int32, ints as they are
    (int64 holds u32 and passes through)."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    bits = _BITS.get(x.dtype)
    return x if bits is None else x.view(bits)


def _from_bits(b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_to_bits`."""
    if dt == torch.bool:
        return b != 0
    return b.view(dt) if dt in _BITS else b


def select_writer(carry, copies, masks, *, axis: int = 0):
    """Single-writer selection along ``axis`` of ``copies``: the merged
    value at each element is *the* writing copy's value; untouched
    elements keep ``carry``.  Returns ``(merged, wrote_any)``.

    The payload moves bit-exactly: values are reinterpreted as integers
    and summed under the masks with an explicit integer ``dtype``, and
    every term but the writer's is zero, so every bit pattern (-0.0, NaN
    payloads) survives.  A racy kernel (two writers between syncs) gets
    a garbage sum instead of an arbitrary winner -- both outside the
    contract."""
    cb = _to_bits(carry)
    xb = _to_bits(copies)
    stored = torch.where(masks, xb, torch.zeros((), dtype=xb.dtype, device=xb.device))
    stored = stored.sum(dim=axis, dtype=cb.dtype)
    any_w = masks.any(dim=axis)
    return _from_bits(torch.where(any_w, stored, cb), carry.dtype), any_w


def merge_chunk(
    g: Dict[str, torch.Tensor],
    chunk_g: Dict[str, torch.Tensor],
    chunk_m: Dict[str, torch.Tensor],
    chunk_d: Dict[str, torch.Tensor],
    *,
    fold_deltas: bool,
    axis: int = 0,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Merge an ``axis``-batched set of per-copy memories into carry
    ``g``.  ``chunk_g``/``chunk_m`` hold the copies and write masks of
    the arrays the copies may store to, ``chunk_d`` the deltas of the
    atomic targets; an array in neither keeps its carry.

    Returns ``(g_new, wrote_any, delta_sum)``: the union of the copies'
    write masks per stored array and the summed deltas per atomic target
    (numeric image).  With ``fold_deltas=True`` the summed deltas are
    applied to ``g_new``; with ``False`` the caller owns them (the
    batched warp plane under a block-parallel backend, whose block keeps
    its own delta buffers)."""
    out: Dict[str, torch.Tensor] = {}
    wrote: Dict[str, torch.Tensor] = {}
    dsum: Dict[str, torch.Tensor] = {}
    for k, carry in g.items():
        new = carry
        if k in chunk_g:
            new, wrote[k] = select_writer(carry, chunk_g[k], chunk_m[k], axis=axis)
        if k in chunk_d:
            d = chunk_d[k]
            d = wrap(d.sum(dim=axis, dtype=d.dtype))
            dsum[k] = d
            if fold_deltas:
                new = denum(wrap(num(new) + d), carry.dtype)
        out[k] = new
    return out, wrote, dsum
