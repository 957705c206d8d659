"""Write-mask / atomic-delta merge semantics.

Every execution level that runs CUDA code on *copies* of memory -- a
chunk of blocks (the ``vmap`` backend), one device's slice of the grid
(the ``sharded`` backend) or the per-warp copies of shared and global
memory under the batched ``(n_warps, W)`` warp plane (``execute.py``)
-- reconciles those copies here, under one contract:

* **plain stores** are single-writer: CUDA's race-freedom contract
  guarantees at most one copy stores to a given element between syncs,
  so the merged value is *the* writer's value, moved bit-exactly
  (:func:`select_writer`: the payload bits travel through a masked
  integer sum whose other terms are zero);
* **atomics** are order-free reductions: each copy accumulates its own
  delta buffer and the deltas are summed over the copies (and across
  devices, :func:`cross_device_merge`);
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


def _ordered_sum(parts):
    """The reference's ``psum`` over the mesh axis, term for term: one
    device's value as it is; over several, ``0 + x_0 + x_1 + ...`` in
    mesh order (XLA's host all-reduce starts from the identity, so a
    lone ``-0.0`` comes back ``+0.0`` and float sums round in that
    order)."""
    if len(parts) == 1:
        return parts[0]
    acc = torch.zeros_like(parts[0])
    for x in parts:
        acc = acc + x
    return acc


def cross_device_merge(
    g0: Dict[str, torch.Tensor],
    g: Dict[str, torch.Tensor],
    masks: Dict[str, torch.Tensor],
    deltas: Dict[str, torch.Tensor],
    axis,
    *,
    has_atomics: bool,
) -> Dict[str, torch.Tensor]:
    """Reconcile the devices' copies of global memory across the mesh
    axis ``axis`` (a ``sharded.AxisGroup``).  ``g`` is this device's
    copy, ``masks`` the elements its blocks stored (stored arrays only)
    and ``deltas`` its summed atomic deltas (atomic targets only), both
    over every wave it ran.

    Stores land as the **numeric image** through the masked sum of
    ``where(mask, num(g), 0)`` over the devices, with a count of writers
    (``int32``); elements no device wrote keep ``g0``.  Atomic deltas
    are summed across the devices.  Every sum runs in mesh order from
    the devices' gathered copies (:func:`_ordered_sum`), so it is
    bitwise the reference's ``psum``, float deltas included; u32 sums
    wrap modulo 2**32.  As in the reference, a kernel with atomics adds
    a (zero) delta sum to *every* array, which turns a ``-0.0`` into
    ``+0.0``."""
    keys = [k for k in g0 if k in masks or k in deltas]
    payload = []
    for k in keys:
        if k in masks:
            payload += [masks[k], g[k]]
        if k in deltas:
            payload.append(deltas[k])
    gathered = axis.gather(payload) if payload else []
    merged: Dict[str, torch.Tensor] = {}
    i = 0
    for k, carry in g0.items():
        val = num(carry)
        if k in masks:
            ms = [parts[i] for parts in gathered]
            vs = [num(parts[i + 1]) for parts in gathered]
            i += 2
            zero = torch.zeros((), dtype=vs[0].dtype, device=vs[0].device)
            stored = wrap(_ordered_sum([torch.where(m, v, zero) for m, v in zip(ms, vs)]))
            cnt = _ordered_sum([m.to(torch.int32) for m in ms])
            val = torch.where(cnt > 0, stored, val)
        if k in deltas:
            val = wrap(val + _ordered_sum([parts[i] for parts in gathered]))
            i += 1
        elif has_atomics:
            val = val + torch.zeros((), dtype=val.dtype, device=val.device)
        merged[k] = denum(val, carry.dtype)
    return merged

