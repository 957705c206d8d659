"""Warp-level collective implementations on torch tensors.

Two backends, mirroring the paper's Table 2 (warp vote w/ and w/o AVX):

* **vectorized** -- lane-axis tensor ops on the warp buffer (AVX on
  x86 in the paper; one CUDA kernel per op on the card).
* **scalar** -- per-lane Python loops over the lane axis (the paper's
  "w/o AVX" baseline: one operation per lane).

Every collective operates on the **last** axis of the buffer and keeps
any leading batch axes, so a whole block's collectives can be evaluated
as one ``(n_warps, W)`` lane plane in a single call.  Tile segmentation
(cooperative-group ``thread_block_tile<N>``; the static ``width``
argument) stays per warp.  Width 0 or W means the full warp.

``mask`` is the active-lane mask (threads past block_size in a partial
last warp); it broadcasts against the buffer.  Inactive lanes contribute
the operation's identity.

``u32`` values are carried in ``int64`` (see ``types``): ``ballot``
builds its mask in int64, so lane 31 sets bit 31 without overflow, and
the reductions treat an int64 buffer as unsigned 32-bit.
"""

from __future__ import annotations

import torch

from .types import U32_MASK, CoxUnsupported


def _tile(width: int, W: int) -> int:
    w = width or W
    if w > W or (W % w) != 0 or w & (w - 1):
        raise CoxUnsupported(f"tile width {w} invalid for warp size {W}")
    return w


def _seg(buf: torch.Tensor, w: int) -> torch.Tensor:
    """Split the lane axis into (n_segments, w) tiles, keeping any
    leading (warp-plane) axes intact."""
    return buf.reshape(buf.shape[:-1] + (-1, w))


def _unseg(seg: torch.Tensor, w: int) -> torch.Tensor:
    """Broadcast one value per segment back over its w lanes."""
    out_shape = seg.shape[:-1] + (seg.shape[-1] * w,)
    return seg[..., None].expand(seg.shape + (w,)).reshape(out_shape)


def _lanes(W: int, device) -> torch.Tensor:
    return torch.arange(W, dtype=torch.int32, device=device)


def _as_index(v, device) -> torch.Tensor:
    """An offset / source-lane operand as an int32 tensor (a Python int,
    a 0-d tensor, a (W,) lane vector or a per-warp plane).  A Python int
    becomes a fill, not a copy from host memory, so the launch stays
    capturable in a CUDA graph."""
    if isinstance(v, int):
        return torch.full((), v, dtype=torch.int32, device=device)
    return torch.as_tensor(v, device=device).to(torch.int32)


def _gather(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Per-lane gather along the lane axis.  A (W,) ``src`` is shared by
    every leading row; a wider one is broadcast against ``buf``."""
    src = src.to(torch.int64)
    if src.dim() <= 1:
        return buf.index_select(-1, src)
    return torch.gather(buf, -1, src.expand(buf.shape))


# ---------------------------------------------------------------------------
# vectorized (SIMD) backend
# ---------------------------------------------------------------------------


def shfl_down(buf, off, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    lane = _lanes(W, buf.device)
    off = _as_index(off, buf.device)
    sub = lane % w
    src = torch.clamp(lane + off, 0, W - 1)
    # CUDA: lanes whose source falls outside the tile keep their own value
    return torch.where(sub + off < w, _gather(buf, src), buf)


def shfl_up(buf, off, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    lane = _lanes(W, buf.device)
    off = _as_index(off, buf.device)
    sub = lane % w
    src = torch.clamp(lane - off, 0, W - 1)
    return torch.where(sub - off >= 0, _gather(buf, src), buf)


def shfl_xor(buf, lanemask, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    lane = _lanes(W, buf.device)
    lanemask = _as_index(lanemask, buf.device)
    src = lane ^ lanemask
    ok = (src % w) == ((lane % w) ^ lanemask)  # stays inside the tile
    src = torch.clamp(src, 0, W - 1)
    return torch.where(ok, _gather(buf, src), buf)


def shfl_idx(buf, srclane, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    lane = _lanes(W, buf.device)
    base = (lane // w) * w
    src = base + (_as_index(srclane, buf.device) % w)
    return _gather(buf, torch.clamp(src, 0, W - 1))


def vote_all(buf, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    b = buf.to(torch.bool)
    if mask is not None:
        b = b | ~mask  # inactive lanes vote True (identity of AND)
    return _unseg(_seg(b, w).all(dim=-1), w)


def vote_any(buf, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    b = buf.to(torch.bool)
    if mask is not None:
        b = b & mask
    return _unseg(_seg(b, w).any(dim=-1), w)


def ballot(buf, W: int, width: int = 0, mask=None):
    """The lane mask as an unsigned 32-bit value carried in int64."""
    w = _tile(width, W)
    b = buf.to(torch.bool)
    if mask is not None:
        b = b & mask
    weights = 1 << torch.arange(w, dtype=torch.int64, device=buf.device)
    seg = (_seg(b, w).to(torch.int64) * weights).sum(dim=-1)
    return _unseg(seg, w)


def _low(dt: torch.dtype):
    if dt.is_floating_point:
        return torch.finfo(dt).min
    return 0 if dt == torch.int64 else torch.iinfo(dt).min


def _high(dt: torch.dtype):
    if dt.is_floating_point:
        return torch.finfo(dt).max
    return U32_MASK if dt == torch.int64 else torch.iinfo(dt).max


def _sum_lanes(seg: torch.Tensor) -> torch.Tensor:
    out = seg.sum(dim=-1, dtype=seg.dtype)
    return out & U32_MASK if seg.dtype == torch.int64 else out


def red_add(buf, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    b = buf
    if mask is not None:
        b = torch.where(mask, b, torch.zeros_like(b))
    return _unseg(_sum_lanes(_seg(b, w)), w)


def red_max(buf, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    b = buf
    if mask is not None:
        b = torch.where(mask, b, torch.full_like(b, _low(b.dtype)))
    return _unseg(_seg(b, w).amax(dim=-1), w)


def red_min(buf, W: int, width: int = 0, mask=None):
    w = _tile(width, W)
    b = buf
    if mask is not None:
        b = torch.where(mask, b, torch.full_like(b, _high(b.dtype)))
    return _unseg(_seg(b, w).amin(dim=-1), w)


VECTORIZED = {
    "shfl_down": shfl_down,
    "shfl_up": shfl_up,
    "shfl_xor": shfl_xor,
    "shfl_idx": shfl_idx,
    "vote_all": vote_all,
    "vote_any": vote_any,
    "ballot": ballot,
    "red_add": red_add,
    "red_max": red_max,
    "red_min": red_min,
}


# ---------------------------------------------------------------------------
# scalar backend (per-lane loops -- the paper's "w/o AVX" rows in Table 2)
# ---------------------------------------------------------------------------
#
# Each loop walks the lane axis one lane at a time; leading axes ride
# along as a batch (``[..., i]``), which is what the reference's vmap
# lift of its 1-D loops computes.


def _scalar_vote(buf, W, width, mask, op):
    w = _tile(width, W)
    b = buf.to(torch.bool)
    if mask is not None:
        b = (b | ~mask) if op == "all" else (b & mask)
    out = torch.zeros_like(b)
    for s in range(W // w):
        acc = torch.full_like(b[..., 0], op == "all")
        for i in range(w):
            v = b[..., s * w + i]
            acc = (acc & v) if op == "all" else (acc | v)
        out[..., s * w : (s + 1) * w] = acc[..., None]
    return out


def scalar_vote_all(buf, W, width=0, mask=None):
    return _scalar_vote(buf, W, width, mask, "all")


def scalar_vote_any(buf, W, width=0, mask=None):
    return _scalar_vote(buf, W, width, mask, "any")


def scalar_red_add(buf, W, width=0, mask=None):
    w = _tile(width, W)
    b = buf if mask is None else torch.where(mask, buf, torch.zeros_like(buf))
    out = torch.zeros_like(b)
    for s in range(W // w):
        acc = torch.zeros_like(b[..., 0])
        for i in range(w):
            acc = acc + b[..., s * w + i]
        if b.dtype == torch.int64:
            acc = acc & U32_MASK
        out[..., s * w : (s + 1) * w] = acc[..., None]
    return out


def scalar_shfl_down(buf, off, W, width=0, mask=None):
    w = _tile(width, W)
    off = _as_index(off, buf.device)
    out = torch.zeros_like(buf)
    for i in range(W):
        o = off[..., i] if off.dim() else off  # per-lane or uniform offset
        src = torch.where(i % w + o < w, i + o, i)
        src = src.to(torch.int64).expand(buf.shape[:-1])
        out[..., i] = torch.gather(buf, -1, src[..., None])[..., 0]
    return out


SCALAR = dict(VECTORIZED)
SCALAR.update(
    {
        "vote_all": scalar_vote_all,
        "vote_any": scalar_vote_any,
        "red_add": scalar_red_add,
        "shfl_down": scalar_shfl_down,
    }
)


def dispatch(func: str, simd: bool):
    table = VECTORIZED if simd else SCALAR
    if func not in table:
        raise CoxUnsupported(f"unknown warp collective {func}")
    return table[func]
