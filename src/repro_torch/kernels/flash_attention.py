"""Attention kernels: ``csrc/flash_decode.cu`` (serving) and
``csrc/flash_attention.cu`` (training and prefill), with their wrappers.

``flash_decode`` replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_decode_kernel``.  The TPU wrapper
takes one sequence and is vmapped over the batch; this one takes the batch
natively, and reads the KV cache in its ``(B, S, Hkv, D)`` layout through
its strides, with no transposed copy; a block serves ``head_group`` query
heads of a kv head, and S is split into ranges that a second kernel
combines (``num_splits``).

``flash_attention`` replaces the TPU kernel ``_flash_kernel`` (the
reference's ``flash_attention``), batched in the same way: q ``(B, S, H,
D)`` and k, v ``(B, S, Hkv, D)`` read through their strides.  It is
differentiable: :class:`FlashAttentionFn` launches the forward kernel,
which also keeps each row's log-sum-exp, and the backward kernels
(``cox_flash_attention_bwd``: the gradient, which has no TPU kernel).  In
bf16 they run on the tensor cores and read 16-byte rows, so every base and
stride of q, k and v must be 16-byte aligned; the backward's dK/dV grid
splits each kv head's query-head group over ``dkdv_splits`` blocks.

A CUDA tensor launches the kernels; a CPU tensor takes the plain versions
(``ref.decode_attention``, ``ref.attention``, whose gradient is
autograd's).  ``decode_launches``, ``fwd_launches`` and ``bwd_launches``
count the calls that launch each kernel (with its helper kernels: the
decode combine, the backward's row sums and split sum), and only those.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import build, ref
from .common import check_cuda_input, plain_route, sm_count, stream_of

decode_launches = fwd_launches = bwd_launches = 0

# what the kernel is compiled for: qwen2.5-14b's D = 128 and the reference
# sweeps' 64, in bf16 (serving) and f32 (the cross-checks)
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 8  # query heads a block at most (csrc/flash_decode.cu MAX_GROUP)
BLOCKS_PER_SM = 2  # decode blocks an SM holds (the kernel's launch bounds)
SPLIT_ROWS = 64  # a split holds at least this many rows of a full cache
WAVE_FILL = 0.9  # the grid's last wave is at least this full
MAX_SPLITS = 64


@functools.lru_cache(maxsize=64)
def head_group(group: int) -> int:
    """Query heads one block serves: the largest divisor of the kv head's
    ``group`` (H / Hkv) up to MAX_GROUP, whose q and accumulators fit a
    lane's registers."""
    return max(d for d in range(1, min(group, MAX_GROUP) + 1) if group % d == 0)


def num_splits(batch: int, n_kv: int, group: int, seq_len: int, device: torch.device) -> int:
    """How many ranges of S each (batch row, kv head, head group) is split
    into.  Under one wave of resident blocks, as many as leave SPLIT_ROWS
    rows a range; above it, the fewest whose grid fills its last wave to
    WAVE_FILL, so no SM waits on a few blocks at the end.  At most
    MAX_SPLITS."""
    return _num_splits(batch, n_kv, group, seq_len, sm_count(device))


@functools.lru_cache(maxsize=256)  # a decode step asks the same, once a layer
def _num_splits(batch: int, n_kv: int, group: int, seq_len: int, sms: int) -> int:
    units = batch * n_kv * (group // head_group(group))
    slots = BLOCKS_PER_SM * sms
    most = max(1, min(MAX_SPLITS, -(-seq_len // SPLIT_ROWS)))
    if units * most <= slots:
        return most
    for n in range(1, most + 1):
        blocks = units * n
        if blocks >= WAVE_FILL * -(-blocks // slots) * slots:
            return n
    return most


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    return_lse: bool = False,
):
    """q: (B, H, D); caches: (B, S, Hkv, D); kv_len: (B,) int32 -> (B, H, D).

    Query head h attends to kv head ``h // (H // Hkv)`` over the positions
    ``< kv_len`` (all of them when ``kv_len > S``; zeros out when
    ``kv_len == 0``), with scale ``1/sqrt(D)``.  With ``return_lse`` it
    returns ``(out, lse)``, lse the f32 (B, H) log-sum-exp of each head's
    scaled scores (-inf where no position is valid)."""
    if plain_route(q):
        return ref.decode_attention(q, k_cache, v_cache, kv_len, return_lse=return_lse)
    return flash_decode_cuda(q, k_cache, v_cache, kv_len, return_lse=return_lse)


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
    return_lse: bool = False,
):
    global decode_launches
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
    lse = torch.empty(B, H, device=q.device) if return_lse else None
    heads = head_group(H // Hkv)
    nsplit = num_splits(B, Hkv, H // Hkv, S, q.device)
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
            lse.data_ptr() if return_lse else None,
            part.data_ptr() if nsplit > 1 else None,
            nsplit,
            heads,
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
    decode_launches += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# flash attention (training and prefill)
# ---------------------------------------------------------------------------

BLOCK = 128  # the reference's bq = bk: S must divide by min(BLOCK, S)
ATTN_TILE_ROWS = 64  # q and k rows per tile (csrc/flash_attention.cu)
DKDV_BLOCKS_PER_SM = 2  # bf16 dK/dV blocks resident on an SM (shared memory)
DKDV_WAVES = 2  # the dK/dV grid aims at this many full waves


def dkdv_splits(batch: int, seq_len: int, n_kv: int, group: int, device: torch.device) -> int:
    """How many blocks share each (k tile, kv head, batch row) of the bf16
    backward's dK/dV grid, each taking an equal share of the ``group``
    query heads: the fewest that divide ``group`` and give DKDV_WAVES full
    waves of DKDV_BLOCKS_PER_SM blocks on every SM (all of them if none
    does).  1 when the grid already fills the card: dK, dV are then
    written directly, with no partial sums."""
    blocks = -(-seq_len // ATTN_TILE_ROWS) * n_kv * batch
    want = DKDV_WAVES * DKDV_BLOCKS_PER_SM * sm_count(device)
    for d in range(1, group + 1):
        if group % d == 0 and blocks * d >= want:
            return d
    return group


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) -> (B, S, H, D).

    Query head h attends to kv head ``h // (H // Hkv)`` with logits ``(q .
    k) * scale``, ``scale`` ``1/sqrt(D)`` unless given; ``causal`` masks
    keys after the query and ``window`` (with ``causal`` only) keys
    ``window`` or more before it.  On a CUDA tensor it launches the kernels
    in both directions; on a CPU tensor it is ``ref.attention``,
    differentiated by autograd."""
    if plain_route(q):
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    return FlashAttentionFn.apply(q, k, v, causal, window, scale)


def _scale(D: int, scale: Optional[float]) -> float:
    """The logits' scale the kernels take: ``1/sqrt(D)`` rounded once to
    f32 (as the kernels computed it before they took one) unless given."""
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA flash attention with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: Optional[float] = None):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window, scale=ctx.scale
        )
        return dq, dk, dv, None, None, None


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention {name}: expected a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"flash_attention {name}: dtype {t.dtype} not in {DTYPES}")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(
                f"flash_attention {name}: expected (B, S, heads, D) with D contiguous, "
                f"got {tuple(t.shape)} strides {t.stride()}"
            )
        if t.numel() == 0:
            raise ValueError(f"flash_attention {name}: empty input")
        # the bf16 kernels copy 16-byte chunks of every row (cp.async)
        vec = 16 // t.element_size()
        if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3])
        ):
            raise ValueError(
                f"flash_attention {name}: bf16 rows must start on 16-byte boundaries "
                f"(base and strides {t.stride()}); pass a contiguous copy"
            )
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(
                f"flash_attention {name}: {t.dtype} on {t.device}, q is {q.dtype} on {q.device}"
            )
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads over {k.shape[2]} kv heads")
    if S % min(BLOCK, S):
        raise ValueError(f"flash_attention: S = {S} must divide by {BLOCK}: pad the sequence")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0, scale: Optional[float] = None):
    """The forward kernel: ``(o, lse)``, o (B, S, H, D) in q's dtype and
    lse (B, H, S) f32, each row's log-sum-exp of its scaled, masked
    logits (``scale`` as :func:`flash_attention` takes it)."""
    global fwd_launches
    _check_qkv(q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    B, S, H, D = q.shape
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    fn = build.library("flash_attention").cox_flash_attention
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, k.shape[2], S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), _scale(D, scale), build.DTYPE_CODES[q.dtype], stream_of(q),
        )
    build.check(err, "cox_flash_attention")
    fwd_launches += 1
    return o, lse


def flash_attention_bwd_cuda(
    q, k, v, o, lse, do, *, causal: bool = True, window: int = 0, scale: Optional[float] = None
):
    """The backward kernels: ``(dq, dk, dv)`` in q's dtype from the
    forward's inputs (``scale`` the forward's), its output ``o`` and
    ``lse``, and the output's gradient ``do``.  Launched on the current stream of q's device, which
    the autograd engine sets for the backward."""
    global bwd_launches
    _check_qkv(q, k, v)
    B, S, H, D = q.shape
    do = do.contiguous()
    if do.data_ptr() % 16:  # the bf16 kernels copy 16-byte chunks of its rows
        do = do.clone()
    for name, t, shape, dtype in (
        ("o", o, q.shape, q.dtype),
        ("do", do, q.shape, q.dtype),
        ("lse", lse, (B, H, S), torch.float32),
    ):
        check_cuda_input(t, f"flash_attention_bwd {name}", (dtype,))
        if t.shape != shape or t.device != q.device:
            raise ValueError(f"flash_attention_bwd {name}: {tuple(t.shape)} on {t.device}")
    Hkv = k.shape[2]
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    nsplit = dkdv_splits(B, S, Hkv, H // Hkv, q.device) if q.dtype == torch.bfloat16 else 1
    # per split: f32 partial dK and dV, summed in order by a fourth kernel
    part = torch.empty(2 * nsplit * k.numel() if nsplit > 1 else 0, device=q.device)
    fn = build.library("flash_attention").cox_flash_attention_bwd
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            part.data_ptr() if nsplit > 1 else None, nsplit,
            B, H, Hkv, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), _scale(D, scale), build.DTYPE_CODES[q.dtype], stream_of(q),
        )
    build.check(err, "cox_flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
