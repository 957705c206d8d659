"""Plain PyTorch versions of the ported kernels: the ground truth the
CUDA kernels are held against, and the path a CPU tensor takes.

They follow the TPU kernels' semantics (``src/repro/kernels``): f32
accumulation, and ``row_reduce(..., "sum")`` returns f32.  (The JAX
package's own ``ref.row_reduce`` sums in the input dtype, so for bf16 its
plain path and its Pallas kernel differ; the port follows the kernel.
Likewise ``decode_attention`` with ``kv_len = 0`` returns zeros, as the
Pallas kernel does, where the JAX package's plain version returns the mean
of V.)  The gradients ``rmsnorm_bwd`` and ``attention_bwd`` are autograd
through the plain versions: the yardsticks of the backward kernels.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the TPU kernels' mask value (src/repro/kernels/common.py)


def row_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(rows, cols) -> (rows,): f32 for ``sum``, x.dtype for ``max`` and
    ``absmax``."""
    x32 = x.to(torch.float32)
    if op == "sum":
        return x32.sum(dim=-1)
    if op == "max":
        return x32.amax(dim=-1).to(x.dtype)
    if op == "absmax":
        return x32.abs().amax(dim=-1).to(x.dtype)
    raise ValueError(op)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax over the last axis, in f32."""
    x32 = x.to(torch.float32)
    m = x32.amax(dim=-1, keepdim=True)
    e = torch.exp(x32 - m)
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in f32,
    returned in ``x.dtype``; ``w`` may have a dtype of its own."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


ATTN_Q_CHUNK = 1024  # queries per chunk: bounds the logits' working set


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = ATTN_Q_CHUNK,
) -> torch.Tensor:
    """q: (S, H, D) or (B, S, H, D); k/v: (S, Hkv, D) or (B, S, Hkv, D).

    GQA by head-group broadcast: query head h reads kv head ``h // (H //
    Hkv)``.  Logits ``(q * 1/sqrt(D)) . k`` in f32; with ``causal``, keys
    after the query (and, with ``window``, keys ``window`` or more before
    it) are set to -1e30; the window applies only with ``causal``.  The
    queries are processed in chunks of ``q_chunk`` (S must then divide by
    it), so the logits' working set is (H, q_chunk, S), as the reference's
    ``lax.map`` over chunks; unlike the reference, autograd keeps every
    chunk's probabilities for the backward (no per-chunk remat).  Returned
    in ``q.dtype``."""
    S, H, D = q.shape[-3:]
    g = H // k.shape[-2]
    scale = 1.0 / (D**0.5)
    k32 = k.to(torch.float32).repeat_interleave(g, dim=-2)
    v32 = v.to(torch.float32).repeat_interleave(g, dim=-2)

    def chunk(qc: torch.Tensor, q0: int) -> torch.Tensor:
        q32 = qc.to(torch.float32) * scale
        logits = torch.einsum("...qhd,...khd->...hqk", q32, k32)
        if causal:
            qi = q0 + torch.arange(qc.shape[-3], device=q.device)[:, None]
            kj = torch.arange(S, device=q.device)[None, :]
            msk = qi >= kj
            if window:
                msk = msk & (qi - kj < window)
            logits = torch.where(msk, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("...hqk,...khd->...qhd", p, v32)

    if S <= q_chunk:
        return chunk(q, 0).to(q.dtype)
    if S % q_chunk:
        raise ValueError(f"attention: S = {S} must divide by q_chunk = {q_chunk}")
    outs = [chunk(q[..., i : i + q_chunk, :, :], i) for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=-3).to(q.dtype)


def _grads(fn, inputs, dout):
    """Autograd's gradients of ``fn(*inputs)`` for the output gradient
    ``dout``, each in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, dout)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """``(dx, dw)`` of :func:`rmsnorm` for the output gradient ``dy``:
    autograd through the plain version, the yardstick of the backward
    kernel."""
    return _grads(lambda a, b: rmsnorm(a, b, eps), (x, w), dy)


def attention_bwd(q, k, v, do, *, causal: bool = True, window: int = 0):
    """``(dq, dk, dv)`` of :func:`attention` for the output gradient
    ``do``: autograd through the plain version, the yardstick of the
    backward kernels."""
    return _grads(lambda a, b, c: attention(a, b, c, causal=causal, window=window), (q, k, v), do)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
) -> torch.Tensor:
    """One query token per head against a KV cache, batched.

    q: (B, H, D); caches: (B, S, Hkv, D); kv_len: (B,) int.  Query head h
    reads kv head ``h // (H // Hkv)``.  Positions ``>= kv_len`` are masked
    (``kv_len > S`` means all of them are valid) and a row with no valid
    position returns zeros.  The scale is ``1/sqrt(D)``; f32 inside,
    ``q.dtype`` out."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    q32 = q.to(torch.float32).reshape(B, Hkv, g, D) * (1.0 / math.sqrt(D))
    k32 = k_cache.to(torch.float32)
    v32 = v_cache.to(torch.float32)
    logits = torch.einsum("bkgd,bskd->bkgs", q32, k32)
    pos = torch.arange(S, device=q.device)
    valid = (pos[None, :] < kv_len.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    lsum = p.sum(dim=-1, keepdim=True)
    lsum = torch.where(lsum == 0.0, 1.0, lsum)
    out = torch.einsum("bkgs,bskd->bkgd", p, v32) / lsum
    return out.reshape(B, H, D).to(q.dtype)
