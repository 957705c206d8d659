"""Plain PyTorch versions of the ported kernels: the ground truth the
CUDA kernels are held against, and the path a CPU tensor takes.

They follow the TPU kernels' semantics (``src/repro/kernels``): f32
accumulation, and ``row_reduce(..., "sum")`` returns f32.  (The JAX
package's own ``ref.row_reduce`` sums in the input dtype, so for bf16 its
plain path and its Pallas kernel differ; the port follows the kernel.
Likewise ``decode_attention`` with ``kv_len = 0`` returns zeros, as the
Pallas kernel does, where the JAX package's plain version returns the mean
of V.)  The gradients ``rmsnorm_bwd``, ``layernorm_bwd``,
``attention_bwd`` and ``ssd_scan_bwd`` are autograd through the plain
versions: the yardsticks of the backward kernels.  ``topk_gate``, the MoE
router's top-k, has no kernel in either package: this plain version is
its only route.
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


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, the reference's compute type; f64 for an f64 input, so that a
    model run in f64 is f64 throughout (the exact anchor that f32 runs are
    measured from)."""
    return torch.promote_types(t.dtype, torch.float32)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in f32,
    returned in ``x.dtype``; ``w`` may have a dtype of its own."""
    x32 = x.to(compute_dtype(x))
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(x32.dtype)).to(x.dtype)


def layernorm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * w + b`` over the last axis, in f32,
    returned in ``x.dtype``.  Two passes, as the reference: the mean, then
    the mean of the centred squares.  ``w`` and ``b`` may have a dtype of
    their own."""
    x32 = x.to(compute_dtype(x))
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * w.to(x32.dtype) + b.to(x32.dtype)
    return y.to(x.dtype)


ATTN_Q_CHUNK = 1024  # queries per chunk: bounds the logits' working set


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = ATTN_Q_CHUNK,
    scale=None,
) -> torch.Tensor:
    """q: (S, H, D) or (B, S, H, D); k/v: (S, Hkv, D) or (B, S, Hkv, D).

    GQA by head-group broadcast: query head h reads kv head ``h // (H //
    Hkv)``.  Logits ``(q * scale) . k``, ``scale`` ``1/sqrt(D)`` unless
    given, in f32 (f64 for f64 inputs:
    :func:`compute_dtype`); with ``causal``, keys after the query (and,
    with ``window``, keys ``window`` or more before it) are set to -1e30;
    the window applies only with ``causal``.  The queries are processed in
    chunks of ``q_chunk`` (S must then divide by it), so the logits'
    working set is (H, q_chunk, S), as the reference's ``lax.map`` over
    chunks; unlike the reference, autograd keeps every chunk's
    probabilities for the backward (no per-chunk remat).  Returned in
    ``q.dtype``."""
    S, H, D = q.shape[-3:]
    g = H // k.shape[-2]
    scale = 1.0 / (D**0.5) if scale is None else scale
    k32 = k.to(compute_dtype(q)).repeat_interleave(g, dim=-2)
    v32 = v.to(k32.dtype).repeat_interleave(g, dim=-2)

    def chunk(qc: torch.Tensor, q0: int) -> torch.Tensor:
        q32 = qc.to(k32.dtype) * scale
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


def layernorm_bwd(x, w, b, dy, eps: float = 1e-6):
    """``(dx, dw, db)`` of :func:`layernorm` for the output gradient ``dy``:
    autograd through the plain version, the yardstick of the backward
    kernel."""
    return _grads(lambda a, c, d: layernorm(a, c, d, eps), (x, w, b), dy)


def attention_bwd(q, k, v, do, *, causal: bool = True, window: int = 0, scale=None):
    """``(dq, dk, dv)`` of :func:`attention` for the output gradient
    ``do``: autograd through the plain version, the yardstick of the
    backward kernels."""
    return _grads(lambda a, b, c: attention(a, b, c, causal=causal, window=window, scale=scale), (q, k, v), do)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    return_lse: bool = False,
):
    """One query token per head against a KV cache, batched.

    q: (B, H, D); caches: (B, S, Hkv, D); kv_len: (B,) int.  Query head h
    reads kv head ``h // (H // Hkv)``.  Positions ``>= kv_len`` are masked
    (``kv_len > S`` means all of them are valid) and a row with no valid
    position returns zeros.  The scale is ``1/sqrt(D)``; f32 inside,
    ``q.dtype`` out.  With ``return_lse`` it returns ``(out, lse)``: lse
    (B, H) f32, each head's ``max + log(sum)`` of its scaled scores, -inf
    for a row with no valid position (the kernel's optional output)."""
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
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    empty = p.sum(dim=-1) == 0.0
    lse = torch.where(empty, -math.inf, m[..., 0] + torch.log(lsum[..., 0]))
    return out, lse.reshape(B, H).to(torch.float32)


def _batched(x, a, b, c):
    """The SSD inputs with a batch axis: (S, ...) becomes (1, S, ...)."""
    if x.dim() == 3:
        return True, (x[None], a[None], b[None], c[None])
    return False, (x, a, b, c)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mamba2 SSD, the sequential oracle: ``h_t = exp(a_t) h_{t-1} + b_t
    x_t^T`` and ``y_t = c_t^T h_t`` per head, from ``h = 0``, in f32.

    x: (B, S, H, P) or (S, H, P); a: (B, S, H) log-decay (<= 0); b, c:
    (B, S, N), shared across heads.  Returns y like x, in x's dtype."""
    squeeze, (x, a, b, c) = _batched(x, a, b, c)
    B, S, H, P = x.shape
    x32, a32, b32, c32 = (t.to(torch.float32) for t in (x, a, b, c))
    h = torch.zeros(B, H, b.shape[-1], P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(a32[:, t])[..., None, None] * h + torch.einsum(
            "bn,bhp->bhnp", b32[:, t], x32[:, t]
        )
        ys.append(torch.einsum("bn,bhnp->bhp", c32[:, t], h))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y[0] if squeeze else y


def ssd_scan_chunked(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int = 128
) -> torch.Tensor:
    """Mamba2 SSD in its dual (chunked matmul) form, the math of the TPU
    kernel in plain PyTorch: within a chunk ``y = ((C B^T) * L) X + exp(A)
    * (C h)`` with ``L[i, j] = exp(A_i - A_j)`` for ``i >= j`` (the exponent
    masked before ``exp``, so autograd meets no ``0 * inf``), across chunks
    ``h <- exp(A_T) h + (B * exp(A_T - A))^T X``; A is the within-chunk
    cumulative sum of a.  Shapes as :func:`ssd_scan`; ``chunk = min(chunk,
    S)`` must divide S.  The CPU route of ``ops.ssd_scan`` and the
    yardstick of its kernels."""
    squeeze, (x, a, b, c) = _batched(x, a, b, c)
    B, S, H, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd_scan: S = {S} must divide by chunk = {chunk}: pad the sequence")
    nc = S // chunk
    xc = x.to(torch.float32).reshape(B, nc, chunk, H, P)
    ac = a.to(torch.float32).reshape(B, nc, chunk, H)
    bc = b.to(torch.float32).reshape(B, nc, chunk, N)
    cc = c.to(torch.float32).reshape(B, nc, chunk, N)
    A = torch.cumsum(ac, dim=2)  # (B, nc, C, H)
    A_tot = A[:, :, -1]  # (B, nc, H)
    At = A.transpose(2, 3)  # (B, nc, H, C)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = At[..., :, None] - At[..., None, :]
    L = torch.exp(torch.where(causal, diff, -math.inf))  # (B, nc, H, C, C)
    cb = torch.einsum("bgin,bgjn->bgij", cc, bc)
    y_intra = torch.einsum("bghij,bgjhp->bgihp", L * cb[:, :, None], xc)
    w = bc[:, :, :, None, :] * torch.exp(A_tot[:, :, None] - A)[..., None]  # (B, nc, C, H, N)
    h_add = torch.einsum("bgjhn,bgjhp->bghnp", w, xc)  # (B, nc, H, N, P)
    h = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    h_in = []
    for g in range(nc):
        h_in.append(h)
        h = torch.exp(A_tot[:, g])[..., None, None] * h + h_add[:, g]
    h_in = torch.stack(h_in, dim=1)  # the state entering each chunk
    y_inter = torch.einsum("bgin,bghnp->bgihp", cc, h_in) * torch.exp(A)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P).to(x.dtype)
    return y[0] if squeeze else y


def ssd_scan_bwd(x, a, b, c, dy, chunk: int = 128):
    """``(dx, da, db, dc)`` of :func:`ssd_scan_chunked` for the output
    gradient ``dy``: autograd through the plain version, the yardstick of
    the backward kernel."""
    return _grads(lambda *t: ssd_scan_chunked(*t, chunk=chunk), (x, a, b, c), dy)


def topk_gate(logits: torch.Tensor, k: int):
    """MoE router: the top ``k`` of each row, a softmax over the selected
    values.  logits: (T, E) -> ``(weights (T, k), indices (T, k))``, in f32
    (f64 for an f64 input).

    ``lax.top_k`` puts the lower index first among equal values, and
    ``torch.topk`` promises no order on ties, so the top k come from a
    stable descending sort: equal values keep their index order."""
    vals, idx = torch.sort(logits.to(compute_dtype(logits)), dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return torch.softmax(vals, dim=-1), idx
