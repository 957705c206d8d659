"""The plain reference: the layers of the training forward in plain
PyTorch, in float32, written down from the equations the program
implements (a frozen copy, independent of its code).  Each family's
module (``portbench/families/<family>.py``) runs its layer stack from
these; :func:`loss` finds it by the configuration's ``family``.

- Embedding rows, then the family's layer stack, the final norm, the tied
  unembedding and the mean cross-entropy over the labels in ``[0,
  vocab)`` (padded vocabulary columns masked): :func:`lm_loss`.
- Norms over the last axis with eps 1e-6: rmsnorm, or layernorm with a
  bias (two passes: the mean, then the mean of the centred squares).
- Attention: rotary embeddings (halves rotated, base 10,000) on q and k,
  query head h reading kv head ``h // (H / Hkv)``, scale ``1/sqrt(Dh)``,
  causal, with a window where the configuration has one.
- The MLP: ``gelu_tanh(x W_in) W_out`` (or SwiGLU).
- The Mamba2 block: ``x W_in`` split into ``z | x B C | dt``, a depthwise
  causal convolution and SiLU on ``x B C``, ``dt = softplus(dt +
  dt_bias)``, ``a = -exp(A_log) dt``, the SSD recurrence ``h_t = e^{a_t}
  h_{t-1} + B_t (dt x)_t^T``, ``y_t = C_t^T h_t + D (dt x)_t``, gated by
  ``silu(z)``, an rmsnorm, then ``W_out``.

``precision="fp8"`` is the control: every operand of a matrix product
that the program holds in bfloat16 (the projections, the MLP, the
unembedding, attention's q, k and v) is rounded to float8 e4m3 with a
per-tensor scale on the way in (gradients pass straight through).

Each layer and each query chunk of attention runs under
``torch.utils.checkpoint``, so that a full-size step fits beside the
float32 optimizer state; that changes where values are kept, not what is
computed.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import catalog
from .layout import sizes

NEG_INF = -1e30
E4M3_MAX = 448.0
ATTN_CHUNK = 512


class _FakeFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Numerics:
    """Where the reference rounds: nowhere (``"f32"``), or the product
    operands to float8 (``"fp8"``, the control)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return _FakeFP8.apply(x) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.op(x) @ self.op(w)


def rmsnorm(x, w, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layernorm(x, w, b, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def norm(cfg, p, name: str, x):
    if cfg["norm"] == "rms":
        return rmsnorm(x, p[name])
    return layernorm(x, p[name], p[name + "_b"])


def rope(x, S: int):
    """x: (B, S, H, D); positions 0 .. S-1; angles in float32."""
    D = x.shape[-1]
    half = D // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(10000.0) * idx / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, q0: int, k0: int, window: int):
    """Queries ``q0 ..`` of q (B, c, Hkv, g, D) over keys ``k0 ..`` of k,
    v (B, s, Hkv, D), causal (and windowed)."""
    D = q.shape[-1]
    logits = torch.einsum("bqkgd,bskd->bkgqs", q * (1.0 / math.sqrt(D)), k)
    qi = q0 + torch.arange(q.shape[1], device=q.device)[:, None]
    kj = k0 + torch.arange(k.shape[1], device=q.device)[None, :]
    keep = qi >= kj
    if window:
        keep = keep & (qi - kj < window)
    p = torch.softmax(torch.where(keep, logits, NEG_INF), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


def attention(q, k, v, window: int = 0, chunk: int = ATTN_CHUNK):
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) -> (B, S, H, D), causal.
    Query chunks read only the keys their mask lets through."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    outs = []
    for q0 in range(0, S, chunk):
        q1 = min(S, q0 + chunk)
        k0 = max(0, q0 - window + 1) if window else 0
        args = (qg[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend, *args, use_reentrant=False))
        else:
            outs.append(_attend(*args))
    return torch.cat(outs, dim=1).reshape(B, S, H, D)


def attention_block(cfg, num: Numerics, p, x):
    B, S, d = x.shape
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv"], cfg["d_head"]
    q = num.mm(x, p["wq"].reshape(d, H * Dh)).reshape(B, S, H, Dh)
    k = num.mm(x, p["wk"].reshape(d, Hkv * Dh)).reshape(B, S, Hkv, Dh)
    v = num.mm(x, p["wv"].reshape(d, Hkv * Dh)).reshape(B, S, Hkv, Dh)
    q, k, v = num.op(rope(q, S)), num.op(rope(k, S)), num.op(v)
    att = attention(q, k, v, window=cfg["window"])
    return num.mm(att.reshape(B, S, H * Dh), p["wo"].reshape(H * Dh, d))


def mlp(cfg, num: Numerics, p, x):
    if cfg["act"] == "swiglu":
        return num.mm(F.silu(num.mm(x, p["w_gate"])) * num.mm(x, p["w_up"]), p["w_down"])
    return num.mm(F.gelu(num.mm(x, p["w_in"]), approximate="tanh"), p["w_out"])


def dense_layer(cfg, num: Numerics, p, x):
    x = x + attention_block(cfg, num, p["attn"], norm(cfg, p, "ln1", x))
    return x + mlp(cfg, num, p["mlp"], norm(cfg, p, "ln2", x))


def ssd(x, a, b, c, chunk: int):
    """The SSD recurrence in its chunked dual form (exact for any chunk).
    x: (B, S, H, P); a: (B, S, H), the log-decay; b, c: (B, S, N)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = min(chunk, S)
    n = S // T
    xc, ac = x.reshape(B, n, T, H, P), a.reshape(B, n, T, H)
    bc, cc = b.reshape(B, n, T, N), c.reshape(B, n, T, N)
    A = torch.cumsum(ac, dim=2)  # (B, n, T, H)
    At = A.transpose(2, 3)  # (B, n, H, T)
    lower = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(lower, At[..., :, None] - At[..., None, :], -math.inf))
    scores = torch.einsum("bgin,bgjn->bgij", cc, bc)[:, :, None] * decay  # (B, n, H, T, T)
    y = torch.einsum("bghij,bgjhp->bgihp", scores, xc)
    A_end = A[:, :, -1]  # (B, n, H)
    w = bc[:, :, :, None, :] * torch.exp(A_end[:, :, None] - A)[..., None]  # (B, n, T, H, N)
    add = torch.einsum("bgjhn,bgjhp->bghnp", w, xc)  # (B, n, H, N, P)
    h = x.new_zeros(B, H, N, P)
    h_in = []
    for g in range(n):
        h_in.append(h)
        h = torch.exp(A_end[:, g])[..., None, None] * h + add[:, g]
    h_in = torch.stack(h_in, dim=1)
    y = y + torch.einsum("bgin,bghnp->bgihp", cc, h_in) * torch.exp(A)[..., None]
    return y.reshape(B, S, H, P)


def mamba2(cfg, num: Numerics, p, x):
    B, S, _ = x.shape
    di, N, H, P, K = cfg["ssm_inner"], cfg["ssm_state"], cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["conv_k"]
    proj = num.mm(x, p["w_in"])
    z, xBC, dtp = proj[..., :di], proj[..., di : 2 * di + 2 * N], proj[..., 2 * di + 2 * N :]
    xp = torch.cat([xBC.new_zeros(B, K - 1, xBC.shape[-1]), xBC], dim=1)
    xBC = F.silu(sum(xp[:, i : i + S] * p["conv"][i] for i in range(K)))
    xs, Bm, Cm = xBC[..., :di], xBC[..., di : di + N], xBC[..., di + N :]
    dt = torch.logaddexp(dtp + p["dt_bias"], dtp.new_zeros(()))
    a = -torch.exp(p["A_log"]) * dt
    xh = xs.unflatten(-1, (H, P)) * dt[..., None]
    y = ssd(xh, a, Bm, Cm, cfg["ssd_chunk"]) + xh * p["D"][:, None]
    y = y.reshape(B, S, di) * F.silu(z)
    return num.mm(rmsnorm(y, p["norm"]), p["w_out"])


def ssm_layer(cfg, num: Numerics, p, x):
    return x + mamba2(cfg, num, p["mamba"], norm(cfg, p, "ln1", x))


def layer_params(stacked, i: int):
    """Layer ``i`` of each leaf of a stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def run(fn, cfg, num, p, x):
    """``fn(cfg, num, p, x)``, one layer, under checkpoint when gradients
    are taken."""
    if torch.is_grad_enabled():
        return checkpoint(fn, cfg, num, p, x, use_reentrant=False)
    return fn(cfg, num, p, x)


def lm_loss(cfg: dict, params, tokens, labels, precision: str, stack):
    """The mean cross-entropy of one batch (tokens, labels (B, S) int) of
    a decoder-only model whose layers ``stack(cfg, num, params, x)`` runs
    on the embedded tokens."""
    cfg = sizes(cfg)
    num = Numerics(precision)
    x = stack(cfg, num, params, params["embed"]["tok"][tokens])
    h = norm(cfg, params, "final_norm", x)
    logits = num.mm(h, params["embed"]["tok"].t())
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < cfg["vocab"], logits, NEG_INF)
    valid = (labels >= 0) & (labels < cfg["vocab"])
    idx = torch.where(valid, labels, 0).long()
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, idx[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def loss(cfg: dict, params, tokens, labels, precision: str = "f32"):
    """The mean cross-entropy of one batch, as ``cfg``'s family computes it."""
    return catalog.family(cfg["family"]).loss(cfg, params, tokens, labels, precision)
