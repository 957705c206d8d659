"""Operations and bytes, counted from shapes (frozen copies of
``chip_smoke.py``'s ``train_model_flops``, ``ssd_ops``, ``ssd_tc_bound``
and ``visible_pairs``, and of ``ModelConfig.param_count``).

A configuration is a dict with the program's field names (``family``,
``n_layers``, ``d_model``, ``n_heads``, ``n_kv``, ``d_head``, ``d_ff``,
``vocab``, ``act``, ``tie_embeddings``, ``qkv_bias`` and, where the model
has them, ``ssm_*``, ``conv_k``, ``attn_every``, ``window``).  The blocks'
parameters and the attention and SSD operations are counted here; how a
family puts them together is its module's (``portbench/families/``),
which :func:`param_count` and :func:`train_model_flops` find by the
configuration's ``family``."""

from __future__ import annotations

from .. import catalog
from .peaks import BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S

SSD_CHUNK = 128  # the reference's chunk, the longest tile the least-work count tries


def full(cfg: dict) -> dict:
    """``cfg`` with its derived sizes and defaults filled in: the head
    width where there are heads, the SSM inner width and heads where
    there is an SSM state."""
    c = {
        "d_head": 0, "qkv_bias": False, "act": "swiglu", "tie_embeddings": True, "ssm_state": 0,
        "ssm_heads": 0, "ssm_head_dim": 64, "ssm_inner": 0, "conv_k": 4, "attn_every": 0, "window": 0,
    }
    c.update(cfg)
    if not c["d_head"] and c["n_heads"]:
        c["d_head"] = c["d_model"] // c["n_heads"]
    if c["ssm_state"]:
        c["ssm_inner"] = c["ssm_inner"] or 2 * c["d_model"]
        c["ssm_heads"] = c["ssm_heads"] or c["ssm_inner"] // c["ssm_head_dim"]
    return c


def attention_params(c: dict) -> int:
    """One attention block's projections (and their biases)."""
    d, H, Hkv, Dh = c["d_model"], c["n_heads"], c["n_kv"], c["d_head"]
    return d * (H + 2 * Hkv) * Dh + H * Dh * d + (H * Dh + 2 * Hkv * Dh if c["qkv_bias"] else 0)


def mlp_params(c: dict) -> int:
    return (3 if c["act"] == "swiglu" else 2) * c["d_model"] * c["d_ff"]


def mamba_params(c: dict) -> int:
    """One Mamba2 block: in and out projections, convolution, A_log, D,
    dt_bias and its norm."""
    d, di, N, Hs = c["d_model"], c["ssm_inner"], c["ssm_state"], c["ssm_heads"]
    return d * (2 * di + 2 * N + Hs) + di * d + c["conv_k"] * (di + 2 * N) + 3 * Hs + di


def unembed_params(c: dict) -> int:
    """The embedding, and the unembedding where it is not tied."""
    return c["vocab"] * c["d_model"] * (1 if c["tie_embeddings"] else 2)


def param_count(cfg: dict) -> int:
    """Total parameters, as the program's configuration counts them."""
    return catalog.family(cfg["family"]).param_count(cfg)


def train_model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model flops of one training step, as ``cfg``'s family counts them:
    6 per token for each weight a token meets, plus each attention's
    forward (two products) and backward (five) over the causal pairs
    (:func:`attention_flops`), and each SSD scan's forward and backward
    (:func:`ssd_ops`).  The recompute of rematerialisation is not
    counted."""
    return catalog.family(cfg["family"]).model_flops(cfg, batch, seq)


def attention_flops(c: dict, batch: int, seq: int, applications: int) -> int:
    """Forward and backward products of ``applications`` causal attention
    calls of sized ``c`` over its visible pairs."""
    pairs = visible_pairs(seq, True, c["window"])
    return 14 * c["d_head"] * pairs * batch * c["n_heads"] * applications


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask lets through, per sequence and head."""
    if not causal:
        return S * S
    if not window:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _ssd_tiles(S: int) -> list:
    return [T for T in (1 << k for k in range(8)) if T <= min(SSD_CHUNK, S) and S % T == 0]


def _ssd_parts(H: int, P: int, N: int, T: int) -> tuple:
    """Per head and token at tile length T: (forward products, forward
    rest, backward products, backward rest); see ``chip_smoke.py``."""
    shared = 2 * T * N / H
    return (
        2 * T * P + 4 * N * P + shared,
        N * P / T,
        4 * T * P + 4 * T * N + 8 * N * P + shared,
        3 * N * P / T,
    )


def ssd_ops(B: int, S: int, H: int, P: int, N: int) -> tuple:
    """(forward, backward) operations the SSD scan needs at least: the dual
    form at the tile length that needs fewest."""
    parts = [_ssd_parts(H, P, N, T) for T in _ssd_tiles(S)]
    fwd = min(p[0] + p[1] for p in parts)
    bwd = min(p[2] + p[3] for p in parts)
    return B * S * H * fwd, B * S * H * bwd


def ssd_bytes(B: int, S: int, H: int, P: int, N: int) -> tuple:
    """(forward, backward) bytes of an f32 SSD call: x, a, b, c read and y
    written; x, a, b, c, dy read and dx, da, db, dc written (the tile
    states a backward may keep are left out: it could recompute them)."""
    xb, ab, bb = B * S * H * P * 4, B * S * H * 4, B * S * N * 4
    return 2 * xb + ab + 2 * bb, 3 * xb + 2 * ab + 4 * bb


def ssd_bound_s(B: int, S: int, H: int, P: int, N: int) -> tuple:
    """(forward, backward) least seconds of an f32-accurate SSD call: its
    products on the tensor cores as 3xTF32, the rest at the f32 rate, or
    its bytes at the HBM rate, whichever is longer; the tile length the
    one that gives the least time."""
    parts = [_ssd_parts(H, P, N, T) for T in _ssd_tiles(S)]
    n = B * S * H
    fwd = n * min(3 * p[0] / TF32_OPS_PER_S + p[1] / F32_OPS_PER_S for p in parts)
    bwd = n * min(3 * p[2] / TF32_OPS_PER_S + p[3] / F32_OPS_PER_S for p in parts)
    fb, bb = ssd_bytes(B, S, H, P, N)
    return max(fwd, fb / HBM_BYTES_PER_S), max(bwd, bb / HBM_BYTES_PER_S)


def attention_ops(B: int, S: int, H: int, D: int, causal: bool = True, window: int = 0) -> tuple:
    """(forward, backward) operations of one attention call over the
    visible pairs: two products forward, five backward."""
    pairs = visible_pairs(S, causal, window) * B * H
    return 4 * D * pairs, 10 * D * pairs


def attention_bytes(B: int, S: int, H: int, Hkv: int, D: int, itemsize: int = 2) -> tuple:
    """(forward, backward) bytes of one call: q, k, v read and o written;
    q, k, v, o, do and the f32 log-sum-exp read, dq, dk, dv written."""
    q, kv, lse = B * S * H * D * itemsize, B * S * Hkv * D * itemsize, B * H * S * 4
    return 2 * q + 2 * kv, 4 * q + 4 * kv + lse


def attention_bound_s(B, S, H, Hkv, D, causal=True, window=0, itemsize=2) -> tuple:
    """(forward, backward) least seconds of one bf16 attention call."""
    ops = attention_ops(B, S, H, D, causal, window)
    nbytes = attention_bytes(B, S, H, Hkv, D, itemsize)
    return tuple(max(o / BF16_OPS_PER_S, b / HBM_BYTES_PER_S) for o, b in zip(ops, nbytes))
