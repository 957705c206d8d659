"""Operations and bytes, counted from shapes (frozen copies of
``chip_smoke.py``'s ``train_model_flops``, ``ssd_ops``, ``ssd_tc_bound``
and ``visible_pairs``, and of ``ModelConfig.param_count``).

A configuration is a dict with the program's field names (``family``,
``n_layers``, ``d_model``, ``n_heads``, ``n_kv``, ``d_head``, ``d_ff``,
``vocab``, ``act``, ``tie_embeddings``, ``qkv_bias`` and, by family,
``ssm_*``, ``conv_k``, ``attn_every``, ``window``, ``n_experts``,
``top_k``, ``n_shared``, ``d_expert``, ``enc_layers``,
``n_frontend_tokens``)."""

from __future__ import annotations

from .peaks import BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S

SSD_CHUNK = 128  # the reference's chunk, the longest tile the least-work count tries


def full(cfg: dict) -> dict:
    """``cfg`` with its derived sizes and defaults filled in."""
    c = {
        "d_head": 0, "qkv_bias": False, "act": "swiglu", "tie_embeddings": True,
        "n_experts": 0, "top_k": 0, "n_shared": 0, "d_expert": 0, "ssm_state": 0,
        "ssm_heads": 0, "ssm_head_dim": 64, "ssm_inner": 0, "conv_k": 4, "attn_every": 0,
        "enc_layers": 0, "n_frontend_tokens": 0, "window": 0,
    }
    c.update(cfg)
    if not c["d_head"] and c["n_heads"]:
        c["d_head"] = c["d_model"] // c["n_heads"]
    if c["family"] in ("ssm", "hybrid"):
        c["ssm_inner"] = c["ssm_inner"] or 2 * c["d_model"]
        c["ssm_heads"] = c["ssm_heads"] or c["ssm_inner"] // c["ssm_head_dim"]
    return c


def _mamba_params(c: dict) -> int:
    d, di, N, Hs = c["d_model"], c["ssm_inner"], c["ssm_state"], c["ssm_heads"]
    return d * (2 * di + 2 * N + Hs) + di * d + c["conv_k"] * (di + 2 * N) + 3 * Hs + di


def param_count(cfg: dict) -> int:
    """Total parameters, as the program's configuration counts them."""
    c = full(cfg)
    d, f, V = c["d_model"], c["d_ff"], c["vocab"]
    H, Hkv, Dh = c["n_heads"], c["n_kv"], c["d_head"]
    attn = d * (H + 2 * Hkv) * Dh + H * Dh * d + (H * Dh + 2 * Hkv * Dh if c["qkv_bias"] else 0)
    mlp = 3 * d * f if c["act"] == "swiglu" else 2 * d * f
    fam = c["family"]
    if fam == "moe":
        fe = c["d_expert"] or f
        moe = c["n_experts"] * 3 * d * fe + d * c["n_experts"]
        if c["n_shared"]:
            moe += 3 * d * fe * c["n_shared"]
        body = c["n_layers"] * (attn + moe + 2 * d)
    elif fam == "ssm":
        body = c["n_layers"] * (_mamba_params(c) + d)
    elif fam == "hybrid":
        body = c["n_layers"] * (_mamba_params(c) + d) + attn + mlp + 2 * d
    elif fam == "encdec":
        body = c["enc_layers"] * (attn + mlp + 2 * d) + c["n_layers"] * (2 * attn + mlp + 3 * d)
    else:  # dense, vlm
        body = c["n_layers"] * (attn + mlp + 2 * d)
    return body + V * d * (1 if c["tie_embeddings"] else 2) + d


def applications(cfg: dict) -> int:
    """The hybrid family's applications of its shared block: one after
    each group of ``attn_every`` Mamba2 layers (0 for other families)."""
    c = full(cfg)
    if c["family"] != "hybrid":
        return 0
    ae = c["attn_every"] or c["n_layers"]
    return len(range(0, c["n_layers"], ae))


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


def train_model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model flops of one training step: 6 per token for each weight a
    token meets, plus each attention's forward (two products) and backward
    (five) over the causal pairs, and each SSD scan's forward and backward
    (``ssd_ops``).  A token meets the body's weights at every position,
    the frontend rows too, and the (tied) unembedding at the text
    positions; a MoE layer's router, its shared experts and top_k routed
    experts; the hybrid's shared block at each of its applications; an
    encoder-decoder model's encoder at every frame (as many as the tokens)
    and its decoder at every token.  The recompute of rematerialisation
    is not counted."""
    c = full(cfg)
    B, S = batch, seq
    S_text = S - c["n_frontend_tokens"]
    unembed = c["vocab"] * c["d_model"] * (1 if c["tie_embeddings"] else 2)
    body = param_count(c) - unembed
    if c["family"] == "moe":
        body -= c["n_layers"] * (c["n_experts"] - c["top_k"]) * 3 * c["d_model"] * (c["d_expert"] or c["d_ff"])
    attn_apps = c["n_layers"]
    if c["family"] in ("ssm", "hybrid"):
        attn_apps = applications(c)
        mamba = param_count(c) - unembed - c["d_model"]  # one final norm
        if attn_apps:
            h, kv, dh, d = c["n_heads"], c["n_kv"], c["d_head"], c["d_model"]
            shared = d * (h + 2 * kv) * dh + h * dh * d + 2 * d * c["d_ff"] + 2 * d
            mamba -= shared
            body = mamba + attn_apps * shared + c["d_model"]
    flops = 6 * (body * B * S + unembed * B * S_text)
    if c["family"] in ("ssm", "hybrid"):
        fwd, bwd = ssd_ops(B, S, c["ssm_heads"], c["ssm_head_dim"], c["ssm_state"])
        flops += c["n_layers"] * (fwd + bwd)
    if c["family"] == "encdec":
        pairs = c["enc_layers"] * S * S + c["n_layers"] * (visible_pairs(S, True, 0) + S * S)
        return flops + 14 * c["d_head"] * pairs * B * c["n_heads"]
    pairs = visible_pairs(S, True, c["window"])
    return flops + 14 * c["d_head"] * pairs * B * c["n_heads"] * attn_apps
