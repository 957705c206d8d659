"""The hybrid_moe family (granite-4.0-h): layers by ``layer_types``, each a
Mamba2 mixer (``reference/mamba2_x_skip.py``) or a NoPE attention mixer
(``reference/nope_attention.py``), then an MoE block of this card's share
of the experts with the shared expert (``reference/held_moe.py``).  The
Mamba2 layers are stacked under ``mamba_layers`` and the attention layers
under ``attn_layers``; a layer is ``x + r * mixer(norm(x))``, then ``x + r
* moe(norm(x))``.  The embedding is multiplied by ``embedding_multiplier``
and the logits divided by ``logits_scaling``; the tied head and the
cross-entropy run in blocks of :data:`HEAD_ROWS` rows under checkpoint, so
that a full-size step's logits are never whole."""

import torch
from torch.utils.checkpoint import checkpoint

from portbench.arith import flops
from portbench.reference import held_moe, mamba2_x_skip, nope_attention
from portbench.reference import layout as L
from portbench.reference import model as M

STACKS = {"mamba": "mamba_layers", "attention": "attn_layers"}
MIXERS = {"mamba": ("mamba", mamba2_x_skip), "attention": ("attn", nope_attention)}
HEAD_ROWS = 2048


def pattern(cfg: dict) -> list:
    return list(cfg["layer_types"][: cfg["n_layers"]])


def _layer_leaves(c: dict, kind: str, stack: tuple) -> dict:
    name, mixer = MIXERS[kind]
    sp = L.norm_pair(c, "ln1", stack)
    sp[name] = mixer.leaves(c, stack) if kind == "mamba" else L.attention(c, stack)
    sp.update(L.norm_pair(c, "ln2", stack))
    sp["moe"] = held_moe.leaves(c, stack)
    return sp


def layout(cfg: dict) -> dict:
    c = L.sizes(cfg)
    kinds = pattern(c)
    tree = {"embed": {"tok": L.Leaf((c["vocab_padded"], c["d_model"]), L.DTYPES[c["param_dtype"]], "normal",
                                    c["vocab_padded"])}}
    tree.update(L.norm_pair(c, "final_norm"))
    for kind, stack in STACKS.items():
        if kind in kinds:
            tree[stack] = _layer_leaves(c, kind, (kinds.count(kind),))
    return tree


def _layer(kind: str):
    name, mixer = MIXERS[kind]

    def run(cfg, num, p, x):
        r = cfg["residual_multiplier"]
        x = x + r * mixer.block(cfg, num, p[name], M.rmsnorm(x, p["ln1"], cfg["norm_eps"]))
        return x + r * held_moe.block(cfg, num, p["moe"], M.rmsnorm(x, p["ln2"], cfg["norm_eps"]))

    return run


def _nll_sum(h, table, labels, vocab: int, scaling: float, fp8: bool):
    num = M.Numerics("fp8" if fp8 else "f32")
    logits = num.mm(h, table.t()) / scaling
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < vocab, logits, M.NEG_INF)
    valid = (labels >= 0) & (labels < vocab)
    idx = torch.where(valid, labels, 0).long()
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, idx[:, None])[:, 0]
    return torch.where(valid, nll, 0.0).sum()


def loss(cfg: dict, params, tokens, labels, precision: str = "f32"):
    c = L.sizes(cfg)
    num = M.Numerics(precision)
    x = params["embed"]["tok"][tokens] * c["embedding_multiplier"]
    seen = {kind: 0 for kind in STACKS}
    for kind in pattern(c):
        p = M.layer_params(params[STACKS[kind]], seen[kind])
        seen[kind] += 1
        x = M.run(_layer(kind), c, num, p, x)
    h = M.rmsnorm(x, params["final_norm"], c["norm_eps"]).reshape(-1, c["d_model"])
    flat = labels.reshape(-1)
    total = h.new_zeros(())
    for r0 in range(0, h.shape[0], HEAD_ROWS):
        args = (h[r0 : r0 + HEAD_ROWS], params["embed"]["tok"], flat[r0 : r0 + HEAD_ROWS], c["vocab"],
                c["logits_scaling"], num.fp8)
        total = total + (checkpoint(_nll_sum, *args, use_reentrant=False) if torch.is_grad_enabled() else _nll_sum(*args))
    valid = ((flat >= 0) & (flat < c["vocab"])).sum().clamp(min=1)
    return total / valid


def _routed(c: dict) -> int:
    """One layer's held experts' parameters."""
    return c["experts_held"] * 3 * c["d_model"] * c["d_expert"]


def _moe(c: dict) -> int:
    return _routed(c) + c["d_model"] * c["n_experts"] + 3 * c["d_model"] * c["shared_intermediate_size"]


def param_count(cfg: dict) -> int:
    c = flops.full(cfg)
    conv_bias = c["ssm_inner"] + 2 * c["ssm_state"]
    mixer = {"mamba": flops.mamba_params(c) + conv_bias, "attention": flops.attention_params(c)}
    body = sum(mixer[kind] + _moe(c) + 2 * c["d_model"] for kind in pattern(c))
    return body + c["d_model"] + flops.unembed_params(c)


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Every weight met at every position, the held experts at the share
    of the routed pairs a card of the deployment computes, ``top_k *
    experts_held / n_experts`` experts a token (the tokens routed to them
    from every card); the SSD scan of each Mamba2 layer and the attention
    of each attention layer."""
    c = flops.full(cfg)
    kinds = pattern(c)
    share = c["top_k"] * c["experts_held"] / c["n_experts"]
    met = param_count(c) - len(kinds) * _routed(c) + len(kinds) * share * 3 * c["d_model"] * c["d_expert"]
    out = 6 * met * batch * seq
    fwd, bwd = flops.ssd_ops(batch, seq, c["ssm_heads"], c["ssm_head_dim"], c["ssm_state"])
    out += kinds.count("mamba") * (fwd + bwd)
    return out + flops.attention_flops(c, batch, seq, kinds.count("attention"))


def small(cfg: dict) -> dict:
    """Every width cut, 16 experts of which 4 held, top 4; the first six
    layers of the pattern (five Mamba2, one attention)."""
    return dict(
        cfg, d_model=64, d_head=16, vocab=500, n_heads=4, n_kv=2, n_layers=6, d_expert=32,
        shared_intermediate_size=48, n_experts=16, experts_held=4, top_k=4, ssm_state=16, ssm_head_dim=16,
        ssm_inner=128, ssm_heads=8, ssd_chunk=16,
    )
