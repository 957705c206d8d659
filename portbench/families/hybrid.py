"""The hybrid family (zamba2): a stack of Mamba2 layers, and after every
``attn_every`` of them (the last group may be short) one application of
a shared dense block outside the stack (``shared_attn``)."""

from portbench.arith import flops
from portbench.reference import layout as L
from portbench.reference import model as M


def layout(cfg: dict) -> dict:
    c = L.sizes(cfg)
    layers = {**L.norm_pair(c, "ln1", (c["n_layers"],)), "mamba": L.mamba2(c, (c["n_layers"],))}
    return L.lm(c, layers, shared_attn=L.dense_layer(c))


def groups(cfg: dict) -> list:
    """``(start, width)`` of each group of Mamba2 layers."""
    ae = cfg["attn_every"] or cfg["n_layers"]
    return [(s, min(ae, cfg["n_layers"] - s)) for s in range(0, cfg["n_layers"], ae)]


def _stack(cfg, num, params, x):
    for start, width in groups(cfg):
        for i in range(start, start + width):
            x = M.run(M.ssm_layer, cfg, num, M.layer_params(params["layers"], i), x)
        x = M.run(M.dense_layer, cfg, num, params["shared_attn"], x)
    return x


def loss(cfg: dict, params, tokens, labels, precision: str = "f32"):
    return M.lm_loss(cfg, params, tokens, labels, precision, _stack)


def _shared(c: dict) -> int:
    return flops.attention_params(c) + flops.mlp_params(c) + 2 * c["d_model"]


def param_count(cfg: dict) -> int:
    c = flops.full(cfg)
    mamba = c["n_layers"] * (flops.mamba_params(c) + c["d_model"])
    return mamba + _shared(c) + flops.unembed_params(c) + c["d_model"]


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """The Mamba2 layers and the unembedding at every position, the shared
    block at each of its applications, each layer's SSD scan and each
    application's attention."""
    c = flops.full(cfg)
    apps = len(groups(c))
    body = c["n_layers"] * (flops.mamba_params(c) + c["d_model"]) + apps * _shared(c) + c["d_model"]
    out = 6 * (body + flops.unembed_params(c)) * batch * seq
    fwd, bwd = flops.ssd_ops(batch, seq, c["ssm_heads"], c["ssm_head_dim"], c["ssm_state"])
    out += c["n_layers"] * (fwd + bwd)
    return out + flops.attention_flops(c, batch, seq, apps)


def small(cfg: dict) -> dict:
    """Every width cut; five Mamba2 layers with the shared block after
    every two (the last group short), its window shorter than the tests'
    sequences."""
    return dict(
        cfg, d_model=64, d_head=16, d_ff=128, vocab=500, n_heads=4, n_kv=min(cfg["n_kv"], 4), n_layers=5,
        attn_every=2, ssm_state=16, ssm_head_dim=16, ssm_inner=128, ssm_heads=8, ssd_chunk=16, window=24,
    )
