"""The dense family: a stack of pre-norm layers, each attention then an
MLP (granite-20b)."""

from portbench.arith import flops
from portbench.reference import layout as L
from portbench.reference import model as M


def layout(cfg: dict) -> dict:
    c = L.sizes(cfg)
    return L.lm(c, L.dense_layer(c, (c["n_layers"],)))


def _stack(cfg, num, params, x):
    for i in range(cfg["n_layers"]):
        x = M.run(M.dense_layer, cfg, num, M.layer_params(params["layers"], i), x)
    return x


def loss(cfg: dict, params, tokens, labels, precision: str = "f32"):
    return M.lm_loss(cfg, params, tokens, labels, precision, _stack)


def _body(c: dict) -> int:
    return c["n_layers"] * (flops.attention_params(c) + flops.mlp_params(c) + 2 * c["d_model"]) + c["d_model"]


def param_count(cfg: dict) -> int:
    c = flops.full(cfg)
    return _body(c) + flops.unembed_params(c)


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Every weight met at every position (the unembedding too), and the
    attention of every layer."""
    c = flops.full(cfg)
    return 6 * param_count(c) * batch * seq + flops.attention_flops(c, batch, seq, c["n_layers"])


def small(cfg: dict) -> dict:
    """Every width cut, two layers."""
    return dict(cfg, d_model=64, d_head=16, d_ff=128, vocab=500, n_heads=4, n_kv=min(cfg["n_kv"], 4), n_layers=2)
