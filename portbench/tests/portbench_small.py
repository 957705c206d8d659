"""A configuration at a CPU test's size: every width cut, the kinds of
layer, their order and the options kept (the hybrid family's last group
short, its attention window shorter than the test's sequences)."""


def reduced(config: dict, dtype: str = "float32") -> dict:
    cfg = dict(config, param_dtype=dtype, d_model=64, d_head=16, d_ff=128, vocab=500, n_heads=4)
    cfg["n_kv"] = min(cfg["n_kv"], 4)
    if cfg["family"] == "hybrid":
        cfg.update(n_layers=5, attn_every=2, ssm_state=16, ssm_head_dim=16, ssm_inner=128, ssm_heads=8, ssd_chunk=16)
        cfg["window"] = 24
    else:
        cfg["n_layers"] = 2
    return cfg
