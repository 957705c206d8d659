"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=102400, n_experts=64, top_k=6, n_shared=2, d_expert=1408,
    act="swiglu", norm="rms",
    notes="per-expert d_ff=1408; shared experts = 2 x 1408; MHA (kv=16)")
