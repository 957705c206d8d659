"""granite-20b — llama-arch code model, MQA (kv=1), gelu 4x MLP.
[arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, act="gelu", norm="ln",
    notes="MQA kv=1; gpt-bigcode-style gelu MLP (d_ff = 4*d)")
