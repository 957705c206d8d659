"""granite-34b — llama-arch code model, MQA (kv=1), 88 layers.
[arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, act="gelu", norm="ln",
    notes="MQA kv=1; depth-extended granite-20b")
