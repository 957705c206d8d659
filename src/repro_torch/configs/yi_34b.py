"""yi-34b — llama-arch GQA. [arXiv:2403.04652; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    vocab=64000, act="swiglu", norm="rms",
    notes="56 heads; GQA kv=8")
