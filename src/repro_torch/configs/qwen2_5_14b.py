"""qwen2.5-14b — GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=13824,
    vocab=152064, qkv_bias=True, act="swiglu", norm="rms",
    notes="40 heads not divisible by model=16 -> baseline replicates "
          "head sharding; see §Perf head-padding optimization")
