"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_head_dim=64,
    attn_every=6, window=4096, act="gelu", norm="rms",
    notes="38 Mamba2 blocks; one SHARED attention+MLP block applied "
          "every 6 blocks (Zamba2 weight sharing); 4k sliding window "
          "for long-context decode (DESIGN §Arch-applicability)")
