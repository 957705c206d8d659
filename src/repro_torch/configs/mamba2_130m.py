"""mamba2-130m — attention-free SSD. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64,
    act="swiglu", norm="rms",
    notes="d_inner=1536, 24 SSD heads of P=64, N=128; no attention, "
          "no MLP (Mamba2 block only)")
