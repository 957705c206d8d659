"""llava-next-34b — yi-34b language backbone; anyres vision frontend is a
STUB (precomputed patch embeddings). [hf:llava-hf/llava-v1.6-*; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    vocab=64000, act="swiglu", norm="rms",
    n_frontend_tokens=2880,
    notes="anyres tiling ~ 2880 image tokens supplied pre-embedded")
