"""seamless-m4t-large-v2 — enc-dec multimodal backbone; speech frontend is
a STUB (precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=8192, vocab=256206, act="gelu", norm="ln",
    tie_embeddings=True,
    notes="24 enc + 24 dec layers; MHA kv=16; frame embeddings "
          "precomputed by the stub frontend")
