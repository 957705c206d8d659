"""granite-4.0-h-small (32B total, 9B active) — 40 layers by pattern: 36
Mamba2 mixers and 4 GQA NoPE attention mixers, each layer followed by a
dropless MoE block (72 experts of width 768, top-10, a softmax over the ten
chosen logits) and one shared SwiGLU expert of width 1,536.
[huggingface.co/ibm-granite/granite-4.0-h-small config.json,
``model_type: granitemoehybrid``]

Not in ``registry.ARCHS``, which holds the reference's ten.  A benchmark
configuration cuts its depth and the experts held here
(``dataclasses.replace(CONFIG, n_layers=..., experts_held=...)``)."""
from .base import ModelConfig

# every tenth layer from index 5 is an attention layer
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_head=128, d_ff=0,
    vocab=100352, act="swiglu", norm="rms", tie_embeddings=True,
    n_experts=72, top_k=10, n_shared=1, d_expert=768, shared_intermediate_size=1536, dropless=True,
    ssm_state=128, ssm_heads=128, ssm_head_dim=64, ssm_inner=8192, conv_k=4, ssd_chunk=256,
    layer_types=LAYER_TYPES, attention_multiplier=0.0078125, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0, position_embedding_type="nope",
    mamba_conv_bias=True, ssm_skip="x", norm_eps=1e-5,
    notes="Mamba2: 128 heads of 64, d_state 128, n_groups 1, conv 4 with bias, gated RMSNorm; "
          "attention: 32 query heads over 8 kv heads of 128, NoPE, scale 1/128")
