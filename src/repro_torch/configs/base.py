"""Model and shape configuration dataclasses (port of
``src/repro/configs/base.py``).

The same fields, defaults and arithmetic as the reference, with two
changes: ``param_dtype`` is a torch dtype (``torch.bfloat16``, and
``torch.float32`` for the ``reduced`` smoke twins), and the fields of
:data:`PORT_FIELDS` (the ``hybrid_moe`` family's: a layer pattern, the
multipliers, NoPE, the Mamba2 conv bias and skip, a held share of dropless
experts, the norms' eps) are the port's own.  Each defaults to today's
arithmetic, so the reference's ten configurations compute what they did.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | hybrid_moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0  # default d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rms"  # rms | ln
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_inner: int = 0  # default 2*d_model
    conv_k: int = 4
    ssd_chunk: int = 128
    # --- hybrid (Zamba2-style shared attention) ---
    attn_every: int = 0
    # --- enc-dec ---
    enc_layers: int = 0
    # --- vlm/audio stubs ---
    n_frontend_tokens: int = 0
    # --- execution ---
    window: int = 0  # sliding-window attention (0 = full)
    remat: str = "full"  # none | full
    param_dtype: torch.dtype = torch.bfloat16
    tp_pad: int = 0  # pad q-heads to this TP degree (0 on one card)
    notes: str = ""
    # --- the port's own (PORT_FIELDS): hybrid_moe (granite-4.0-h) ---
    # each layer's mixer, "mamba" or "attention"; the model runs the first
    # n_layers (a depth cut keeps the published list whole)
    layer_types: Tuple[str, ...] = ()
    attention_multiplier: float = 0.0  # attention's scale; 0: 1/sqrt(d_head)
    embedding_multiplier: float = 1.0  # on the embedded tokens
    residual_multiplier: float = 1.0  # on every residual branch
    logits_scaling: float = 1.0  # the logits are divided by it
    position_embedding_type: str = "rope"  # rope | nope
    mamba_conv_bias: bool = False
    ssm_skip: str = "dt_x"  # D's input: the dt-scaled x (dt_x) | x itself (x, Mamba2's)
    experts_held: int = 0  # experts [0, experts_held) live here; 0: all n_experts
    shared_intermediate_size: int = 0  # the shared expert's width; 0: n_shared x d_expert
    dropless: bool = False  # every (token, choice) pair to a held expert computed
    norm_eps: float = 1e-6

    def head_padding(self):
        """(Hp, gp, g_true): padded head count, padded group size, true
        group size.  Padding happens inside each kv group so the
        head->kv mapping is preserved exactly; padded heads are masked
        before the output projection, so results equal the true arch."""
        H, Hkv = self.n_heads, self.n_kv
        if not H or not Hkv:
            return H, 0, 0
        g = H // Hkv
        if not self.tp_pad or H % self.tp_pad == 0:
            return H, g, g
        gp = g
        while (gp * Hkv) % self.tp_pad != 0:
            gp += 1
        return gp * Hkv, gp, g

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            self.d_head = self.d_model // self.n_heads
        ssm = self.family in ("ssm", "hybrid", "hybrid_moe")
        if ssm and self.ssm_inner == 0:
            self.ssm_inner = 2 * self.d_model
        if ssm and self.ssm_heads == 0:
            self.ssm_heads = self.ssm_inner // self.ssm_head_dim
        self.layer_types = tuple(self.layer_types)
        if self.family == "hybrid_moe":
            kinds = self.layer_types[: self.n_layers]
            if len(kinds) < self.n_layers or not set(kinds) <= {"mamba", "attention"}:
                raise ValueError(f"{self.name}: layer_types must give 'mamba' or 'attention' for each layer")
        if self.experts_held and not self.dropless:
            # the capacity dispatch indexes all n_experts' weights
            raise ValueError(f"{self.name}: experts_held needs dropless routing")

    def pattern(self) -> Tuple[str, ...]:
        """Each layer's mixer (the hybrid_moe family)."""
        return self.layer_types[: self.n_layers]

    def held_experts(self) -> int:
        return self.experts_held or self.n_experts

    def shared_width(self) -> int:
        return self.shared_intermediate_size or (self.d_expert or self.d_ff) * self.n_shared

    def _mamba_params(self) -> int:
        d, di, N, Hs = self.d_model, self.ssm_inner, self.ssm_state, self.ssm_heads
        conv = (self.conv_k + self.mamba_conv_bias) * (di + 2 * N)
        return d * (2 * di + 2 * N + Hs) + di * d + conv + 3 * Hs + di

    def param_count(self) -> int:
        """Total parameters N (for 6·N·D roofline accounting)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        H, Hkv, Dh = self.n_heads, self.n_kv, self.d_head
        attn = (
            d * (H + 2 * Hkv) * Dh
            + H * Dh * d
            + (H * Dh + 2 * Hkv * Dh if self.qkv_bias else 0)
        )
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            fe = self.d_expert or f
            moe = self.n_experts * 3 * d * fe + d * self.n_experts
            if self.n_shared:
                moe += 3 * d * fe * self.n_shared
            per_layer = attn + moe + 2 * d
            body = self.n_layers * per_layer
        elif self.family == "ssm":
            body = self.n_layers * (self._mamba_params() + d)
        elif self.family == "hybrid":
            shared = attn + mlp + 2 * d
            body = self.n_layers * (self._mamba_params() + d) + shared
        elif self.family == "hybrid_moe":
            fe = self.d_expert or f
            moe = self.held_experts() * 3 * d * fe + d * self.n_experts + 3 * d * self.shared_width()
            mixers = {"mamba": self._mamba_params(), "attention": attn}
            body = sum(mixers[k] + moe + 2 * d for k in self.pattern())
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + mlp + 2 * d)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            body = enc + dec
        else:  # dense / vlm
            per_layer = attn + mlp + 2 * d
            body = self.n_layers * per_layer
        emb = V * d * (1 if self.tie_embeddings else 2)
        return body + emb + d

    def active_param_count(self) -> int:
        """Activated parameters (MoE: top-k + shared only), as the
        reference counts them."""
        if self.family != "moe":
            return self.param_count()
        d, V = self.d_model, self.vocab
        H, Hkv, Dh = self.n_heads, self.n_kv, self.d_head
        fe = self.d_expert or self.d_ff
        attn = d * (H + 2 * Hkv) * Dh + H * Dh * d
        act_moe = (self.top_k + self.n_shared) * 3 * d * fe + d * self.n_experts
        body = self.n_layers * (attn + act_moe + 2 * d)
        return body + V * d + d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# the fields the port adds to the reference's ModelConfig (each at its
# default in the reference's ten configurations)
PORT_FIELDS = frozenset({
    "layer_types", "attention_multiplier", "embedding_multiplier", "residual_multiplier", "logits_scaling",
    "position_embedding_type", "mamba_conv_bias", "ssm_skip", "experts_held", "shared_intermediate_size",
    "dropless", "norm_eps",
})

# architectures for which long_500k is runnable (sub-quadratic decode)
LONG_CONTEXT_OK = {"mamba2-130m", "zamba2-1.2b"}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test twin: same family/topology, tiny dims."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)) if cfg.n_kv else 0,
        d_head=16,
        d_ff=128,
        vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared=min(cfg.n_shared, 1),
        d_expert=32 if cfg.d_expert else 0,
        capacity_factor=8.0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=0,
        ssm_inner=0,
        ssm_head_dim=16,
        attn_every=2 if cfg.attn_every else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
        window=min(cfg.window, 64) if cfg.window else 0,
        remat="none",
        param_dtype=torch.float32,
    )
