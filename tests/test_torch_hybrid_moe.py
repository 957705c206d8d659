"""The hybrid_moe family's parts in the port (granite-4.0-h), on the CPU:

- ``ops.attention`` with a scale of its own and, in a layer, no rotary
  embedding, against plain softmax attention;
- the dropless MoE layer: an expert given more rows than the capacity
  dispatch would keep computes all of them, and pairs routed to experts
  held elsewhere add nothing;
- a multiplier of 1 is not applied: the reference's configurations
  compute bit for bit what they did with the family's fields present;
- its decode step and its mesh path refuse, naming the family.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import granite_4_0_h_small, registry
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.params import init_params
from repro_torch.parallel import steps

SMALL = dict(
    n_layers=6, d_model=64, n_heads=4, n_kv=2, d_head=16, vocab=500, d_expert=32, shared_intermediate_size=48,
    n_experts=16, experts_held=4, top_k=4, ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_inner=128, ssd_chunk=16,
)


def small(**kw):
    return dataclasses.replace(granite_4_0_h_small.CONFIG, **{**SMALL, "param_dtype": torch.float32, **kw})


def plain_attention(q, k, v, scale):
    """Softmax attention, causal, query head h over kv head h // (H / Hkv)."""
    H, Hkv, S = q.shape[2], k.shape[2], q.shape[1]
    k, v = (t.float().repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    logits = logits.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_takes_a_scale(dtype):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, h, 16, generator=gen).to(dtype) for h in (8, 2, 2))
    for scale in (None, 1 / 128, 0.7):
        got = ops.attention(q, k, v, scale=scale)
        want = plain_attention(q, k, v, 16**-0.5 if scale is None else scale)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_a_nope_layer_applies_no_rotary_embedding():
    cfg = small()
    p = init_params(L.attention_specs(cfg), torch.Generator().manual_seed(1), "cpu")
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    positions = torch.arange(32).expand(2, 32)
    got = L.attention_apply(p, x, positions, cfg=cfg)
    q, k, v = (L._project(x, p[w]) for w in ("wq", "wk", "wv"))
    want = plain_attention(q, k, v, cfg.attention_multiplier).reshape(2, 32, -1) @ p["wo"].reshape(-1, cfg.d_model)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # with rotary positions the same weights give another answer
    roped = L.attention_apply(p, x, positions, cfg=dataclasses.replace(cfg, position_embedding_type="rope"))
    assert not torch.allclose(roped, got, atol=1e-3)


def _experts(cfg, gen):
    sp = L.moe_specs(cfg)
    return init_params(sp, gen, "cpu")


def _oracle(p, xt, cfg, e_lo=0):
    """Every token through each of its chosen experts held here, gated; no
    capacity, no sort."""
    w, idx = ops.topk_gate(xt @ p["router"], cfg.top_k)
    y = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j]) - e_lo
            if 0 <= e < p["w_gate"].shape[0]:
                h = F.silu(xt[t] @ p["w_gate"][e]) * (xt[t] @ p["w_up"][e])
                y[t] += w[t, j] * (h @ p["w_down"][e])
    return y


def test_dropless_computes_every_pair_of_a_crowded_expert():
    cfg = small(n_experts=8, experts_held=8, top_k=2, capacity_factor=1.25)
    p = _experts(cfg, torch.Generator().manual_seed(3))
    p["router"] = p["router"].clone()
    p["router"][:, 0] += 3.0  # expert 0 is everyone's first choice
    T = 40
    xt = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(4)).abs()
    _, idx = ops.topk_gate(xt @ p["router"], cfg.top_k)
    C = L.moe_capacity(cfg, T)
    assert int((idx == 0).sum()) == T > C  # the capacity dispatch would drop T - C of them
    got = L.moe_held(p, xt, cfg=cfg)
    torch.testing.assert_close(got, _oracle(p, xt, cfg), rtol=1e-5, atol=1e-6)
    capped = L._moe_local(p, xt, cfg=cfg, C=C, e_lo=0, E_loc=cfg.n_experts)
    assert not torch.allclose(capped, got, atol=1e-4)


def test_pairs_held_elsewhere_add_nothing():
    cfg = small()
    full = _experts(dataclasses.replace(cfg, experts_held=cfg.n_experts), torch.Generator().manual_seed(5))
    xt = torch.randn(48, cfg.d_model, generator=torch.Generator().manual_seed(6))
    for e_lo in (0, 4, 12):
        share = dict(full, **{k: full[k][e_lo : e_lo + 4] for k in ("w_gate", "w_up", "w_down")})
        torch.testing.assert_close(L.moe_held(share, xt, cfg=cfg, e_lo=e_lo), _oracle(share, xt, cfg, e_lo),
                                   rtol=1e-5, atol=1e-6)


def test_the_family_steps_and_its_defaults_change_nothing():
    """One step of the family; and a reference configuration with the
    family's fields at their defaults computes bit for bit what the same
    configuration computes with a multiplier of 1 given explicitly."""
    cfg = small()
    step, specs = steps.make_train_step(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert set(params) == {"embed", "final_norm", "mamba_layers", "attn_layers"}
    assert params["mamba_layers"]["mamba"]["conv_b"].shape == (5, cfg.ssm_inner + 2 * cfg.ssm_state)
    assert params["attn_layers"]["moe"]["w_gate"].shape == (1, cfg.experts_held, cfg.d_model, cfg.d_expert)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1)) for k in ("tokens", "labels")}
    loss, _ = steps.loss_and_grads(cfg, params, batch)
    assert torch.isfinite(loss)
    base = registry.get("zamba2-1.2b-smoke")
    p = init_params(lm.lm_specs(base), torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.randint(0, base.vocab, (2, 32), generator=torch.Generator().manual_seed(2)) for k in ("tokens", "labels")}
    ones = dataclasses.replace(base, embedding_multiplier=1, residual_multiplier=1.0, logits_scaling=1)
    assert torch.equal(lm.forward(base, p, b)[1], lm.forward(ones, p, b)[1])


def test_decode_and_the_mesh_refuse_by_family():
    cfg = small()
    with pytest.raises(ValueError, match="hybrid_moe"):
        lm.cache_specs(cfg, 2, 16)
    with pytest.raises(ValueError, match="hybrid_moe"):
        lm.decode_step(cfg, {}, {}, torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32))
    params = init_params(lm.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.zeros(2, 16, dtype=torch.int64) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="hybrid_moe.*mesh"):
        lm.forward(cfg, params, batch, rules=object())
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(cfg, layer_types=("mamba",) * 3)
    with pytest.raises(ValueError, match="experts_held needs dropless"):
        dataclasses.replace(cfg, dropless=False)
