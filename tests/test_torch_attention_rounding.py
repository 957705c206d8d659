"""The bf16 flash-attention kernels' rounding, emulated in plain PyTorch on
the CPU, held to the plain attention at the card tests' tolerances.

``csrc/flash_attention.cu`` runs bf16 attention on the tensor cores,
whose products take bf16 operands.  This file writes out, in plain
PyTorch, every place where those kernels round, and checks that the
tolerances of ``tests/test_torch_cuda.py`` (``ATTN_TOL``,
``ATTN_GRAD_TOL``: unchanged) still hold:

- forward: logits ``q . k`` from the bf16 inputs in f32, scaled by
  ``1/sqrt(D)`` after the product; ``p`` in f32; ``P . V`` as ``P_hi . V
  + P_lo . V`` with ``P_hi = bf16(p)`` and ``P_lo = bf16(p - P_hi)``; the
  output rounded once to bf16;
- backward: ``P`` recomputed from the forward's log-sum-exp, ``delta``
  from the bf16 output, ``dS = P (dP - delta)`` in f32, and ``P`` and
  ``dS`` each rounded once to bf16 for the products ``P^T dO``, ``dS^T
  q`` and ``dS K``.

One case shows why the forward splits ``P``: rounded once to bf16, the
output misses its tolerance.  The yardstick is the port's plain version
(``ref.attention``, ``ref.attention_bwd``), held in turn to the JAX
package's ``ref.attention`` on the same inputs.  Inputs are made with
numpy from a seed, as the card tests draw them (0.5 N(0, 1) in bf16).
``dkdv_splits``, the backward's split of the dK/dV grid over query-head
groups, is pure Python and checked here for the card's 132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import common as pcommon
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ref

# tests/test_torch_cuda.py: (rtol, atol as a share of the largest magnitude)
ATTN_TOL = (2.0**-7, 1e-5)
ATTN_GRAD_TOL = (2.0**-7, 1e-2)


def _close_to_scale(got, want, rtol, scale_atol):
    want = want.float()
    atol = max(scale_atol * float(want.abs().max()), 1e-6)
    return torch.isclose(got.float(), want, rtol=rtol, atol=atol)


def _inputs(B, S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)

    def bf16(shape, scale):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).bfloat16()

    q = bf16((B, S, H, D), 0.5)
    k = bf16((B, S, Hkv, D), 0.5)
    v = bf16((B, S, Hkv, D), 0.5)
    do = bf16((B, S, H, D), 1.0)
    return q, k, v, do


def _bf16(x):
    return x.bfloat16().float()


def _logits(q, k, causal, window):
    """(B, H, Sq, Sk) f32: the product of the bf16 values, then the scale;
    masked entries -inf (the kernels' p = 0 exactly)."""
    S, H, D = q.shape[1:]
    k32 = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k32) * (1.0 / D**0.5)
    if causal:
        qi = torch.arange(S)[:, None]
        kj = torch.arange(S)[None, :]
        ok = kj <= qi
        if window:
            ok = ok & (qi - kj < window)
        s = s.masked_fill(~ok, float("-inf"))
    return s


def kernel_forward(q, k, v, *, causal, window, split=True):
    """``(o, lse)`` as the bf16 forward kernel rounds them."""
    g = q.shape[2] // k.shape[2]
    s = _logits(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    v32 = v.float().repeat_interleave(g, dim=2)
    p_hi = _bf16(p)
    pv = torch.einsum("bhqk,bkhd->bhqd", p_hi, v32)
    if split:
        pv = pv + torch.einsum("bhqk,bkhd->bhqd", _bf16(p - p_hi), v32)
    o = (pv / lsum).transpose(1, 2).bfloat16()
    return o, (m + torch.log(lsum)).squeeze(-1)


def kernel_backward(q, k, v, o, lse, do, *, causal, window):
    """``(dq, dk, dv)`` as the bf16 backward kernels round them."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = 1.0 / D**0.5
    p = torch.exp(_logits(q, k, causal, window) - lse[..., None])
    do32 = do.float().transpose(1, 2)  # (B, H, S, D)
    v32 = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    k32 = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    q32 = q.float().transpose(1, 2)
    dp = do32 @ v32.transpose(-1, -2)
    delta = (do32 * o.float().transpose(1, 2)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dv = _bf16(p).transpose(-1, -2) @ do32
    dk = (_bf16(ds).transpose(-1, -2) @ q32) * scale
    dq = (_bf16(ds) @ k32) * scale

    def per_kv_head(x):  # (B, H, S, D) -> (B, S, Hkv, D), the group summed
        return x.transpose(1, 2).reshape(B, S, Hkv, g, D).sum(dim=3)

    return dq.transpose(1, 2).bfloat16(), per_kv_head(dk).bfloat16(), per_kv_head(dv).bfloat16()


CASES = [
    # (B, S, H, Hkv, D, causal, window)
    pytest.param(1, 256, 8, 2, 128, True, 0, id="gqa-causal-d128"),
    pytest.param(1, 256, 8, 2, 64, False, 0, id="gqa-full-d64"),
    pytest.param(1, 192, 12, 1, 128, True, 0, id="mqa-causal-d128"),
    pytest.param(2, 128, 4, 1, 64, False, 0, id="mqa-full-d64"),
    pytest.param(1, 256, 4, 2, 64, True, 100, id="window-100-d64"),
    pytest.param(1, 128, 4, 4, 128, True, 64, id="window-64-d128"),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", CASES)
def test_split_p_holds_the_output_tolerance(B, S, H, Hkv, D, causal, window):
    q, k, v, _ = _inputs(B, S, H, Hkv, D)
    mask = dict(causal=causal, window=window)
    o, _ = kernel_forward(q, k, v, **mask)
    want = ref.attention(q.float(), k.float(), v.float(), **mask)
    assert bool(_close_to_scale(o, want, *ATTN_TOL).all())


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", CASES)
def test_single_rounding_holds_the_gradient_tolerance(B, S, H, Hkv, D, causal, window):
    q, k, v, do = _inputs(B, S, H, Hkv, D, seed=1)
    mask = dict(causal=causal, window=window)
    o, lse = kernel_forward(q, k, v, **mask)
    got = kernel_backward(q, k, v, o, lse, do, **mask)
    want = ref.attention_bwd(*(t.float() for t in (q, k, v, do)), **mask)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        assert bool(_close_to_scale(a, w, *ATTN_GRAD_TOL).all()), name


def test_p_rounded_once_misses_the_output_tolerance():
    """The forward cannot round P once to bf16 for P . V, as FlashAttention
    and SDPA do: a few percent of the outputs then miss one bf16 step."""
    q, k, v, _ = _inputs(1, 256, 8, 2, 128)
    want = ref.attention(q.float(), k.float(), v.float())
    o, _ = kernel_forward(q, k, v, causal=True, window=0, split=False)
    miss = 1.0 - _close_to_scale(o, want, *ATTN_TOL).float().mean().item()
    assert miss > 0.01


def test_plain_version_matches_the_jax_reference():
    """The yardstick above, ``ref.attention``, against the JAX package's
    plain attention on the same inputs (one sequence, f32)."""
    q, k, v, _ = _inputs(1, 128, 8, 2, 64)
    for causal, window in ((True, 0), (False, 0), (True, 48)):
        got = ref.attention(q[0].float(), k[0].float(), v[0].float(), causal=causal, window=window)
        want = jref.attention(
            jnp.asarray(q[0].float().numpy()),
            jnp.asarray(k[0].float().numpy()),
            jnp.asarray(v[0].float().numpy()),
            causal=causal,
            window=window,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture
def card_of_132_sms(monkeypatch):
    monkeypatch.setitem(pcommon._SM_COUNT, 0, 132)  # the SM-count cache
    return torch.device("cuda", 0)


def test_dkdv_splits_fill_two_waves_at_granite(card_of_132_sms):
    """granite-20b's train layer: 64 k tiles x 1 kv head x 2 rows = 128
    blocks, under one wave; the split divides the 48 query heads and gives
    at least two full waves of two blocks on each of 132 SMs."""
    n = pfa.dkdv_splits(2, 4096, 1, 48, card_of_132_sms)
    assert 48 % n == 0 and n > 1
    assert 64 * 1 * 2 * n >= 2 * pfa.DKDV_BLOCKS_PER_SM * 132
    # the fewest such: one fewer divisor would not fill two waves
    smaller = [d for d in range(1, n) if 48 % d == 0]
    assert all(128 * d < 2 * pfa.DKDV_BLOCKS_PER_SM * 132 for d in smaller)


def test_dkdv_splits_leave_a_full_grid_alone(card_of_132_sms):
    """qwen2.5-14b's train layer: 64 x 8 x 2 = 1,024 blocks already fill
    two waves, so dK, dV are written directly."""
    assert pfa.dkdv_splits(2, 4096, 8, 5, card_of_132_sms) == 1


@pytest.mark.parametrize(
    "B,S,Hkv,g", [(1, 128, 1, 48), (1, 256, 1, 8), (2, 512, 2, 6), (4, 4096, 4, 7)]
)
def test_dkdv_splits_divide_the_group(card_of_132_sms, B, S, Hkv, g):
    n = pfa.dkdv_splits(B, S, Hkv, g, card_of_132_sms)
    assert 1 <= n <= g and g % n == 0
