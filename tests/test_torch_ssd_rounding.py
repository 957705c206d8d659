"""The SSD kernels' rounding, emulated in plain PyTorch on the CPU.

``csrc/ssd_scan.cu`` computes the dual form of the SSD scan tile by tile
(T = 64 rows) with every product on the tensor cores, whose f32 path
takes TF32 operands (a 10-bit mantissa, ``cvt.rna``: round to nearest,
ties away from zero).  This file writes the kernels' arithmetic out in
plain PyTorch, forward and backward, with each product made one of three
ways, and holds the result to the same arithmetic in f64:

- ``tf32``: each operand rounded once to TF32, f32 sums;
- ``3xtf32``: each operand split into ``hi``, v cut to TF32 toward zero,
  and ``lo``, ``v - hi`` cut the same way, the product ``lo_a hi_b + hi_a
  lo_b + hi_a hi_b`` in f32 (the kernels' choice; ``3xtf32-rna`` rounds
  both parts to nearest instead, which sm_90 has no instruction for);
- ``f32``: f32 operands and sums (the CUDA cores' FMAs).

Products in TF32 miss the kernels' tolerance, 1e-4 of the largest
magnitude (``SSD_TOL`` in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), forward and backward; 3xTF32 meets it, as f32 does.
The f64 arithmetic is held in turn to autograd through the port's plain
chunked form (``ref.ssd_scan_chunked``, its CPU path and the kernels'
yardstick), which is held to the JAX package's plain chunked form.
Inputs are made with numpy from a seed, as the card tests draw them:
x 0.5 N(0, 1), a = -softplus(N(0, 1) - 1), b and c 0.3 N(0, 1), dy N(0, 1),
at a mamba2-130m head (P 64, N 128) over S = 1,024.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

SSD_TOL = 1e-4  # of the largest magnitude (tests/test_torch_cuda.py SSD_TOL)
TILE = 64  # the kernels' tile at N 128, P 64 (ssd_scan.tile_rows)
GRADS = ("dx", "da", "db", "dc")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: add half a unit of
    the 10-bit mantissa to the magnitude's bits, clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """f32 cut to TF32 toward zero: the low 13 bits cleared (the kernels'
    split, a mask where cvt.rna costs four instructions on sm_90)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def _mm_split(a, b, cut):
    ah, bh = cut(a), cut(b)
    al, bl = cut(a - ah), cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_3xtf32(a, b):
    """The kernels' 3xTF32: hi and lo cut toward zero."""
    return _mm_split(a, b, tf32_rz)


def mm_3xtf32_rna(a, b):
    """3xTF32 with hi and lo rounded to nearest (cvt.rna)."""
    return _mm_split(a, b, tf32)


def mm_plain(a, b):
    return a @ b


PRODUCTS = {"tf32": mm_tf32, "3xtf32": mm_3xtf32, "3xtf32-rna": mm_3xtf32_rna, "f32": mm_plain}


def _inputs(S=1024, H=4, P=64, N=128, seed=0):
    """(x, a, b, c, dy) f32: one sequence, x (S, H, P), a (S, H), b, c (S, N)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    x = 0.5 * normal(S, H, P)
    a = -torch.nn.functional.softplus(normal(S, H) - 1)
    b = 0.3 * normal(S, N)
    c = 0.3 * normal(S, N)
    dy = normal(S, H, P)
    return x, a, b, c, dy


def _decays(a_tile):
    """A, A_T, L (masked before exp), w = exp(A_T - A), exp(A): all in the
    inputs' dtype, on the CUDA cores in the kernels."""
    A = torch.cumsum(a_tile, 0)
    T = A.shape[0]
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    L = torch.exp(torch.where(causal, A[:, None] - A[None, :], -math.inf))
    return A, A[-1], L, torch.exp(A[-1] - A), torch.exp(A)


def kernel_forward(x, a, b, c, mm, T=TILE):
    """``(y, states)`` as the forward kernel computes them, each product by
    ``mm``; states (H, tiles, N, P) enter each tile."""
    S, H, P = x.shape
    N = b.shape[1]
    y = torch.empty_like(x)
    states = torch.empty(H, S // T, N, P, dtype=x.dtype)
    for h in range(H):
        state = torch.zeros(N, P, dtype=x.dtype)
        for t in range(S // T):
            rows = slice(t * T, (t + 1) * T)
            X, Bt, Ct = x[rows, h], b[rows], c[rows]
            A, AT, L, w, eA = _decays(a[rows, h])
            CB = mm(Ct, Bt.T)
            y[rows, h] = mm(CB * L, X) + eA[:, None] * mm(Ct, state)
            states[h, t] = state
            state = torch.exp(AT) * state + mm((Bt * w[:, None]).T, X)
    return y, states


def kernel_backward(x, a, b, c, dy, states, mm, T=TILE):
    """``(dx, da, db, dc)`` as the backward kernel computes them: tiles in
    reverse carrying dH, db and dc summed over the heads in order."""
    S, H, P = x.shape
    N = b.shape[1]
    dx, da = torch.empty_like(x), torch.empty_like(a)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    for h in range(H):
        dH = torch.zeros(N, P, dtype=x.dtype)
        for t in reversed(range(S // T)):
            rows = slice(t * T, (t + 1) * T)
            X, DY, Bt, Ct, h_in = x[rows, h], dy[rows, h], b[rows], c[rows], states[h, t]
            A, AT, E, w, eA = _decays(a[rows, h])
            ECB = E * mm(Ct, Bt.T)
            G = mm(DY, X.T)
            EG = E * G
            dx[rows, h] = mm(ECB.T, DY) + w[:, None] * mm(Bt, dH)
            xdh = mm(X, dH.T)
            db[rows] += mm(EG.T, Ct) + w[:, None] * xdh
            dyh = mm(DY, h_in.T)
            dc[rows] += mm(EG, Bt) + eA[:, None] * dyh
            Tm = ECB * G  # E .* CB .* G
            W = w * (Bt * xdh).sum(1)
            dA = Tm.sum(1) - Tm.sum(0) + eA * (Ct * dyh).sum(1) - W
            dA[-1] += W.sum() + torch.exp(AT) * (dH * h_in).sum()
            da[rows, h] = torch.flip(torch.cumsum(torch.flip(dA, (0,)), 0), (0,))
            dH = torch.exp(AT) * dH + mm((Ct * eA[:, None]).T, DY)
    return dx, da, db, dc


def _err(got, want) -> float:
    """The largest error as a share of want's largest magnitude."""
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def case():
    """The inputs, and the kernels' arithmetic in f64 (forward, states,
    gradients)."""
    x, a, b, c, dy = _inputs()
    f64 = [t.double() for t in (x, a, b, c, dy)]
    y, states = kernel_forward(*f64[:4], mm_plain)
    grads = kernel_backward(*f64, states, mm_plain)
    return (x, a, b, c, dy), y, grads


def test_tf32_rounds_as_cvt_rna():
    """Ties go away from zero; the low 13 bits are clear."""
    one_half_ulp = 1 + 2.0**-11  # halfway between 1 and the next TF32 value
    x = torch.tensor([one_half_ulp, -one_half_ulp, 1 + 2.0**-12, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10), 1.0, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    r = tf32(torch.randn(1000))
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(tf32_rz(x), torch.tensor([1.0, -1.0, 1.0, 3.0, 0.0]))


def test_kernel_arithmetic_is_the_plain_chunked_form(case):
    """In f64 the kernels' forward and backward, at their tile, agree with
    the plain chunked form at the reference's chunk and its autograd
    gradient, to the plain form's own f32 rounding."""
    (x, a, b, c, dy), y, grads = case
    leaves = [t[None] for t in (x, a, b, c, dy)]
    assert _err(y, ref.ssd_scan_chunked(*leaves[:4], chunk=128)[0].double()) < SSD_TOL / 10
    for name, got, want in zip(GRADS, grads, ref.ssd_scan_bwd(*leaves, chunk=128)):
        assert _err(got, want[0].double()) < SSD_TOL / 10, name


@pytest.mark.parametrize("way", ["3xtf32", "3xtf32-rna", "f32"])
def test_f32_accurate_products_hold_the_tolerance(case, way):
    (x, a, b, c, dy), y64, grads64 = case
    y, states = kernel_forward(x, a, b, c, PRODUCTS[way])
    assert _err(y, y64) < SSD_TOL / 10
    got_grads = kernel_backward(x, a, b, c, dy, states, PRODUCTS[way])
    for name, got, want in zip(GRADS, got_grads, grads64):
        assert _err(got, want) < SSD_TOL / 10, name


def test_tf32_products_miss_the_tolerance(case):
    """Rounded once to TF32, the products leave the forward and every
    gradient beyond 1e-4 of its largest magnitude."""
    (x, a, b, c, dy), y64, grads64 = case
    y, states = kernel_forward(x, a, b, c, mm_tf32)
    assert _err(y, y64) > SSD_TOL
    for name, got, want in zip(GRADS, kernel_backward(x, a, b, c, dy, states, mm_tf32), grads64):
        assert _err(got, want) > SSD_TOL, name


def test_plain_chunked_form_matches_the_jax_reference():
    """The yardstick above, ``ref.ssd_scan_chunked``, against the JAX
    package's plain chunked form on the same inputs (one sequence, f32)."""
    x, a, b, c, _ = _inputs(S=256, H=2)
    got = ref.ssd_scan_chunked(x, a, b, c, chunk=64)
    want = jref.ssd_scan_chunked(*(jnp.asarray(t.numpy()) for t in (x, a, b, c)), chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
