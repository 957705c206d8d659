"""The norm backwards' plan and summation order, on the CPU.

``csrc/norm.cuh``'s backward runs in two passes: pass 1
(``norm_bwd_kernel``) gives each block a contiguous range of rows, its
teams interleaved in it, and sums dy * xh (and dy) for a thread's columns
across its team's rows in f32 registers; the block adds its teams' sums in
team order into one partial row.  Pass 2 (``partial_reduce_kernel``)
splits the partial rows among a block's warps in contiguous ranges, sums
each range in order, then the ranges in order.  The launch is pure Python
(``norms.norm_bwd_plan``); this file pins its invariants over a sweep of
shapes and SM counts, and replays dw's and db's summation order in numpy
f32 at the main paths' shapes, held to the f64 sums at the card's
tolerance (``TRAIN_TOL`` in ``chip_smoke.py``).  The same arithmetic at a
small shape is held to ``jax.vjp`` of the JAX package's plain norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import common as pcommon
from repro_torch.kernels import norms as pnorms

TRAIN_TOL_F32 = (1e-4, 1e-4)  # chip_smoke.py TRAIN_TOL[f32]: rtol, atol of the largest magnitude
EPS = 1e-6


def _plan(rows, cols, sms=132, x_itemsize=2, w_itemsize=4, nr=1):
    return pnorms._norm_bwd_plan(
        rows, cols, sms, pnorms.BWD_BLOCKS_PER_SM, x_itemsize, w_itemsize, nr
    )


def _team_rows(rows, plan):
    """{(block, team): [rows in walk order]}, as norm_bwd_kernel walks them."""
    _, teams, blocks, per, _, _ = plan
    walk = {}
    for blk in range(blocks):
        r1 = min(rows, (blk + 1) * per)
        for team in range(teams):
            walk[blk, team] = list(range(blk * per + team, r1, teams))
    return walk


@pytest.mark.parametrize("sms", [1, 16, 132, 144])
@pytest.mark.parametrize("cols", [1, 64, 768, 776, 1001, 1536, 5120, 6144, 6152, 20000, 28672, 57344])
@pytest.mark.parametrize("rows", [1, 3, 7, 100, 1000, 8192, 32768, 100000])
def test_bwd_plan_invariants(rows, cols, sms):
    """A block within 256 threads and a team within 8 warps; every row in
    exactly one team's walk; shared memory within the card's, for every
    width the wrapper takes, every dtype and either alignment, the rows'
    vectors held but at the widest rows; at most BWD_BLOCKS_PER_SM partial rows an
    SM, and pass 2's threads sum at most BWD_SUM_VALUES of them."""
    for nr in (1, 2):
        if nr * cols > pnorms.MAX_BWD_COLS:
            continue
        for x_itemsize, w_itemsize in ((2, 4), (2, 2), (4, 4), (4, 2)):
            plan = _plan(rows, cols, sms, x_itemsize, w_itemsize, nr)
            warps, teams, blocks, per, hold, splits = plan
            assert 1 <= warps <= pnorms.NORM_MAX_WARPS and teams >= 1
            assert teams * 32 * warps <= pnorms.NORM_BLOCK
            assert warps == pnorms.NORM_MAX_WARPS or cols <= pnorms.NORM_HELD * 32 * warps
            assert per % teams == 0
            assert blocks * per >= rows and (blocks - 1) * per < rows  # no block without rows
            assert hold == 1 or nr * cols * 4 > pnorms.MAX_SMEM // 2
            assert blocks <= max(1, pnorms.BWD_BLOCKS_PER_SM * sms)
            assert 1 <= splits <= pnorms.BWD_MAX_SPLITS
            if blocks <= pnorms.BWD_SUM_VALUES * pnorms.BWD_MAX_SPLITS:
                assert -(-blocks // splits) <= pnorms.BWD_SUM_VALUES
            for aligned in (True, False):
                smem = pnorms.bwd_smem(
                    cols, warps, teams, nr, x_itemsize, w_itemsize, hold, aligned
                )
                assert smem <= pnorms.MAX_SMEM - pnorms.BWD_STATIC_SMEM, (nr, x_itemsize, aligned, smem)
    if rows <= 1000:
        walked = sorted(r for walk in _team_rows(rows, _plan(rows, cols, sms)).values() for r in walk)
        assert walked == list(range(rows))


@pytest.mark.parametrize(
    "rows, cols, x_itemsize, nr, plan",
    [
        (8192, 5120, 2, 1, (7, 1, 256, 32, 1, 16)),  # qwen2.5-14b's train step
        (32768, 1536, 2, 1, (2, 4, 256, 128, 1, 16)),  # mamba2-130m's inner norm
        (32768, 768, 2, 1, (1, 8, 256, 128, 1, 16)),  # mamba2-130m's ln1 and final norm
        (8192, 6144, 2, 2, (8, 1, 256, 32, 1, 16)),  # granite-20b's train step
        (32768, 6144, 2, 2, (8, 1, 263, 125, 1, 17)),
        (8192, 5120, 4, 1, (7, 1, 256, 32, 1, 16)),  # the f32 headlines
        (8192, 6144, 4, 2, (8, 1, 256, 32, 1, 16)),
        (3, 1001, 4, 1, (2, 4, 1, 4, 1, 1)),
        (2, 57344, 4, 1, (8, 1, 2, 1, 0, 1)),  # the widest rows: none held
        (2, 28672, 2, 2, (8, 1, 2, 1, 0, 1)),
        (2, 20000, 4, 1, (8, 1, 2, 1, 1, 1)),
    ],
)
def test_bwd_plan_at_the_paths_shapes(monkeypatch, rows, cols, x_itemsize, nr, plan):
    """The launch on the H100 (132 SMs) at the main paths' shapes (w in
    f32): a few hundred blocks, each a partial row; the rows held; pass 2
    at most 16 values a thread."""
    monkeypatch.setitem(pcommon._SM_COUNT, 0, 132)
    got = pnorms.norm_bwd_plan(rows, cols, torch.device("cuda", 0), x_itemsize, 4, nr)
    assert got == plan


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    u = a.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _row_grads(x, w, dy, centred):
    """The kernel's row arithmetic in f32: (dx, dy * xh) for rows x, dy."""
    n = np.float32(x.shape[-1])
    mean = (x.sum(-1, keepdims=True) / n) if centred else np.float32(0)
    g = dy * w
    mean_g = (g.sum(-1, keepdims=True) / n) if centred else np.float32(0)
    d = x - mean
    rstd = 1 / np.sqrt((d * d).sum(-1, keepdims=True) / n + np.float32(EPS))
    mean_gxh = (g * d).sum(-1, keepdims=True) * rstd / n
    xh = d * rstd
    return rstd * (g - mean_g - xh * mean_gxh), dy * xh


def _pass1(terms, plan):
    """Pass 1's partial rows (f32) of whole blocks' rows of terms: each
    thread sums its team's rows in walk order, the block its teams in team
    order."""
    _, teams, _, per, _, _ = plan
    cols = terms.shape[1]
    blocks = -(-terms.shape[0] // per)
    padded = np.zeros((blocks * per, cols), np.float32)  # + 0 is exact
    padded[: terms.shape[0]] = terms
    walk = padded.reshape(blocks, per // teams, teams, cols)
    acc = np.zeros((blocks, teams, cols), np.float32)
    for k in range(per // teams):
        acc += walk[:, k]
    part = np.zeros((blocks, cols), np.float32)
    for team in range(teams):
        part += acc[:, team]
    return part


def _pass2(part, plan):
    """Pass 2: a warp's contiguous range of partial rows in order, then
    the ranges in order."""
    blocks, splits = plan[2], plan[5]
    assert part.shape[0] == blocks
    q = -(-blocks // splits)
    ranges = np.zeros((splits * q, part.shape[1]), np.float32)
    ranges[:blocks] = part
    ranges = ranges.reshape(splits, q, -1)
    sums = np.zeros(ranges.shape[::2], np.float32)
    for k in range(q):
        sums += ranges[:, k]
    total = np.zeros(part.shape[1], np.float32)
    for s in range(splits):
        total += sums[s]
    return total


def _kernel_order_sum(terms, plan):
    """Column sums of terms (rows, cols) in f32, in the kernels' order."""
    return _pass2(_pass1(terms, plan), plan)


def _assert_close(got, want, what):
    rtol, scale = TRAIN_TOL_F32
    atol = scale * np.abs(want).max()
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= atol + rtol * np.abs(want)), (what, err.max(), atol)


@pytest.mark.parametrize(
    "rows, cols, centred",
    [(32768, 1536, False), (8192, 6144, True)],
    ids=["rmsnorm-mamba2-inner", "layernorm-granite"],
)
def test_dw_db_summation_order_holds_the_f64_sums(rows, cols, centred):
    """dw (and db) summed in f32 in the kernels' order, at the main paths'
    shapes with inputs drawn as chip_smoke draws them (bf16 x and dy N(0,
    1), f32 w 1 + 0.3 N(0, 1)), against the f64 sums over rows of the
    gradient computed in f64."""
    plan = _plan(rows, cols, nr=2 if centred else 1)
    per = plan[3]
    rng = np.random.default_rng(0)
    w = (1 + 0.3 * rng.standard_normal(cols)).astype(np.float32)
    parts_dw, parts_db = [], []
    want_dw, want_db = np.zeros(cols), np.zeros(cols)
    step = per * max(1, 4096 // per)  # whole blocks at a time: bounded memory
    for r in range(0, rows, step):
        n = min(step, rows - r)
        x = _bf16(rng.standard_normal((n, cols), dtype=np.float32))
        dy = _bf16(rng.standard_normal((n, cols), dtype=np.float32))
        parts_dw.append(_pass1(_row_grads(x, w, dy, centred)[1], plan))
        parts_db.append(_pass1(dy, plan))
        x64 = x.astype(np.float64)
        d = x64 - (x64.mean(-1, keepdims=True) if centred else 0)
        want_dw += (dy * (d / np.sqrt((d * d).mean(-1, keepdims=True) + EPS))).sum(0)
        want_db += dy.astype(np.float64).sum(0)
    _assert_close(_pass2(np.concatenate(parts_dw), plan), want_dw, "dw")
    if centred:
        _assert_close(_pass2(np.concatenate(parts_db), plan), want_db, "db")


@pytest.mark.parametrize("centred", [False, True], ids=["rmsnorm", "layernorm"])
@pytest.mark.parametrize("shape", [(300, 776), (1000, 768), (37, 1001)])
def test_kernel_arithmetic_matches_jax_grad(centred, shape):
    """The kernels' arithmetic (the row gradient in f32, dw and db in their
    summation order) against ``jax.vjp`` of the JAX package's plain norm
    in f32, at the card's f32 tolerance."""
    rows, cols = shape
    rng = np.random.default_rng(1)
    x = (1 + rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(cols)).astype(np.float32)
    b = (0.3 * rng.standard_normal(cols)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    plan = _plan(rows, cols, nr=2 if centred else 1)
    dx, terms = _row_grads(x, w, dy, centred)
    got = [dx, _kernel_order_sum(terms, plan), _kernel_order_sum(dy, plan)]
    if centred:
        _, vjp = jax.vjp(jref.layernorm, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    else:
        _, vjp = jax.vjp(jref.rmsnorm, jnp.asarray(x), jnp.asarray(w))
    want = [np.asarray(g, np.float64) for g in vjp(jnp.asarray(dy))]
    for name, g, wt in zip(("dx", "dw", "db"), got, want):
        _assert_close(g, wt, name)
