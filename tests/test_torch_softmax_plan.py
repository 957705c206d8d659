"""The softmax kernels' plan and summation order, on the CPU.

``csrc/softmax.cu`` runs a row in one of three regimes, which the pure
Python plan ``softmax._plan`` picks: a team of warps holding the row in
registers ("rows"), a thread-block cluster whose blocks each hold a slice
("cluster"), or the same split reading x twice ("long").  This file pins
the plan's invariants over a sweep of shapes, dtypes and SM counts (with a
model of the clusters an H100 holds at once), and replays the rows and
cluster regimes' arithmetic in numpy f32 -- the rows regime's row max
first, the cluster regime's (max, sum) pairs per thread, merged by the
warp's xor tree, across warps by a xor tree and across the cluster in
rank order, then exp(x - M) / S -- held to the f64
softmax at vocabulary width and to the JAX package's Pallas kernel
(interpret mode) at a small width.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import softmax as jsm
from repro_torch.kernels import softmax as psm

VOCAB = 152064  # qwen2.5-14b's vocabulary
F32_RTOL = 1e-5  # the card tests' f32 tolerance (tests/test_torch_cuda.py SOFTMAX_TOL)


def h100_active(sms: int):
    """A model of cudaOccupancyMaxActiveClusters on an H100: SMs in GPCs
    of 16 (clusters do not span GPCs), up to two blocks of 512 threads an
    SM (the cluster kernels' registers allow two), as shared memory
    allows."""
    gpcs = max(1, sms // 16)
    per_gpc = sms // gpcs

    def active(regime: str, cluster: int, smem: int) -> int:
        bps = min(2, psm.SMEM_PER_SM // (smem + psm.STATIC_SMEM + psm.BLOCK_RESERVED))
        return gpcs * (per_gpc * bps // cluster)

    return active


def _plan(rows, cols, itemsize=4, sms=132):
    return psm._plan(rows, cols, itemsize, sms, h100_active(sms))


def _layout(cols: int, h: int, n: int) -> tuple:
    """(h, whole vectors, loose columns) of a row whose first 16-byte
    boundary lies h values in (csrc/softmax.cu row_layout)."""
    h = min(h, cols)
    nv = (cols - h) // n
    loose = [j if j < h else h + nv * n + (j - h) for j in range(cols - nv * n)]
    return h, nv, np.array(loose, dtype=np.int64)


def _units(plan: psm.SoftmaxPlan, nv: int) -> list:
    """[(v0, count, threads)]: the vectors of a row that each block of a
    cluster (or the one team of the rows regime) takes, and its threads."""
    if plan.regime == "rows":
        return [(0, nv, 32 * plan.warps)]
    per = -(-nv // plan.cluster)
    out = []
    for rank in range(plan.cluster):
        v0 = min(nv, rank * per)
        out.append((v0, min(nv, v0 + per) - v0, psm.CLUSTER_THREADS))
    return out


WIDTHS = [1, 31, 1001, 4096, 8192, 8193, 32769, VOCAB, VOCAB + 3, 462848, 462852, 2**20]


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("cols", WIDTHS)
@pytest.mark.parametrize("rows", [1, 2, 3, 64, 1000, 4096])
def test_plan_invariants(rows, cols, itemsize, sms):
    """Every column of every row in exactly one block's slice, for each
    offset of the row's first 16-byte boundary; a slice within its block's
    stage; shared memory within 227 KB a block and 228 KB an SM; at most 8
    blocks a cluster (no non-portable size); the rows regime's values a
    thread within its registers; at most one cluster a row."""
    n = 16 // itemsize
    plan = _plan(rows, cols, itemsize, sms)
    active = h100_active(sms)
    assert plan.regime in psm.REGIMES
    if plan.regime == "rows":
        assert cols <= psm.ROW_MAX_COLS
        assert 1 <= plan.warps <= psm.ROW_MAX_WARPS and plan.teams >= 1
        assert 32 * plan.warps * plan.teams <= psm.ROW_BLOCK
        rows_walked = plan.blocks * plan.teams * psm.ROW_TEAM_ROWS
        assert rows_walked >= rows and (plan.blocks - 1) * plan.teams < rows
        vpt = psm.ROW_HELD // n  # 16-byte vectors a thread holds
        # the held values in f32, the next row's vectors as loaded: within
        # the registers __launch_bounds__ leaves (2 blocks of 256 threads an
        # SM in f32, 3 in 16-bit), with 32 to spare
        regs = 65536 // (psm.ROW_BLOCK * (2 if itemsize == 4 else 3))
        assert psm.ROW_HELD + 4 * vpt <= min(255, regs) - 32
    else:
        assert cols > psm.ROW_MAX_COLS
        assert 1 <= plan.cluster <= psm.MAX_CLUSTER
        assert 1 <= plan.clusters <= rows
        assert plan.clusters <= active(plan.regime, plan.cluster, plan.smem)
        assert plan.grid % plan.cluster == 0
        if plan.regime == "cluster":
            assert plan.stages in (1, 2) and plan.smem == 16 * plan.stages * plan.slice
            # two stages only where a cluster walks several rows and two
            # blocks still share an SM
            assert plan.stages == 1 or (rows > plan.clusters and plan.smem <= psm.HALF_SM)
            assert plan.smem + psm.STATIC_SMEM <= psm.MAX_SMEM  # 227 KB a block
            # 228 KB an SM
            assert plan.smem + psm.STATIC_SMEM + psm.BLOCK_RESERVED <= psm.SMEM_PER_SM
            # two blocks an SM wherever some cluster size allows it
            slice8 = -(-(cols // n) // psm.MAX_CLUSTER)
            assert 16 * plan.slice <= psm.HALF_SM or 16 * slice8 > psm.HALF_SM
            # the least waves of rows times vectors a slice
            waves = -(-rows // active("cluster", plan.cluster, 16 * plan.slice))
            for c in range(1, psm.MAX_CLUSTER + 1):
                sl = -(-(cols // n) // c)
                if 16 * sl <= (psm.HALF_SM if 16 * plan.slice <= psm.HALF_SM else psm.MAX_SMEM):
                    assert waves * plan.slice <= -(-rows // active("cluster", c, 16 * sl)) * sl
        else:
            assert plan.smem == 0 and plan.cluster == psm.MAX_CLUSTER
            # one stage of its slice does not fit a block
            assert 16 * -(-(cols // n) // psm.MAX_CLUSTER) > psm.MAX_SMEM - psm.STATIC_SMEM
    for h in range(n):
        if h > cols:
            break
        h, nv, loose = _layout(cols, h, n)
        owner = np.zeros(cols, np.int64)
        np.add.at(owner, loose, 1)
        for v0, count, threads in _units(plan, nv):
            if plan.regime == "rows":
                assert count <= threads * (psm.ROW_HELD // n)
            elif plan.regime == "cluster":
                assert count <= plan.slice
            owner[h + v0 * n : h + (v0 + count) * n] += 1
        assert len(loose) <= 2 * n - 2 and len(loose) <= _units(plan, nv)[0][2]
        assert (owner == 1).all(), (h, np.flatnonzero(owner != 1)[:5])


@pytest.mark.parametrize(
    "rows, cols, itemsize, regime, sms_at_work",
    [
        (2, VOCAB, 4, "cluster", 16),  # the main path: the three-way phase
        (64, VOCAB, 4, "cluster", 120),  # the headline
        (64, VOCAB, 2, "cluster", 120),
        (64, VOCAB + 3, 2, "cluster", 120),
        (4096, 4096, 4, "rows", 120),
        (2, 2**20, 4, "long", 16),
    ],
)
def test_plan_fills_the_card(rows, cols, itemsize, regime, sms_at_work):
    """The main path's plan puts at least 16 SMs to work (2 rows, where the
    parent kernel used 2), the headlines' at least 120 of the 132."""
    plan = _plan(rows, cols, itemsize)
    assert plan.regime == regime
    assert min(132, plan.grid) >= sms_at_work


def test_plan_at_the_headline():
    """64 x 152,064 on the model's 132 SMs: clusters of 8 blocks, two an SM
    (32 clusters, two rows each); f32 one stage of 76,032 bytes (two would
    leave one block an SM), bf16 two of 38,016.  Where only 30 clusters of
    8 fit (the H100 of PERF.md), 64 rows take three waves and clusters of 7
    two.  The main path's 2 rows: clusters of 8, one stage."""
    f32 = _plan(64, VOCAB, 4)
    assert (f32.cluster, f32.slice, f32.stages, f32.clusters) == (8, 4752, 1, 32)
    bf16 = _plan(64, VOCAB, 2)
    assert (bf16.cluster, bf16.slice, bf16.stages, bf16.clusters) == (8, 2376, 2, 32)
    main = _plan(2, VOCAB, 4)
    assert (main.cluster, main.stages, main.clusters) == (8, 1, 2)

    def card(regime, cluster, smem):  # 30 clusters of 8 fit, 34 of 7
        return {8: 30, 7: 34, 6: 40, 5: 48}.get(cluster, 264 // cluster)

    f32 = psm._plan(64, VOCAB, 4, 132, card)
    assert (f32.cluster, f32.slice, f32.stages, f32.clusters) == (7, 5431, 1, 34)


# ---------------------------------------------------------------------------
# the rows and cluster regimes' arithmetic, replayed in numpy f32
# ---------------------------------------------------------------------------


def _ordered_sum(values) -> np.float32:
    """f32 values added first to last."""
    total = np.float32(values[0])
    for v in values[1:]:
        total = np.float32(total + v)
    return total


def _xor_tree(t: np.ndarray) -> np.ndarray:
    """Sums over the last axis (32 lanes) by the xor tree every lane runs."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        t = (t + t[..., lanes ^ off]).astype(np.float32)
    return t[..., 0]


def _rescale(s, m, M):
    """s rescaled from max m to M; a side with m = -inf keeps its s."""
    with np.errstate(invalid="ignore", over="ignore"):
        return np.where(m == -np.inf, s, s * np.exp(m - M)).astype(np.float32)


def _pairs_xor(m: np.ndarray, s: np.ndarray) -> tuple:
    """(m, s) pairs on the last axis (32 lanes) merged as every lane of a
    warp merges them: the max by a xor tree, then the rescaled sums."""
    M = np.fmax.reduce(m, axis=-1)
    return M, _xor_tree(_rescale(s, m, M[..., None]))


def _thread_rows(x: np.ndarray, h: int, plan: psm.SoftmaxPlan, n: int) -> list:
    """For each block (or team): (values, present), a row a thread, its
    values in its order: its vectors t, t + threads, ... (slot-major, then
    element), then its loose column."""
    h, nv, loose = _layout(x.size, h, n)
    out = []
    for rank, (v0, count, threads) in enumerate(_units(plan, nv)):
        slots = max(1, -(-count // threads))
        vals = np.zeros(slots * threads * n, np.float32)
        present = np.zeros(vals.size, bool)
        vals[: count * n] = x[h + v0 * n : h + (v0 + count) * n]
        present[: count * n] = True
        vals = vals.reshape(slots, threads, n).transpose(1, 0, 2).reshape(threads, -1)
        present = present.reshape(slots, threads, n).transpose(1, 0, 2).reshape(threads, -1)
        lv = np.zeros((threads, 1), np.float32)
        lp = np.zeros((threads, 1), bool)
        if rank == 0:  # loose value t on thread t, after its vectors
            lv[: len(loose), 0] = x[loose]
            lp[: len(loose), 0] = True
        out.append((np.hstack([vals, lv]), np.hstack([present, lp])))
    return out


def _ordered_sum_of_exp(vals, present, m) -> np.ndarray:
    """Each thread's sum of exp(v - m) over its values in order; a -inf
    adds 0, also where m is -inf."""
    s = np.zeros(vals.shape[0], np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for c in range(vals.shape[1]):
            v = vals[:, c]
            add = present[:, c] & (v != -np.inf)
            e = np.where(add, np.exp(v - m).astype(np.float32), np.float32(0))
            s = (s + e).astype(np.float32)
    return s


def replay(x: np.ndarray, h: int, plan: psm.SoftmaxPlan, n: int) -> np.ndarray:
    """One row's softmax (f32) as the rows or cluster regime computes it,
    for a row whose first 16-byte boundary lies h values in."""
    units = _thread_rows(x, h, plan, n)
    if plan.regime == "rows":  # the row max first, then the sums of e
        (vals, present), = units
        M = np.float32(np.fmax.reduce(x, initial=-np.inf))
        warps = _xor_tree(_ordered_sum_of_exp(vals, present, M).reshape(-1, 32))
        S = _xor_tree(np.concatenate([warps, np.zeros(32 - warps.size, np.float32)]))
    else:  # (m, s) pairs: thread, warp, block, then the blocks in rank order
        ms, ss = [], []
        for vals, present in units:
            m = np.fmax.reduce(np.where(present, vals, -np.inf), axis=1, initial=-np.inf)
            m = m.astype(np.float32)
            s = _ordered_sum_of_exp(vals, present, m)
            wm, ws = _pairs_xor(m.reshape(-1, 32), s.reshape(-1, 32))
            pad = 32 - wm.size
            bm, bs = _pairs_xor(np.concatenate([wm, np.full(pad, -np.inf, np.float32)]),
                                np.concatenate([ws, np.zeros(pad, np.float32)]))
            ms.append(bm)
            ss.append(bs)
        ms, ss = np.array(ms, np.float32), np.array(ss, np.float32)
        M = np.float32(np.fmax.reduce(ms))
        S = _ordered_sum(_rescale(ss, ms, M))
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.exp(x - M).astype(np.float32) / S).astype(np.float32)


def _f64_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    e = np.exp(x - x.max())
    return e / e.sum()


def _row_head(row: int, cols: int, itemsize: int) -> int:
    """h of row `row` of a 16-byte-aligned (rows, cols) tensor."""
    a = row * cols * itemsize % 16
    return (16 - a) % 16 // itemsize


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("cols", [VOCAB, VOCAB + 3])
@pytest.mark.parametrize("rows", [2, 64])
def test_replay_holds_the_f64_softmax_at_vocabulary_width(rows, cols, itemsize):
    """The plan's combination order at 152,064 and 152,067 (rows on and
    off the 16-byte boundary), inputs as chip_smoke draws them (3 N(0, 1)),
    against the f64 softmax at the f32 tolerance, entry by entry."""
    plan = _plan(rows, cols, itemsize)
    assert plan.regime == "cluster"
    rng = np.random.default_rng(0)
    for row in range(2):
        x = (3 * rng.standard_normal(cols)).astype(np.float32)
        h = _row_head(row, cols, itemsize)
        got = replay(x, h, plan, 16 // itemsize)
        np.testing.assert_allclose(got, _f64_softmax(x), rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize(
    "shape, cluster",
    [((8, 1001), None), ((5, 4096), None), ((4, 9001), None), ((4, 9001), 4), ((3, 20000), 8)],
)
def test_replay_matches_the_pallas_kernel(shape, cluster):
    """At small widths the replay (the plan's regime, or a cluster of a
    forced size) against the JAX package's Pallas kernel in interpret
    mode, f32, at the f32 tolerance; rows take each offset of the boundary."""
    rows, cols = shape
    plan = _plan(rows, cols, 4)
    if cluster is not None:
        plan = psm.SoftmaxPlan("cluster", cluster=cluster, clusters=1, stages=1,
                               slice=-(-(cols // 4) // cluster))
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jsm.softmax(jnp.asarray(x), interpret=True))
    for row in range(rows):
        got = replay(x[row], _row_head(row, cols, 4), plan, 4)
        np.testing.assert_allclose(got, want[row], rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize("h", [0, 3])
@pytest.mark.parametrize("rank", [0, 3, 7])
def test_replay_a_slice_all_minus_inf(rank, h):
    """A block whose whole slice is -inf (and, for rank 0, its loose
    columns) adds 0: its outputs are 0, the others the softmax of the rest."""
    plan = _plan(2, VOCAB, 4)
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal(VOCAB)).astype(np.float32)
    _, nv, loose = _layout(VOCAB, h, 4)
    v0, count, _ = _units(plan, nv)[rank]
    masked = np.zeros(VOCAB, bool)
    masked[h + v0 * 4 : h + (v0 + count) * 4] = True
    if rank == 0:
        masked[loose] = True
    x[masked] = -np.inf
    got = replay(x, h, plan, 4)
    assert (got[masked] == 0).all()
    np.testing.assert_allclose(got[~masked], _f64_softmax(x[~masked]), rtol=F32_RTOL, atol=0)


def test_replay_a_nan_in_the_last_slice_and_all_minus_inf():
    """A NaN in the last block's slice makes the whole row NaN; a row all
    -inf gives what the plain version gives (NaN: exp(-inf - -inf))."""
    plan = _plan(2, VOCAB, 4)
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal(VOCAB)).astype(np.float32)
    x[VOCAB - 5] = np.nan
    assert np.isnan(replay(x, 0, plan, 4)).all()
    with np.errstate(invalid="ignore"):
        want = np.asarray(jsm.softmax(jnp.full((1, 9001), -jnp.inf), interpret=True))[0]
    assert np.isnan(want).all()
    assert np.isnan(replay(np.full(9001, -np.inf, np.float32), 1, _plan(1, 9001), 4)).all()


def _rn32(exact: Fraction) -> np.float32:
    """An exact rational rounded to the nearest f32, ties to even."""
    c = np.float32(float(exact))
    near = [c, np.nextafter(c, np.float32(np.inf)), np.nextafter(c, np.float32(-np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.uint32)) & 1))


def test_the_division_rounds_as_ieee_division():
    """csrc/softmax.cu div_rn, replayed exactly: q = e (1 / S), its residual
    by fma, one correction by the reciprocal; for e >= S 2^-100 (below, the
    kernel divides) it equals the IEEE quotient e / S bit for bit, over
    sums S up to 2^31, significands of all ones among them."""
    rng = np.random.default_rng(4)
    for i in range(3000):
        S = np.float32(np.exp(rng.uniform(0, np.log(2.0**31))))
        if i % 7 == 0:
            S = np.nextafter(np.float32(2.0 ** rng.integers(0, 31)), np.float32(0))
        e = np.float32(1) if i % 11 == 0 else np.float32(np.exp(rng.uniform(-69, 0)))
        if e < S * np.float32(2.0**-100):  # the kernel divides
            continue
        r = np.float32(1) / S
        q = np.float32(e * r)
        res = _rn32(Fraction(float(e)) - Fraction(float(q)) * Fraction(float(S)))
        got = _rn32(Fraction(float(q)) + Fraction(float(res)) * Fraction(float(r)))
        assert got == e / S, (e, S, got, e / S)
