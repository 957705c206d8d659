"""The port's grid-stride schedule and cooperative waves on ``vmap``.

``schedule='grid_stride'`` runs waves of ``n_resident`` blocks over the
grid; wave *i* holds the ids of row *i* of the table a
``chunk=n_resident`` chunked launch walks, so the two schedules must be
bitwise equal, across both backends and both warp planes, with atomics,
a partial last wave and a dim3 grid.  A cooperative (grid-sync) kernel
runs each phase as one all-resident wave, or pages its blocks' carried
state through grid-stride waves; both must equal the port's oracle.
Every launch is also held against the reference's launch with the same
knobs on the same arrays: bitwise, but for saxpy, whose ``2.5 * x + y``
XLA contracts into a fused multiply-add while eager torch rounds twice
(rtol = atol = 1e-5, as ``FMA_KERNELS``).

The footprint verdict that picks the schedule for ``schedule='auto'``
(``costmodel``), its budget override, the resolved knobs' provenance and
the cooperative residency rules are pinned against the reference's.
A grid-stride launch captured into a graph replays bitwise its eager
launch, and the dispatcher's telemetry rows record the schedule and its
provenance, as in the reference (the runtime services, ROADMAP A.9.2).
The cases of ``tests/test_grid_stride.py`` and ``tests/test_grid_sync.py``
that need a mesh (the placed multi-device case over 4 ranks, the
one-device-mesh ``gridReduce``) run in ``tests/test_torch_multidevice.py``;
the two autotune cases run in ``tests/test_torch_autotune.py``.
"""

import numpy as np
import pytest

from repro.core import costmodel as rcostmodel
from repro.core import runtime as rruntime
from repro_torch.core import costmodel, oracle, runtime
from repro_torch.core.backends.plan import DEFAULT_CHUNK, LaunchPlan
from repro_torch.core.types import COOP_MAX_RESIDENT_BLOCKS, CoxUnsupported
from torch_suite import annot, assert_same, both, define, on_both, pairs

SUITE = pairs("port_kernels_suite_grid_stride")


def _saxpy(c, out, x, y, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


def _saxpy2d(c, out, x, y, n):
    # CUDA's 2-D grid idiom: blockIdx linearized x-fastest
    b = c.block_idx("x") + c.grid_dim("x") * c.block_idx("y")
    i = b * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


def _carried(c, out, scratch, a):
    # v is loaded before the sync and read after it: carried per thread
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    v = a[i] * 2.0
    scratch[i] = v
    c.grid_sync()
    w = scratch[(i + 64) % 256]
    out[i] = v + w


def _atomic_sync(c, hist, flags, data, n):
    # atomics before the sync, reads of the settled totals after it
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, data[i], 1.0)
    c.grid_sync()
    if i < 64:
        flags[i] = 1.0 if hist[i] > 8.0 else 0.0


SAXPY = define(_saxpy, annot(out="f", x="f", y="f", n="n"))
SAXPY2D = define(_saxpy2d, annot(out="f", x="f", y="f", n="n"))
CARRIED = define(_carried, annot(out="f", scratch="f", a="f"))
ATOMIC_SYNC = define(_atomic_sync, annot(hist="f", flags="f", data="i", n="n"))
SHAPES = {"out": (256,), "x": (256,), "y": (256,)}


def _saxpy_args(grid, block, seed=0):
    n = grid * block
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return (np.zeros(n, np.float32), x, y, n)


def _suite(name, **kw):
    """A suite kernel through the port and the reference, knobs ``kw``."""
    r, p, args = SUITE[name]
    return both((r.kernel, p.kernel), grid=p.grid, block=p.block, args=args, **kw)


# ---------------------------------------------------------------------------
# grid-stride == chunked, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_stride_matches_chunked_bitwise(backend, warp_exec):
    # grid 10, n_resident 3: four waves, the last with one live slot
    kw = dict(grid=10, block=64, args=_saxpy_args(10, 64), backend=backend, warp_exec=warp_exec)
    want, _ = both(SAXPY, chunk=3, **kw)
    got, ref = both(SAXPY, schedule="grid_stride", n_resident=3, **kw)
    assert_same(got, want, "saxpy")
    assert_same(got, ref, "saxpy", tolerant=True)


@pytest.mark.parametrize("backend", ["scan", "vmap"])
def test_stride_atomics_match(backend):
    want, _ = _suite("histogram64", backend=backend)
    got, ref = _suite("histogram64", backend=backend, schedule="grid_stride", n_resident=5)
    assert_same(got, want, "histogram64")
    assert_same(got, ref, "histogram64")
    assert got["hist"].sum() == SUITE["histogram64"][2][2]


def test_stride_partial_last_wave():
    # grid 7, n_resident 4: the second wave has three live slots
    kw = dict(grid=7, block=32, args=_saxpy_args(7, 32, seed=2), backend="vmap")
    want, _ = both(SAXPY, **kw)
    got, ref = both(SAXPY, schedule="grid_stride", n_resident=4, **kw)
    assert_same(got, want, "saxpy")
    assert_same(got, ref, "saxpy", tolerant=True)


def test_stride_dim3_grid():
    # (5, 2) is 10 blocks, strided 3 at a time across both grid rows
    args = _saxpy_args(10, 64)
    kw = dict(grid=(5, 2), block=64, args=args, backend="vmap")
    want, _ = both(SAXPY2D, chunk=3, **kw)
    got, ref = both(SAXPY2D, schedule="grid_stride", n_resident=3, **kw)
    assert_same(got, want, "saxpy2d")
    assert_same(got, ref, "saxpy2d", tolerant=True)
    np.testing.assert_allclose(
        want["out"], np.float32(2.5) * args[1] + args[2], rtol=1e-5, atol=1e-6
    )


# ---------------------------------------------------------------------------
# cooperative launches: all-resident waves and grid-stride paging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_grid_reduce_bitwise_matches_oracle(backend, warp_exec):
    r, p, args = SUITE["gridReduce"]
    want = oracle.run_grid(p.kernel.ir, grid=p.grid, block=p.block, args=args)
    got, ref = _suite("gridReduce", backend=backend, warp_exec=warp_exec)
    assert_same(got, want, "gridReduce")
    assert_same(got, ref, "gridReduce")
    assert got["total"][0] == np.asarray(args[2])[: args[3]].sum()


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize("n_resident", [3, 8])
def test_stride_cooperative_pages_blocks_through_phases(backend, n_resident):
    # all waves of phase p complete before phase p+1; each block's
    # carried state pages in and out of the resident wave
    want, _ = _suite("gridReduce", backend=backend)
    got, ref = _suite(
        "gridReduce", backend=backend, schedule="grid_stride", n_resident=n_resident
    )
    assert_same(got, want, "gridReduce")
    assert_same(got, ref, "gridReduce")
    assert got["total"][0] == got["partial"].sum()


@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_carried_locals_cross_the_sync(warp_exec):
    a = np.random.default_rng(3).normal(size=256).astype(np.float32)
    args = (np.zeros(256, np.float32), np.zeros(256, np.float32), a)
    want = oracle.run_grid(CARRIED[1].ir, grid=4, block=64, args=args)
    got, ref = both(CARRIED, grid=4, block=64, args=args, backend="vmap", warp_exec=warp_exec)
    assert_same(got, want, "carried")
    assert_same(got, ref, "carried")
    # phase 1 reads another block's phase-0 write: the barrier's guarantee
    np.testing.assert_array_equal(got["out"], a * 2.0 + np.roll(a * 2.0, -64))


def test_atomics_settle_at_the_phase_boundary():
    data = np.random.default_rng(5).integers(0, 64, size=600).astype(np.int32)
    args = (np.zeros(64, np.float32), np.zeros(64, np.float32), data, 600)
    want = oracle.run_grid(ATOMIC_SYNC[1].ir, grid=6, block=128, args=args)
    for kw in ({"backend": "vmap"}, {"backend": "vmap", "schedule": "grid_stride", "n_resident": 4}):
        got, ref = both(ATOMIC_SYNC, grid=6, block=128, args=args, **kw)
        assert_same(got, want, "atomic_sync")
        assert_same(got, ref, "atomic_sync")


def test_resident_capacity_enforced_when_chunked_pinned():
    r, p, args = SUITE["gridReduce"]
    with pytest.raises(CoxUnsupported, match="resident capacity"):
        p.kernel.launch(
            grid=COOP_MAX_RESIDENT_BLOCKS + 1,
            block=p.block,
            args=args,
            schedule="chunked",
            device="cpu",
        )


def test_resident_capacity_lowers_to_grid_stride():
    r, p, _ = SUITE["gridReduce"]
    grid = COOP_MAX_RESIDENT_BLOCKS + 1
    got = runtime.resolve_launch(p.kernel.compiled(collapse="hier"), grid=grid, block=p.block)
    want = rruntime.resolve_launch(r.kernel.compiled(collapse="hier"), grid=grid, block=r.block)
    assert (got.schedule, got.schedule_source, got.n_resident, got.chunk) == (
        "grid_stride",
        "cooperative",
        COOP_MAX_RESIDENT_BLOCKS,
        COOP_MAX_RESIDENT_BLOCKS,
    )
    assert (got.schedule, got.schedule_source, got.n_resident, got.chunk) == (
        want.schedule,
        want.schedule_source,
        want.n_resident,
        want.chunk,
    )


def test_explicit_chunk_that_splits_the_grid_rejected():
    _, p, args = SUITE["gridReduce"]
    with pytest.raises(CoxUnsupported, match="resident per"):
        p.kernel.launch(
            grid=p.grid, block=p.block, args=args, backend="vmap", chunk=3, device="cpu"
        )


def test_coop_plan_pins_chunk_to_the_grid():
    ck = SUITE["gridReduce"][1].kernel.compiled(collapse="hier")
    plan = LaunchPlan.build(ck, grid=8, block=128)
    assert (plan.n_phases, plan.chunk) == (2, 8)
    assert plan.chunked_bids().shape == (1, 8)
    with pytest.raises(CoxUnsupported, match="n_resident"):
        LaunchPlan.build(
            ck,
            grid=COOP_MAX_RESIDENT_BLOCKS + 8,
            block=128,
            schedule="grid_stride",
            n_resident=COOP_MAX_RESIDENT_BLOCKS + 1,
        )


# ---------------------------------------------------------------------------
# the footprint verdict and the resolved schedule
# ---------------------------------------------------------------------------


def _resolved(grid, *, budget=None, shapes=SHAPES, **kw):
    """The port's and the reference's resolved launch of saxpy."""
    got = runtime.resolve_launch(SAXPY[1].compiled(block=64), grid=grid, block=64, **kw)
    want = rruntime.resolve_launch(SAXPY[0].compiled(block=64), grid=grid, block=64, **kw)
    got = runtime.resolve_schedule(SAXPY[1].compiled(block=64), got, shapes, budget=budget)
    want = rruntime.resolve_schedule(SAXPY[0].compiled(block=64), want, shapes, budget=budget)
    return got, want


def _knobs(rl):
    return (rl.backend, rl.chunk, rl.chunk_source, rl.schedule, rl.n_resident, rl.schedule_source)


def test_oversubscribed_grid_never_materializes_table_over_budget(monkeypatch):
    budget = 64 << 10
    monkeypatch.setenv(costmodel.ENV_BUDGET, str(budget))
    grid = 1 << 20
    got, want = _resolved(grid)
    assert _knobs(got) == _knobs(want)
    assert (got.schedule, got.schedule_source) == ("grid_stride", "heuristic")
    ck = SAXPY[1].compiled(block=64)
    assert (
        costmodel.stride_footprint(
            ck, SHAPES, n_resident=got.n_resident, n_warps=got.n_warps, warp_exec=got.warp_exec
        )
        <= budget
    )
    for chunk in costmodel.RESIDENT_CANDIDATES:
        assert costmodel.bid_table_bytes(grid, chunk) > budget
    plan = LaunchPlan.build(
        ck,
        grid=grid,
        block=64,
        chunk=got.chunk,
        warp_exec=got.warp_exec,
        schedule=got.schedule,
        n_resident=got.n_resident,
    )
    assert plan.chunk == plan.n_resident == got.n_resident
    assert plan.n_stride_waves() == -(-grid // got.n_resident)


def test_oversubscribed_launch_runs_and_matches(monkeypatch):
    backend = "vmap"
    grid, block = 16, 64
    args = _saxpy_args(grid, block, seed=6)
    want, _ = both(SAXPY, grid=grid, block=block, args=args, backend=backend)
    monkeypatch.setenv(costmodel.ENV_BUDGET, "64")
    shapes = {"out": (grid * block,), "x": (grid * block,), "y": (grid * block,)}
    got_rl, want_rl = _resolved(grid, shapes=shapes, backend=backend)
    assert _knobs(got_rl) == _knobs(want_rl)
    assert (got_rl.schedule, got_rl.schedule_source) == ("grid_stride", "heuristic")
    got, ref = both(SAXPY, grid=grid, block=block, args=args, backend=backend)
    assert_same(got, want, "saxpy")
    assert_same(got, ref, "saxpy", tolerant=True)


def test_scan_verdict_keys_on_the_bid_sequence_alone():
    ck = SAXPY[1].compiled(block=64)
    kw = dict(chunk=DEFAULT_CHUNK, n_warps=2, backend="scan", budget=64 << 10)
    assert costmodel.schedule_verdict(ck, SHAPES, grid=1 << 20, **kw) == ("grid_stride", 1)
    assert costmodel.schedule_verdict(ck, SHAPES, grid=64, **kw) == ("chunked", None)


@pytest.mark.parametrize("grid", [16, 4096, 1 << 20])
@pytest.mark.parametrize("budget", [64, 4 << 10, 64 << 20])
@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_footprint_model_matches_the_reference(grid, budget, warp_exec):
    ckp = SUITE["MatrixMulCUDA"][1].kernel.compiled(collapse="hier")
    ckr = SUITE["MatrixMulCUDA"][0].kernel.compiled(collapse="hier")
    shapes = {"out": (320, 320), "a": (320, 320), "b": (320, 320)}
    kw = dict(grid=grid, chunk=DEFAULT_CHUNK, n_warps=8, warp_exec=warp_exec, budget=budget)
    assert costmodel.schedule_verdict(ckp, shapes, **kw) == rcostmodel.schedule_verdict(
        ckr, shapes, **kw
    )
    fp = dict(chunk=8, n_warps=8, warp_exec=warp_exec, grid=grid)
    assert costmodel.chunk_footprint(ckp, shapes, **fp) == rcostmodel.chunk_footprint(
        ckr, shapes, **fp
    )
    assert costmodel.kernel_features(ckp) == rcostmodel.kernel_features(ckr)


def test_explicit_schedule_is_never_overridden(monkeypatch):
    monkeypatch.setenv(costmodel.ENV_BUDGET, "64")
    for kw in ({"schedule": "chunked"}, {"chunk": 4}):
        got, want = _resolved(16, backend="vmap", **kw)
        assert _knobs(got) == _knobs(want)
        assert got.schedule == "chunked"
    assert got.chunk_source == "explicit"


def test_n_resident_implies_grid_stride():
    got, want = _resolved(10, n_resident=3)
    assert _knobs(got) == _knobs(want)
    assert (got.schedule, got.schedule_source, got.n_resident) == (
        "grid_stride",
        "explicit",
        3,
    )
    with pytest.raises(ValueError, match="n_resident"):
        runtime.resolve_launch(
            SAXPY[1].compiled(block=64), grid=10, block=64, schedule="chunked", n_resident=3
        )


def test_explicit_grid_stride_without_width_gets_the_sized_wave():
    got, want = _resolved(10, backend="vmap", schedule="grid_stride")
    assert _knobs(got) == _knobs(want)
    assert got.schedule == "grid_stride" and 1 <= got.n_resident <= 10


def test_budget_env_validation(monkeypatch):
    monkeypatch.delenv(costmodel.ENV_BUDGET, raising=False)
    assert costmodel.footprint_budget() == costmodel.FOOTPRINT_BUDGET
    monkeypatch.setenv(costmodel.ENV_BUDGET, "1048576")
    assert costmodel.footprint_budget() == 1048576
    monkeypatch.setenv(costmodel.ENV_BUDGET, "lots")
    with pytest.raises(ValueError, match="integer byte count"):
        costmodel.footprint_budget()
    for bad in ("0", "-3"):
        monkeypatch.setenv(costmodel.ENV_BUDGET, bad)
        with pytest.raises(ValueError, match="positive"):
            costmodel.footprint_budget()
    monkeypatch.setenv(costmodel.ENV_BUDGET, "  ")
    assert costmodel.footprint_budget() == costmodel.FOOTPRINT_BUDGET


def test_stride_graph_replay_bitwise_equals_eager():
    """A captured grid-stride launch replays bitwise its eager launch, on
    both packages, and the port's replay is the reference's (saxpy: rtol
    = atol = 1e-5, the fused multiply-add)."""

    def scenario(side):
        d, s, _ = side.fresh()
        args = _saxpy_args(10, 64, seed=4)
        kw = dict(backend="vmap", schedule="grid_stride", n_resident=3)
        want = np.asarray(s.launch(side.k(SAXPY), grid=10, block=64, args=args, **kw).result()["out"])
        g = side.cox.Graph()
        with g.capture(s):
            s.launch(side.k(SAXPY), grid=10, block=64, args=args, **kw)
        res = np.asarray(g.replay()["out"])
        np.testing.assert_array_equal(res, want)
        np.testing.assert_array_equal(np.asarray(g.replay()["out"]), res)
        return res

    ref, port = on_both(scenario)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)


def test_telemetry_records_schedule_and_provenance():
    """Telemetry rows carry each launch's schedule, wave width and
    provenance; ``health`` counts the schedules; the same rows as the
    reference's."""

    def scenario(side):
        d, s, _ = side.fresh()
        args = _saxpy_args(10, 64, seed=8)
        s.launch(side.k(SAXPY), grid=10, block=64, args=args, backend="vmap",
                 schedule="grid_stride", n_resident=3).result()
        s.launch(side.k(SAXPY), grid=10, block=64, args=args, backend="vmap").result()
        by_sched = {r["schedule"]: r for r in d.telemetry() if r["kernel"] == "_saxpy"}
        assert "grid_stride" in by_sched and "chunked" in by_sched
        gs = by_sched["grid_stride"]
        assert gs["n_resident"] == 3 and gs["schedule_source"] == "explicit"
        assert by_sched["chunked"]["n_resident"] is None
        health = d.health()
        assert health["schedules"]["grid_stride"] >= 1 and health["schedules"]["chunked"] >= 1
        keys = ("schedule", "n_resident", "schedule_source", "chunk", "chunk_source", "launches",
                "op_estimate", "mem_estimate", "estimate_source")
        return {k: {f: r[f] for f in keys} for k, r in by_sched.items()}, health["schedules"]

    ref, port = on_both(scenario)
    assert port == ref
