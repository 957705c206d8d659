"""The port's block-parallel execution: vmap == scan, batched == serial.

Every runnable kernel of ``benchmarks/kernels_suite.py`` runs through the
port on ``device="cpu"`` with inputs drawn once.  The port's ``vmap``
backend (chunk 3, so most grids end in a ragged wave) and its batched
``(n_warps, W)`` warp plane must equal the port's serial ``scan`` launch
bitwise -- stores are single-writer selected, and the suite's atomics
are integer-valued, so their delta sums are exact -- and the reference's
``vmap`` launch on the same arrays: bitwise, but for the kernels in
``FMA_KERNELS`` (rtol = atol = 1e-5), where XLA contracts ``a * b + c``
and eager torch rounds twice.  One reference launch a kernel is enough:
the reference's own suite holds its vmap, scan and batched paths bitwise
equal.

The rest follows ``tests/test_backends.py``: chunk sizes, atomics with
stores, the partial last warp, the store log's classification, the
``auto`` heuristics and the resolved knobs against the reference's, the
chunk table, and the refusals of atomic old-value capture.  Kernels
whose blocks or warps take different branches pin the per-copy program
counters, and a unit test pins the bit-exact writer selection.
"""

import numpy as np
import pytest
import torch

from repro.core import runtime as rruntime
from repro.core.execute import _pr_plan as ref_pr_plan
from repro.core.regions import BlockPR as RefBlockPR
from repro_torch.core import execute, runtime
from repro_torch.core import flat as pflat
from repro_torch.core.backends import available_backends, get_backend
from repro_torch.core.backends import merge
from repro_torch.core.backends.plan import LaunchPlan
from repro_torch.core.kernel_ir import uses_grid_sync
from repro_torch.core.regions import BlockPR
from repro_torch.core.types import CoxUnsupported
from torch_suite import FMA_KERNELS, annot, as_numpy, assert_same, both, define, pairs

SUITE = pairs("port_kernels_suite_backends")
RUNNABLE = sorted(SUITE)
_REF = {}


def reference_vmap(name):
    """The reference's vmap launch (chunk 3; cooperative kernels pin
    their own) on the shared args, once a kernel."""
    if name not in _REF:
        r, _, args = SUITE[name]
        _REF[name] = as_numpy(
            r.kernel.launch(grid=r.grid, block=r.block, args=args, **_vmap_knobs(r))
        )
    return _REF[name]


def _vmap_knobs(sk):
    coop = uses_grid_sync(SUITE[sk.name][1].kernel.ir)
    return {"backend": "vmap", **({} if coop else {"chunk": 3})}


def port(name, **kw):
    _, p, args = SUITE[name]
    out = p.kernel.launch(grid=p.grid, block=p.block, args=args, device="cpu", **kw)
    return as_numpy(out)


def _port_scan(name):
    return port(name, backend="scan", warp_exec="serial")


@pytest.mark.parametrize("name", RUNNABLE)
def test_vmap_bitwise_matches_scan(name):
    r, _, _ = SUITE[name]
    got = port(name, **_vmap_knobs(r))
    assert_same(got, _port_scan(name), name)
    assert_same(got, reference_vmap(name), name, name in FMA_KERNELS)


@pytest.mark.parametrize("name", RUNNABLE)
def test_warp_batched_bitwise_matches_serial(name):
    got = port(name, backend="scan", warp_exec="batched")
    assert_same(got, _port_scan(name), name)
    assert_same(got, reference_vmap(name), name, name in FMA_KERNELS)


@pytest.mark.parametrize(
    "name", ["MatrixMulCUDA", "reduce0", "reduce4", "histogram64", "blockCounter"]
)
def test_warp_batched_composes_with_block_vmap(name):
    got = port(name, backend="vmap", chunk=3, warp_exec="batched")
    assert_same(got, _port_scan(name), name)
    assert_same(got, reference_vmap(name), name, name in FMA_KERNELS)


@pytest.mark.parametrize("chunk", [1, 2, 5, 7, 64])
def test_vmap_chunk_sizes_including_indivisible(chunk):
    got = port("histogram64", backend="vmap", chunk=chunk)  # grid 16
    np.testing.assert_array_equal(got["hist"], _port_scan("histogram64")["hist"])
    np.testing.assert_array_equal(got["hist"], reference_vmap("histogram64")["hist"])


def test_atomics_plus_stores_in_one_kernel():
    want = _port_scan("blockCounter")
    for chunk in (3, 8):
        got = port("blockCounter", backend="vmap", chunk=chunk)
        assert_same(got, want, "blockCounter")
        assert_same(got, reference_vmap("blockCounter"), "blockCounter")
    assert want["total"][0] == 900


# ---------------------------------------------------------------------------
# kernels defined in both packages
# ---------------------------------------------------------------------------


def _warpstage(c, out, a):
    # shared memory + warp collective + block barrier + cross-warp reads
    tile = c.shared((4,))
    tid = c.thread_idx()
    v = a[c.block_idx() * c.block_dim() + tid]
    s = c.red_add(v)
    if c.lane_id() == 0:
        tile[c.warp_id()] = s
    c.syncthreads()
    t = tile[tid % 4]
    out[c.block_idx() * c.block_dim() + tid] = v + t


def _warpstage_partial(c, out, a, n):
    # launched at block=112: 4 warps, the last one half dead
    tile = c.shared((4,))
    tid = c.thread_idx()
    i = c.block_idx() * c.block_dim() + tid
    v = 0.0
    if i < n:
        v = a[i]
    s = c.red_add(v)
    if c.lane_id() == 0:
        tile[c.warp_id()] = s
    c.syncthreads()
    t = tile[tid % 4]
    if i < n:
        out[i] = v + t


def _store_in_while(c, out, a, n):
    # stores inside a While body take the masked path, not the log
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    j = 0
    while j < i % 5:
        out[i * 5 + j] = a[i] + c.f32(j)
        j = j + 1


def _store_then_load(c, out, acc, a):
    # a same-lane reload after a store: the array must not be logged
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    acc[i] = a[i] * 2.0
    v = acc[i]
    out[i] = v + 1.0


def _ticket(c, tickets, counter):
    if c.thread_idx() == 0:
        t = c.atomic_add_old(counter, 0, 1)
        tickets[c.block_idx()] = t


def _early_return(c, out, a):
    # blocks bid % 3 == 1 leave at a block-level peel
    tile = c.shared((64,))
    tid = c.thread_idx()
    i = c.block_idx() * c.block_dim() + tid
    if c.block_idx() % 3 == 1:
        c.syncthreads()
        return
    tile[tid] = a[i]
    c.syncthreads()
    out[i] = tile[63 - tid] + 1.0


def _bid_trips(c, out, a):
    # a block-level loop (barriers inside) whose trip count is the block id
    tile = c.shared((64,))
    tid = c.thread_idx()
    i = c.block_idx() * c.block_dim() + tid
    acc = a[i]
    t = 0
    while t < c.block_idx():
        tile[tid] = acc
        c.syncthreads()
        acc = acc + tile[(tid + 1) % 64]
        c.syncthreads()
        t = t + 1
    out[i] = acc


def _warp_trips(c, out, a):
    # a warp-level loop (a shuffle inside) whose trip count depends on
    # the block and the warp
    tid = c.thread_idx()
    i = c.block_idx() * c.block_dim() + tid
    v = a[i]
    t = 0
    while t < c.block_idx() + c.warp_id():
        s = c.shfl_down(v, 1)
        v = v + s
        t = t + 1
    out[i] = v


K_WARPSTAGE = define(_warpstage, annot(out="f", a="f"))
K_WARPSTAGE_PARTIAL = define(_warpstage_partial, annot(out="f", a="f", n="n"))
K_STORE_IN_WHILE = define(_store_in_while, annot(out="f", a="f", n="n"))
K_STORE_THEN_LOAD = define(_store_then_load, annot(out="f", acc="f", a="f"))
K_TICKET = define(_ticket, annot(tickets="i", counter="i"))
K_EARLY_RETURN = define(_early_return, annot(out="f", a="f"))
K_BID_TRIPS = define(_bid_trips, annot(out="f", a="f"))
K_WARP_TRIPS = define(_warp_trips, annot(out="f", a="f"))


@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_warp_batched_multiwarp_shared_collective_barrier(warp_exec):
    """n_warps >= 4, shared memory, warp collectives and block barriers:
    batched == serial bitwise, and auto picks batched for it."""
    rng = np.random.default_rng(3)
    a = rng.integers(-8, 9, 256).astype(np.float32)
    kw = dict(grid=2, block=128, args=(np.zeros(256, np.float32), a))
    want = as_numpy(K_WARPSTAGE[1].launch(device="cpu", warp_exec="serial", **kw))
    got, ref = both(K_WARPSTAGE, warp_exec=warp_exec, **kw)
    assert_same(got, want, "warpstage")
    assert_same(got, ref, "warpstage")
    assert pflat.choose_warp_exec(K_WARPSTAGE[1].ir, n_warps=4) == "batched"


@pytest.mark.parametrize("backend", ["scan", "vmap"])
def test_warp_batched_partial_last_warp(backend):
    rng = np.random.default_rng(4)
    n = 200  # block=112 -> 4 warps, the last half dead; the tail dead too
    a = rng.integers(-8, 9, 224).astype(np.float32)
    kw = dict(grid=2, block=112, args=(np.zeros(224, np.float32), a, n))
    want = as_numpy(K_WARPSTAGE_PARTIAL[1].launch(device="cpu", warp_exec="serial", **kw))
    got, ref = both(K_WARPSTAGE_PARTIAL, backend=backend, warp_exec="batched", **kw)
    assert_same(got, want, "warpstage_partial")
    assert_same(got, ref, "warpstage_partial")


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize(
    "kernels,make",
    [
        (
            K_STORE_IN_WHILE,
            lambda rng: (
                np.zeros(1280, np.float32),
                rng.normal(size=256).astype(np.float32),
                1280,
            ),
        ),
        (
            K_STORE_THEN_LOAD,
            lambda rng: (
                np.zeros(128, np.float32),
                np.zeros(128, np.float32),
                rng.normal(size=128).astype(np.float32),
            ),
        ),
    ],
    ids=["store-in-while", "store-then-load"],
)
def test_store_log_ineligible_paths_stay_exact(kernels, make, backend):
    args = make(np.random.default_rng(9))
    kw = dict(grid=4, block=64, args=args)
    want = as_numpy(kernels[1].launch(device="cpu", warp_exec="serial", **kw))
    got, ref = both(kernels, backend=backend, warp_exec="batched", **kw)
    assert_same(got, want, kernels[1].name)
    assert_same(got, ref, kernels[1].name)


@pytest.mark.parametrize("kernels", [K_STORE_THEN_LOAD, K_STORE_IN_WHILE], ids=["load", "while"])
def test_pr_plan_classifies_store_paths(kernels):
    """The store log's classification is the reference's, PR by PR."""
    r, p = kernels
    ck_r, ck_p = r.compiled(block=64), p.compiled(block=64)
    plans_r = [ref_pr_plan(ck_r, n) for n in ck_r.machine.nodes if isinstance(n, RefBlockPR)]
    plans_p = [
        execute._pr_plan(ck_p, n) for n in ck_p.machine.nodes if isinstance(n, BlockPR)
    ]
    assert [dataclasses_astuple(x) for x in plans_p] == [
        dataclasses_astuple(x) for x in plans_r
    ]
    logged = {a for x in plans_p for a in x.logged}
    masked = {a for x in plans_p for a in x.masked}
    if p is K_STORE_THEN_LOAD[1]:
        assert "out" in logged  # written, never read: the log
        assert "acc" in masked  # reloaded after its store: copy and mask
    else:
        assert "out" in masked and "out" not in logged  # stored in a While


def dataclasses_astuple(x):
    return (x.block_vars, x.shared, x.masked, x.atomics, x.logged)


# ---------------------------------------------------------------------------
# copies that take different branches: a program counter per copy
# ---------------------------------------------------------------------------


DIVERGENT = {
    "early-return": (K_EARLY_RETURN, 6),
    "bid-trips": (K_BID_TRIPS, 5),
    "warp-trips": (K_WARP_TRIPS, 5),
}


@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
@pytest.mark.parametrize("chunk", [2, 8])
@pytest.mark.parametrize("case", sorted(DIVERGENT))
def test_divergent_copies_match_scan_and_the_reference(case, chunk, warp_exec):
    """Blocks leave early by bid, loop as often as their bid says, or
    their warps loop as often as bid + warp id: each copy follows its
    own path, bitwise the serial launch and the reference's."""
    kernels, grid = DIVERGENT[case]
    n = grid * 64
    a = np.random.default_rng(1).integers(-4, 5, n).astype(np.float32)
    kw = dict(grid=grid, block=64, args=(np.zeros(n, np.float32), a), collapse="hier")
    want = as_numpy(kernels[1].launch(device="cpu", backend="scan", warp_exec="serial", **kw))
    got, ref = both(kernels, backend="vmap", chunk=chunk, warp_exec=warp_exec, **kw)
    assert_same(got, want, case)
    assert_same(got, ref, case)
    if case == "early-return":
        assert not got["out"].reshape(grid, 64)[1::3].any()


def test_a_peel_reads_one_flag_vector_per_wave():
    """The block-level loop of bid-trips peels once a trip: scan reads
    one flag a block a trip, a wave of 8 blocks one vector a trip."""
    kernels, grid = DIVERGENT["bid-trips"]
    a = np.ones(grid * 64, np.float32)
    kw = dict(grid=grid, block=64, args=(np.zeros_like(a), a), device="cpu")
    counts = {}
    for backend in ("scan", "vmap"):
        before = execute.host_syncs
        kernels[1].launch(backend=backend, warp_exec="serial", **kw)
        counts[backend] = execute.host_syncs - before
    # scan: bid + 1 peels for block bid; vmap: the longest block's, once
    assert counts == {"scan": sum(b + 1 for b in range(grid)), "vmap": grid}


# ---------------------------------------------------------------------------
# the merge: bit-exact writer selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64, torch.bool]
)
def test_select_writer_moves_every_bit_pattern(dtype):
    n = 6
    if dtype == torch.int64:  # u32 carried in int64
        payload = torch.tensor([0, 1, 2**31, 2**32 - 1, 12345, 7], dtype=dtype)
    elif dtype == torch.bool:
        payload = torch.tensor([True, False, True, True, False, True])
    else:
        payload = torch.tensor([-0.0, float("nan"), -1.5, 3.0, float("inf"), 1e-3])
        payload = payload.to(dtype)
        # a NaN with a payload of its own
        bits = {torch.float32: torch.int32}.get(dtype, torch.int16)
        payload.view(bits)[1] = payload.view(bits)[1] | 5
    carry = torch.zeros(n, dtype=dtype)
    copies = torch.zeros((3, n), dtype=dtype)
    masks = torch.zeros((3, n), dtype=torch.bool)
    writer = torch.tensor([0, 1, 2, 0, 1, 2])
    copies[writer, torch.arange(n)] = payload
    masks[writer, torch.arange(n)] = True
    masks[:, n - 1] = False  # nobody writes the last element: the carry stays
    merged, wrote = merge.select_writer(carry, copies, masks)
    assert merged.dtype == dtype
    assert wrote.tolist() == [True] * (n - 1) + [False]
    want = torch.cat([payload[: n - 1], carry[n - 1 :]])
    view = {torch.float32: torch.int32, torch.float16: torch.int16, torch.bfloat16: torch.int16}
    if dtype in view:
        assert torch.equal(merged.view(view[dtype]), want.view(view[dtype]))
    else:
        assert torch.equal(merged, want)


def test_merge_sums_u32_deltas_with_wraparound():
    carry = {"h": torch.tensor([2**32 - 1, 5, 0], dtype=torch.int64)}
    deltas = {"h": torch.tensor([[1, 2, 2**32 - 1], [3, 0, 2]], dtype=torch.int64)}
    g, _, dsum = merge.merge_chunk(carry, {}, {}, deltas, fold_deltas=True)
    assert dsum["h"].tolist() == [4, 2, 1]
    assert g["h"].tolist() == [3, 7, 1]


# ---------------------------------------------------------------------------
# heuristics, resolved knobs, plans and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RUNNABLE)
def test_resolve_launch_matches_the_reference(name):
    r, p, _ = SUITE[name]
    ck_r = r.kernel.compiled(block=r.block)
    ck_p = p.kernel.compiled(block=p.block)
    want = rruntime.resolve_launch(ck_r, grid=r.grid, block=r.block)
    got = runtime.resolve_launch(ck_p, grid=p.grid, block=p.block)
    fields = (
        "backend",
        "mode",
        "warp_exec",
        "n_warps",
        "chunk",
        "chunk_source",
        "schedule",
        "n_resident",
        "schedule_source",
    )
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.grid.astuple() == want.grid.astuple()


def test_auto_resolves_matrix_mul_to_vmap_and_batched_warps():
    _, p, _ = SUITE["MatrixMulCUDA"]
    rl = runtime.resolve_launch(p.kernel.compiled(collapse="hier"), grid=p.grid, block=p.block)
    assert (rl.backend, rl.warp_exec, rl.chunk, rl.schedule) == (
        "vmap",
        "batched",
        8,
        "chunked",
    )


def test_choose_warp_exec_heuristic():
    mm = SUITE["MatrixMulCUDA"][1]
    r4 = SUITE["reduce4"][1]
    ck = mm.kernel.compiled(block=mm.block)
    assert pflat.choose_warp_exec(mm.kernel.ir, n_warps=8, machine=ck.machine) == "batched"
    assert pflat.choose_warp_exec(mm.kernel.ir, n_warps=1) == "serial"
    ck4 = r4.kernel.compiled(block=r4.block)
    assert pflat.choose_warp_exec(r4.kernel.ir, n_warps=8, machine=ck4.machine) == "serial"
    assert pflat.choose_warp_exec(r4.kernel.ir, n_warps=8, requested="batched") == "batched"
    with pytest.raises(ValueError):
        pflat.choose_warp_exec(mm.kernel.ir, n_warps=8, requested="simd")


def test_choose_backend_heuristic():
    mm = SUITE["MatrixMulCUDA"][1].kernel.ir
    hist = SUITE["histogram64"][1].kernel.ir
    va = SUITE["vectorAdd"][1].kernel.ir
    assert pflat.choose_backend(va, grid=8) == "scan"  # streaming SPMD
    assert pflat.choose_backend(mm, grid=16) == "vmap"  # shared-memory tiles
    assert pflat.choose_backend(hist, grid=16) == "vmap"  # atomics
    assert pflat.choose_backend(mm, grid=1) == "scan"  # nothing to batch
    assert pflat.choose_backend(K_TICKET[1].ir, grid=8) == "scan"  # tickets


def test_backend_registry():
    from repro.core.backends import available_backends as ref_backends

    assert set(available_backends()) == set(ref_backends()) == {"scan", "vmap", "sharded"}
    with pytest.raises(ValueError):
        get_backend("pthread")


def test_launch_plan_chunking():
    ck = SUITE["vectorAdd"][1].kernel.compiled(block=64)
    plan = LaunchPlan.build(ck, grid=5, block=64, chunk=2)
    assert plan.chunked_bids().tolist() == [[0, 1], [2, 3], [4, -1]]
    stride = LaunchPlan.build(ck, grid=5, block=64, schedule="grid_stride", n_resident=2)
    assert stride.chunk == stride.n_resident == 2
    assert [stride.stride_bids(i).tolist() for i in range(stride.n_stride_waves())] == [
        [0, 1],
        [2, 3],
        [4, -1],
    ]


def test_launch_plan_requires_resolved_knobs():
    ck = SUITE["vectorAdd"][1].kernel.compiled(block=64)
    for bad in ({"mode": "auto"}, {"warp_exec": "auto"}, {"schedule": "auto"}):
        with pytest.raises(ValueError):
            LaunchPlan.build(ck, grid=2, block=64, **bad)
    plan = LaunchPlan.build(ck, grid=2, block=64)
    assert (plan.warp_exec, plan.mode, plan.chunk) == ("serial", "normal", 2)


def test_atomic_old_capture_stays_serial():
    """Captured old values are unique only under serial execution: auto
    keeps the kernel on scan and serial warps, and an explicit vmap or
    batched request raises -- at the heuristic, the plan and the block
    function -- while scan hands out the tickets 0 .. grid - 1."""
    r, p = K_TICKET
    assert pflat.choose_warp_exec(p.ir, n_warps=4) == "serial"
    with pytest.raises(CoxUnsupported):
        pflat.choose_warp_exec(p.ir, n_warps=4, requested="batched")
    ck = p.compiled(block=64)
    with pytest.raises(CoxUnsupported):
        LaunchPlan.build(ck, grid=4, block=64, warp_exec="batched")
    with pytest.raises(CoxUnsupported):
        execute.make_block_fn(ck, n_warps=2, warp_exec="batched")
    args = (np.full(8, -1, np.int32), np.zeros(1, np.int32))
    got, want = both(K_TICKET, grid=8, block=32, args=args)
    assert_same(got, want, "ticket")
    assert sorted(got["tickets"].tolist()) == list(range(8))
    for kw in ({"backend": "vmap"}, {"backend": "vmap", "chunk": 1}):
        with pytest.raises(CoxUnsupported):
            p.launch(grid=8, block=32, args=args, device="cpu", **kw)
