"""The compiler suites' cases against the port: the tuner's parity corpus.

The cases of the reference's six compiler suites -- ``test_core_basic``,
``test_core_transform``, ``test_dim3``, ``test_shared_sugar``,
``test_frontend_edges`` and ``test_core_property`` -- run on the port,
each kernel's source parsed by both packages and launched on the same
inputs.  Every case holds the port to the reference's own assertion
(bitwise where the reference asserts bitwise equality, else at its
tolerance), the port's launch to the reference's launch the same way,
and a rejected kernel to the same refusal.  The whitebox pass-pipeline
cases compare the port's collapsed machine with the reference's.

These kernels -- dim3 grids, shared-memory sugar, divergent control
flow, warp collectives -- are the ones a tuner must hold bitwise (every
measured winner computes the serial scan's semantics), so each case
that launches on the auto knobs also launches once with
``autotune=True`` on a temporary cache and must be bitwise its
heuristic launch.  The property cases keep the reference's hypothesis
settings (the ``ci`` profile of ``tests/conftest.py``; ``test_dim3``'s
own ``max_examples`` and deadlines).  The one-device-mesh case of
``test_dim3`` runs on a one-rank gloo mesh (``torch_suite.one_rank_mesh``).
"""

import numpy as np
import pytest
from hypothesis import assume, given, settings, strategies as st

from benchmarks.kernels_suite import all_kernels
from repro.core import cox as rcox
from repro.core import execute as rexecute
from repro.core import oracle as roracle
from repro.core import passes as rpasses
from repro.core import regions as rregions
from repro.core import types as rtypes
from repro_torch.core import autotune
from repro_torch.core import cox as pcox
from repro_torch.core import execute as pexecute
from repro_torch.core import oracle as poracle
from repro_torch.core import passes as ppasses
from repro_torch.core import regions as pregions
from repro_torch.core import types as ptypes
from repro_torch.core.cfg import Br as PBr
from torch_suite import one_rank_mesh, pairs

SUITE = pairs("port_kernels_suite_core_suites")
PKGS = ("reference", "port")


def annot(**kinds):
    """Annotations from one letter a parameter: f/i/u (f32/i32/u32
    arrays), n (i32 scalar), s (f32 scalar)."""

    def annotations(m):
        table = {
            "f": m.Array(m.f32),
            "i": m.Array(m.i32),
            "u": m.Array(m.u32),
            "n": m.i32,
            "s": m.f32,
        }
        return {name: table[k] for name, k in kinds.items()}

    return annotations


def define(fn, annotations, name=None):
    """One kernel body parsed by both packages: ``(reference, port)``."""
    fn.__annotations__ = annotations(rcox)
    r = rcox.kernel(fn, name=name)
    fn.__annotations__ = annotations(pcox)
    return r, pcox.kernel(fn, name=name)


def both_refuse(fn, annotations, match=None, *, compile_hier=False):
    """The kernel is refused (``CoxUnsupported``) by both frontends, or
    by both pipelines with ``compile_hier``."""
    for m in (rcox, pcox):
        fn.__annotations__ = annotations(m)
        with pytest.raises(m.CoxUnsupported, match=match):
            k = m.kernel(fn)
            if compile_hier:
                k.compiled(collapse="hier")


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(autouse=True, scope="module")
def _tuner_cache(tmp_path_factory):
    """Every tuned launch of the module on its own temporary cache."""
    mp = pytest.MonkeyPatch()
    mp.setenv(autotune.ENV_CACHE, str(tmp_path_factory.mktemp("at") / "autotune.json"))
    mp.delenv(autotune.ENV_ENABLE, raising=False)
    autotune.reset()
    yield
    autotune.reset()
    mp.undo()


def plaunch(kern, tune=True, **kw):
    """The port's launch on the CPU; a launch left on the auto backend
    and warp plane also runs tuned, bitwise the heuristic launch
    (``tune=False`` for a kernel whose blocks race, which no schedule
    contract covers)."""
    out = _np(kern.launch(device="cpu", **kw))
    if tune and "backend" not in kw and "warp_exec" not in kw and "chunk" not in kw:
        tuned = _np(kern.launch(device="cpu", autotune=True, **kw))
        assert set(tuned) == set(out)
        for k in out:
            assert tuned[k].dtype == out[k].dtype and np.array_equal(tuned[k], out[k]), k
    return out


def launch_both(pair, **kw):
    """``(port outputs, reference outputs)`` of the same launch."""
    r, p = pair
    return plaunch(p, **kw), _np(r.launch(**kw))


def assert_bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# test_core_basic: the paper's own examples end to end
# ---------------------------------------------------------------------------


def reduce_first_warp(c, out, val):
    tid = c.thread_idx()
    v = val[tid]
    if tid < 32:
        offset = 16
        while offset > 0:
            s = c.shfl_down(v, offset)
            v = v + s
            offset = offset // 2
    if tid == 0:
        out[0] = v


def vote_all_kernel(c, result):
    tx = c.thread_idx()
    p = tx % 2
    r = c.vote_all(p)
    result[tx] = c.i32(r)


def vec_add(c, out, a, b, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] + b[i]


def block_reduce_shared(c, out, val):
    tile = c.shared((256,), cox.f32)
    tid = c.thread_idx()
    tile[tid] = val[c.block_idx() * c.block_dim() + tid]
    c.syncthreads()
    s = 128
    while s > 0:
        if tid < s:
            tile[tid] = tile[tid] + tile[tid + s]
        c.syncthreads()
        s = s // 2
    if tid == 0:
        out[c.block_idx()] = tile[0]


REDUCE_FIRST_WARP = define(reduce_first_warp, annot(out="f", val="f"))
VOTE_ALL = define(vote_all_kernel, annot(result="i"))
VEC_ADD = define(vec_add, annot(out="f", a="f", b="f", n="n"))
BLOCK_REDUCE = define(block_reduce_shared, annot(out="f", val="f"))


def test_code1_reduction_matches_oracle_and_math():
    val = np.arange(128, dtype=np.float32)
    args = (np.zeros(1, np.float32), val)
    ref = poracle.run_grid(REDUCE_FIRST_WARP[1].ir, grid=1, block=128, args=args)
    assert np.allclose(ref["out"], val[:32].sum())
    got, want = launch_both(REDUCE_FIRST_WARP, grid=1, block=128, args=args)
    np.testing.assert_allclose(got["out"], ref["out"])
    assert_bitwise(got, want)


@pytest.mark.parametrize("mode", ["jit", "normal"])
@pytest.mark.parametrize("simd", [True, False])
def test_vote_all_modes(mode, simd):
    args = (np.zeros(64, np.int32),)
    ref = poracle.run_grid(VOTE_ALL[1].ir, grid=1, block=64, args=args)
    got, want = launch_both(VOTE_ALL, grid=1, block=64, args=args, mode=mode, simd=simd)
    np.testing.assert_array_equal(got["result"], ref["result"])
    assert_bitwise(got, want)


@pytest.mark.parametrize("collapse", ["flat", "hier", "hybrid"])
def test_vec_add_collapse_modes(collapse):
    n = 1000
    a = np.random.default_rng(0).normal(size=1024).astype(np.float32)
    b = np.random.default_rng(1).normal(size=1024).astype(np.float32)
    args = (np.zeros(1024, np.float32), a, b, n)
    got, want = launch_both(VEC_ADD, grid=4, block=256, args=args, collapse=collapse)
    np.testing.assert_allclose(got["out"], np.where(np.arange(1024) < n, a + b, 0))
    assert_bitwise(got, want)


def test_block_reduce_shared_matches_oracle():
    val = np.random.default_rng(2).normal(size=512).astype(np.float32)
    args = (np.zeros(2, np.float32), val)
    ref = poracle.run_grid(BLOCK_REDUCE[1].ir, grid=2, block=256, args=args)
    got, want = launch_both(BLOCK_REDUCE, grid=2, block=256, args=args)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5)
    np.testing.assert_allclose(ref["out"], val.reshape(2, 256).sum(1), rtol=1e-4)
    assert_bitwise(got, want)


def test_flat_rejects_warp_features():
    from repro.core.flat import FlatUnsupported as RFlat
    from repro_torch.core.flat import FlatUnsupported as PFlat

    args = (np.zeros(1, np.float32), np.zeros(64, np.float32))
    with pytest.raises(RFlat):
        REDUCE_FIRST_WARP[0].launch(grid=1, block=64, args=args, collapse="flat")
    with pytest.raises(PFlat):
        REDUCE_FIRST_WARP[1].launch(grid=1, block=64, args=args, collapse="flat", device="cpu")


def test_hybrid_picks_flat_for_warp_free():
    for i in (0, 1):
        assert not VEC_ADD[i].uses_warp_features()
        assert REDUCE_FIRST_WARP[i].uses_warp_features()


# ---------------------------------------------------------------------------
# test_core_transform: the pass pipeline, whitebox, port against reference
# ---------------------------------------------------------------------------


def code1(c, out, val):
    v = val[c.thread_idx()]
    if c.thread_idx() < 32:
        offset = 16
        while offset > 0:
            s = c.shfl_down(v, offset)
            v = v + s
            offset = offset // 2
    if c.thread_idx() == 0:
        out[0] = v


def fig5(c, a):
    tid = c.thread_idx()
    for i in range(12):
        a[tid] = a[tid] + 1.0
        a[tid] = a[tid] + 2.0
        c.syncthreads()
        a[tid] = a[tid] + 3.0


def warp_free(c, a):
    tid = c.thread_idx()
    if tid < 16:
        a[tid] = a[tid] * 2.0


CODE1 = define(code1, annot(out="f", val="f"))
FIG5 = define(fig5, annot(a="f"))
WARP_FREE = define(warp_free, annot(a="f"))
COMPILE = (rexecute.compile_kernel, pexecute.compile_kernel)
REGIONS = (rregions, pregions)


def _shape(ck, regions):
    """The collapsed machine's shape: per top-level node its kind, and
    for a block PR the kinds of its warp-level nodes."""
    out = []
    for n in ck.machine.nodes:
        inner = ()
        if isinstance(n, regions.BlockPR):
            inner = tuple(type(w).__name__ for w in n.warp.nodes)
        out.append((type(n).__name__, inner))
    return out


def _both_compiled(pair):
    return [COMPILE[i](pair[i].ir) for i in (0, 1)]


def test_code1_hierarchical_structure():
    shapes = []
    for ck, regions in zip(_both_compiled(CODE1), REGIONS):
        bprs = [n for n in ck.machine.nodes if isinstance(n, regions.BlockPR)]
        assert not [n for n in ck.machine.nodes if isinstance(n, regions.BlockPeel)]
        wpeels = sum(sum(isinstance(w, regions.WarpPeel) for w in n.warp.nodes) for n in bprs)
        wprs = sum(sum(isinstance(w, regions.WarpPR) for w in n.warp.nodes) for n in bprs)
        assert wpeels >= 2 and wprs >= 3
        shapes.append(_shape(ck, regions))
    assert shapes[1] == shapes[0]


def test_code1_replication_classes():
    classes = []
    for ck in _both_compiled(CODE1):
        assert ck.classes["v"] in ("warp", "block")
        assert all(v == "warp" for k, v in ck.classes.items() if k.startswith(".warpbuf"))
        classes.append(dict(ck.classes))
    assert classes[1] == classes[0]


def test_fig5_loop_barriers_make_two_prs_per_iteration():
    shapes = []
    for ck, regions in zip(_both_compiled(FIG5), REGIONS):
        assert len([n for n in ck.machine.nodes if isinstance(n, regions.BlockPR)]) >= 3
        assert len([n for n in ck.machine.nodes if isinstance(n, regions.BlockPeel)]) == 1
        shapes.append(_shape(ck, regions))
    assert shapes[1] == shapes[0]


def _barrier_positions(ck, kir):
    return sorted(
        (name, i, len(blk.instrs))
        for name, blk in ck.cfg.blocks.items()
        for i, ins in enumerate(blk.instrs)
        if isinstance(ins, kir.Barrier)
    )


def test_every_barrier_ends_its_block():
    from repro.core import kernel_ir as rkir
    from repro_torch.core import kernel_ir as pkir

    pos = []
    for ck, kir in zip(_both_compiled(CODE1), (rkir, pkir)):
        p = _barrier_positions(ck, kir)
        assert p and all(i == n - 1 for _, i, n in p)
        pos.append(p)
    assert pos[1] == pos[0]


def test_branch_blocks_are_pure():
    from repro.core.cfg import Br as RBr

    names = []
    for ck, br in zip(_both_compiled(CODE1), (RBr, PBr)):
        branches = sorted(n for n, b in ck.cfg.blocks.items() if isinstance(b.term, br))
        assert branches and all(not ck.cfg.blocks[n].instrs for n in branches)
        names.append(branches)
    assert names[1] == names[0]


def test_warp_prs_nest_inside_block_prs():
    for pair in (CODE1, FIG5, WARP_FREE):
        for ck, regions in zip(_both_compiled(pair), REGIONS):
            for node in ck.machine.nodes:
                if isinstance(node, regions.BlockPR):
                    for w in node.warp.nodes:
                        if isinstance(w, regions.WarpPR):
                            assert set(w.blocks) <= set(node.blocks)


def test_alg2_matches_constructive_partition():
    for pair in (CODE1, FIG5):
        found = []
        for ck, passes, regions, types in zip(
            _both_compiled(pair), (rpasses, ppasses), REGIONS, (rtypes, ptypes)
        ):
            alg2 = passes.find_parallel_regions_alg2(ck.cfg, types.BarrierLevel.WARP)
            alg2_blocks = set().union(*alg2) if alg2 else set()
            mine = set()
            for node in ck.machine.nodes:
                if isinstance(node, regions.BlockPR):
                    for w in node.warp.nodes:
                        if isinstance(w, regions.WarpPR):
                            mine |= set(w.blocks)
            assert alg2_blocks <= mine
            found.append(sorted(sorted(pr) for pr in alg2))
        assert found[1] == found[0]


def test_flat_uses_single_warp():
    for k in WARP_FREE:
        assert k.compiled(collapse="flat", block=64).warp_size == 64


def test_dynamic_coop_group_rejected():
    def bad(c, out):
        _g = c.coalesced_threads()

    both_refuse(bad, annot(out="f"))


def test_barrier_insertion_adds_entry_exit():
    from repro.core import kernel_ir as rkir
    from repro_torch.core import kernel_ir as pkir

    for ck, kir in zip(_both_compiled(WARP_FREE), (rkir, pkir)):
        entry = ck.cfg.blocks[ck.cfg.entry]
        assert any(isinstance(i, kir.Barrier) and i.source == "entry" for i in entry.instrs)
        exit_b = ck.cfg.blocks[ck.cfg.exit]
        assert any(isinstance(i, kir.Barrier) and i.source == "exit" for i in exit_b.instrs)


def test_warp_intrinsic_lowering_emits_raw_war():
    from repro.core import kernel_ir as rkir
    from repro_torch.core import kernel_ir as pkir

    found = []
    for ck, kir in zip(_both_compiled(CODE1), (rkir, pkir)):
        sources = sorted(
            ins.source
            for blk in ck.cfg.blocks.values()
            for ins in blk.instrs
            if isinstance(ins, kir.Barrier)
        )
        assert "raw" in sources and "war" in sources
        found.append(sources)
    assert found[1] == found[0]


# ---------------------------------------------------------------------------
# test_dim3: dim3 launch geometry end to end
# ---------------------------------------------------------------------------


def test_as_dim3_normalizes():
    for t in (rtypes, ptypes):
        as_dim3, Dim3 = t.as_dim3, t.Dim3
        assert as_dim3(5) == Dim3(5, 1, 1)
        assert as_dim3((7,)) == Dim3(7, 1, 1)
        assert as_dim3((2, 3)) == Dim3(2, 3, 1)
        assert as_dim3([2, 3, 4]) == Dim3(2, 3, 4)
        assert as_dim3(Dim3(1, 2, 3)) == Dim3(1, 2, 3)
        assert as_dim3(np.int64(6)) == Dim3(6, 1, 1)
        assert as_dim3((2, 3)).total == 6
        for bad, err in ((0, ValueError), ((4, -1), ValueError), ((1, 2, 3, 4), ValueError)):
            with pytest.raises(err):
                as_dim3(bad)
        for bad in ("x", (1.5, 2)):
            with pytest.raises(TypeError):
                as_dim3(bad)


def _k_copy(c, out, a, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i]


K_COPY = define(_k_copy, annot(out="f", a="f", n="n"))


def _copy_args(n=64):
    return (np.zeros(n, np.float32), np.ones(n, np.float32), n)


def test_cuda_launch_limits_enforced():
    for k, m, dev in ((K_COPY[0], rcox, {}), (K_COPY[1], pcox, {"device": "cpu"})):
        for grid, block in ((1, (1024, 2)), (1, (1, 1, 128)), ((1, 70000), 32)):
            with pytest.raises(m.CoxUnsupported):
                k.launch(grid=grid, block=block, args=_copy_args(), **dev)
        with pytest.raises(ValueError):
            k.launch(grid=0, block=32, args=_copy_args(), **dev)


def test_axis_argument_validation():
    def _bad_lane(c, o):
        i = c.lane_id("y")
        o[i] = 1.0

    def _bad_axis(c, o):
        i = c.thread_idx("w")
        o[i] = 1.0

    def _bad_dynamic(c, o, ax):
        i = c.thread_idx(ax)
        o[i] = 1.0

    both_refuse(_bad_lane, annot(o="f"))
    both_refuse(_bad_axis, annot(o="f"))
    both_refuse(_bad_dynamic, annot(o="f", ax="n"))


def _k_geom(c, tx, ty, tz, bx, by, bz, cnt):
    lin = c.thread_idx("x") + c.block_dim("x") * (c.thread_idx("y") + c.block_dim("y") * c.thread_idx("z"))
    blin = c.block_idx("x") + c.grid_dim("x") * (c.block_idx("y") + c.grid_dim("y") * c.block_idx("z"))
    nthreads = c.block_dim("x") * c.block_dim("y") * c.block_dim("z")
    g = blin * nthreads + lin
    tx[g] = c.thread_idx("x")
    ty[g] = c.thread_idx("y")
    tz[g] = c.thread_idx("z")
    bx[g] = c.block_idx("x")
    by[g] = c.block_idx("y")
    bz[g] = c.block_idx("z")
    cnt[g] += 1


K_GEOM = define(_k_geom, annot(tx="i", ty="i", tz="i", bx="i", by="i", bz="i", cnt="i"))


def _geom_ref(grid3, block3):
    nt, nb = block3.total, grid3.total
    t = np.arange(nt, dtype=np.int32)
    b = np.arange(nb, dtype=np.int32)
    comps = {
        "tx": t % block3.x,
        "ty": (t // block3.x) % block3.y,
        "tz": t // (block3.x * block3.y),
    }
    out = {k: np.tile(v, nb) for k, v in comps.items()}
    bcomps = {"bx": b % grid3.x, "by": (b // grid3.x) % grid3.y, "bz": b // (grid3.x * grid3.y)}
    out.update({k: np.repeat(v, nt) for k, v in bcomps.items()})
    return out


def _check_geometry(grid, block, **launch_kw):
    grid3, block3 = ptypes.as_dim3(grid), ptypes.as_dim3(block)
    n = grid3.total * block3.total
    args = tuple(np.zeros(n, np.int32) for _ in range(7))
    got, want = launch_both(K_GEOM, grid=grid, block=block, args=args, **launch_kw)
    for k, ref in _geom_ref(grid3, block3).items():
        np.testing.assert_array_equal(got[k], ref, err_msg=f"{k} @ {grid3}x{block3}")
    np.testing.assert_array_equal(got["cnt"], np.ones(n))
    assert_bitwise(got, want)


@pytest.mark.parametrize(
    "grid,block",
    [
        (2, 64),
        ((2, 2), (16, 16)),
        ((3, 2), (20, 3)),
        ((2, 1, 2), (33, 2)),
        ((1, 2, 2), (7, 5, 3)),
        ((5,), (1, 1, 64)),
    ],
)
def test_geometry_round_trip_fixed(grid, block):
    _check_geometry(grid, block)


def test_geometry_round_trip_batched_warps():
    _check_geometry((2, 2), (16, 16), warp_exec="batched")
    _check_geometry((3, 2), (20, 3), warp_exec="batched")


def _pure_round_trip(bx, by, bz, lin):
    """decompose(lin) relinearizes to lin (the executor and the oracle
    of both packages share the formula)."""
    x, y, z = lin % bx, (lin // bx) % by, lin // (bx * by)
    assert 0 <= x < bx and 0 <= y < by and 0 <= z < bz
    assert x + bx * (y + by * z) == lin


@settings(max_examples=12, deadline=None)
@given(
    gx=st.integers(1, 3),
    gy=st.integers(1, 3),
    gz=st.integers(1, 2),
    bx=st.integers(1, 40),
    by=st.integers(1, 5),
    bz=st.integers(1, 3),
)
def test_geometry_round_trip_random(gx, gy, gz, bx, by, bz):
    assume(bx * by * bz <= 128)
    _check_geometry((gx, gy, gz), (bx, by, bz))


@settings(max_examples=200, deadline=None)
@given(
    bx=st.integers(1, 64),
    by=st.integers(1, 64),
    bz=st.integers(1, 64),
    lin=st.integers(0, 1024 - 1),
)
def test_decompose_relinearize_pure(bx, by, bz, lin):
    assume(lin < bx * by * bz)
    _pure_round_trip(bx, by, bz, lin)


def test_geometry_round_trip_seeded():
    """The reference's seeded fallback of the randomized round trip."""
    rng = np.random.default_rng(1234)
    done = 0
    while done < 8:
        gx, gy, gz = rng.integers(1, 4), rng.integers(1, 4), rng.integers(1, 3)
        bx, by, bz = rng.integers(1, 41), rng.integers(1, 6), rng.integers(1, 4)
        if bx * by * bz > 128:
            continue
        _check_geometry((int(gx), int(gy), int(gz)), (int(bx), int(by), int(bz)))
        done += 1


def test_decompose_relinearize_seeded():
    rng = np.random.default_rng(99)
    done = 0
    while done < 500:
        bx, by, bz = (int(v) for v in rng.integers(1, 65, size=3))
        lin = int(rng.integers(0, 1024))
        if lin >= bx * by * bz:
            continue
        _pure_round_trip(bx, by, bz, lin)
        done += 1


def test_geom_probe_matches_oracle():
    grid, block = (2, 3), (8, 5)
    args = tuple(np.zeros(6 * 40, np.int32) for _ in range(7))
    got, want = launch_both(K_GEOM, grid=grid, block=block, args=args)
    ref = poracle.run_grid(K_GEOM[1].ir, grid=grid, block=block, args=args)
    rref = roracle.run_grid(K_GEOM[0].ir, grid=grid, block=block, args=args)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(ref[k], rref[k], err_msg=k)
    assert_bitwise(got, want)


def test_bare_intrinsics_are_axis_x():
    args = _copy_args()
    want = plaunch(K_COPY[1], grid=2, block=32, args=args)
    got = plaunch(K_COPY[1], grid=(2, 1, 1), block=(32,), args=args)
    assert_bitwise(got, want)


def _k_cache(c, out, a):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    out[i] = a[i] + 1.0


def test_cache_hits_on_equivalent_dim3():
    for k, dev in zip(define(_k_cache, annot(out="f", a="f")), ({}, {"device": "cpu"})):
        args = (np.zeros(256, np.float32), np.ones(256, np.float32))
        k.launch(grid=4, block=64, args=args, **dev)
        n1 = len(k._launch_cache)
        k.launch(grid=(4, 1, 1), block=(64,), args=args, **dev)
        assert len(k._launch_cache) == n1
        k.launch(grid=(2, 2), block=64, args=args, **dev)
        assert len(k._launch_cache) == n1 + 1


def test_cache_token_is_stable_not_object_id():
    for k, dev in zip(define(_k_cache, annot(out="f", a="f")), ({}, {"device": "cpu"})):
        k.launch(grid=1, block=64, args=(np.zeros(64, np.float32), np.ones(64, np.float32)), **dev)
        for choice, ws in {key[0] for key in k._launch_cache}:
            assert choice in ("flat", "hier") and isinstance(ws, int)


def test_resolution_is_shared_between_api_and_runtime():
    from repro.core import runtime as rruntime
    from repro_torch.core import runtime as pruntime

    rk, pk = define(_k_cache, annot(out="f", a="f"))
    args = (np.zeros(256, np.float32), np.ones(256, np.float32))
    ck = pk.compiled(block=(8, 8))
    rl = pruntime.resolve_launch(ck, grid=(2, 2), block=(8, 8))
    rrl = rruntime.resolve_launch(rk.compiled(block=(8, 8)), grid=(2, 2), block=(8, 8))
    assert rl.grid == ptypes.Dim3(2, 2, 1) and rl.block == ptypes.Dim3(8, 8, 1)
    assert rl.n_warps == -(-64 // ck.warp_size) and rl.mode in ("normal", "jit")
    assert (rl.n_warps, rl.mode, rl.backend, rl.warp_exec) == (rrl.n_warps, rrl.mode, rrl.backend, rrl.warp_exec)
    out = _np(pruntime.launch(ck, grid=(2, 2), block=(8, 8), args=args, device="cpu"))
    # the bare (x-axis) index makes blocks (x, 0) and (x, 1) store the same
    # 8 elements: a race, outside the single-writer merge contract, where a
    # tuned wave of all 4 blocks sums the two stores (2.0 + 2.0 bits: -0.0),
    # in the reference's vmap backend too; so this launch is not tuned
    want = plaunch(pk, tune=False, grid=(2, 2), block=(8, 8), args=args)
    assert_bitwise(out, want)
    plans = [p for (p, _) in pk._launch_cache.values()]
    assert any(
        p.grid == 4 and p.block == 64 and p.grid_dim == ptypes.Dim3(2, 2, 1) and p.block_dim == ptypes.Dim3(8, 8, 1)
        for p in plans
    )


_DIM3_PICKS = ["MatrixMulCUDA", "transpose", "stencil2d"]


@pytest.mark.parametrize("name", _DIM3_PICKS)
def test_dim3_kernels_all_cells_bitwise_and_oracle(name):
    r, p, args = SUITE[name]
    base = _np(p.kernel.launch(grid=p.grid, block=p.block, args=args, backend="scan", warp_exec="serial", device="cpu"))
    ref = poracle.run_grid(p.kernel.ir, grid=p.grid, block=p.block, args=args)
    for k in ref:
        np.testing.assert_allclose(
            np.asarray(base[k], np.float32), np.asarray(ref[k], np.float32), rtol=1e-4, atol=1e-4, err_msg=k
        )
    if name == "MatrixMulCUDA":  # the suite's check reads the last-drawn matrices
        assert np.allclose(base["out"], args[1] @ args[2], atol=1e-3)
    elif p.check is not None:
        assert p.check(base)
    for backend in ("scan", "vmap"):
        for we in ("serial", "batched"):
            got = _np(
                p.kernel.launch(
                    grid=p.grid, block=p.block, args=args, backend=backend, warp_exec=we, chunk=3, device="cpu"
                )
            )
            assert_bitwise(got, base)
    tuned = _np(p.kernel.launch(grid=p.grid, block=p.block, args=args, autotune=True, device="cpu"))
    assert_bitwise(tuned, base)
    want = _np(r.kernel.launch(grid=r.grid, block=r.block, args=args, backend="scan", warp_exec="serial"))
    if name == "MatrixMulCUDA":  # XLA contracts a * b + c into one fused multiply-add
        for k in want:
            np.testing.assert_allclose(base[k], want[k], rtol=1e-5, atol=1e-5)
    else:
        assert_bitwise(base, want)


@pytest.mark.parametrize("name", _DIM3_PICKS)
def test_dim3_kernels_sharded_one_device_mesh(name):
    """The reference's one-device mesh against the port's one-rank gloo
    mesh: each sharded launch is bitwise its package's scan launch, and
    the port's is the reference's (MatrixMulCUDA within the FMA
    tolerance: XLA contracts its multiply-adds)."""
    import jax

    r, p, args = SUITE[name]
    mesh = jax.make_mesh((1,), ("data",))
    want = _np(r.kernel.launch(grid=r.grid, block=r.block, args=args, backend="scan"))
    ref = _np(r.kernel.launch(grid=r.grid, block=r.block, args=args, mesh=mesh, chunk=3))
    assert_bitwise(ref, want)
    base = _np(p.kernel.launch(grid=p.grid, block=p.block, args=args, backend="scan", device="cpu"))
    with one_rank_mesh() as pmesh:
        got = _np(p.kernel.launch(grid=p.grid, block=p.block, args=args, mesh=pmesh, chunk=3))
    assert_bitwise(got, base)
    if name == "MatrixMulCUDA":
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)
    else:
        assert_bitwise(got, ref)


def test_natural_2d_matmul_equals_hand_flattened_1d():
    _, mm2, args = SUITE["MatrixMulCUDA"]
    _, mm1, _ = SUITE["matrixMul1D"]
    got2 = plaunch(mm2.kernel, grid=mm2.grid, block=mm2.block, args=args)
    got1 = plaunch(mm1.kernel, grid=mm1.grid, block=mm1.block, args=args)
    np.testing.assert_array_equal(got2["out"], got1["out"])


# ---------------------------------------------------------------------------
# test_shared_sugar: chained subscripts on shared tiles
# ---------------------------------------------------------------------------


def _transpose_chained(c, o, i, n):
    tile = c.shared((16, 17), cox.f32)
    x = c.block_idx("x") * 16 + c.thread_idx("x")
    y = c.block_idx("y") * 16 + c.thread_idx("y")
    tile[c.thread_idx("y")][c.thread_idx("x")] = i[y * n + x]
    c.syncthreads()
    o[(c.block_idx("x") * 16 + c.thread_idx("y")) * n + c.block_idx("y") * 16 + c.thread_idx("x")] = tile[
        c.thread_idx("x")
    ][c.thread_idx("y")]


def _transpose_tuple(c, o, i, n):
    tile = c.shared((16, 17), cox.f32)
    x = c.block_idx("x") * 16 + c.thread_idx("x")
    y = c.block_idx("y") * 16 + c.thread_idx("y")
    tile[c.thread_idx("y"), c.thread_idx("x")] = i[y * n + x]
    c.syncthreads()
    o[(c.block_idx("x") * 16 + c.thread_idx("y")) * n + c.block_idx("y") * 16 + c.thread_idx("x")] = tile[
        c.thread_idx("x"), c.thread_idx("y")
    ]


T_CHAINED = define(_transpose_chained, annot(o="f", i="f", n="n"))
T_TUPLE = define(_transpose_tuple, annot(o="f", i="f", n="n"))


def test_chained_equals_tuple_ir():
    reprs = [repr(T_CHAINED[i].ir.body) for i in (0, 1)]
    assert reprs == [repr(T_TUPLE[i].ir.body) for i in (0, 1)]
    assert reprs[1] == reprs[0]


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_chained_transpose_matches_tuple_and_oracle(backend, warp_exec):
    n = 64
    src = np.random.default_rng(0).standard_normal((n * n,)).astype(np.float32)
    args = (np.zeros(n * n, np.float32), src, np.int32(n))
    kw = dict(grid=(n // 16, n // 16), block=(16, 16), args=args, backend=backend, warp_exec=warp_exec)
    got, rgot = launch_both(T_CHAINED, **kw)
    want = plaunch(T_TUPLE[1], **kw)
    np.testing.assert_array_equal(got["o"], want["o"])
    np.testing.assert_array_equal(got["o"].reshape(n, n), src.reshape(n, n).T)
    ref = poracle.run_grid(T_CHAINED[1].ir, grid=(n // 16, n // 16), block=(16, 16), args=args)
    np.testing.assert_array_equal(got["o"], np.asarray(ref["o"], np.float32))
    assert_bitwise(got, rgot)


def test_chained_3d_and_augassign():
    def k3(c, o, n):
        buf = c.shared((2, 3, 4), cox.f32)
        t = c.thread_idx()
        z = t // 12
        rem = t % 12
        y = rem // 4
        x = rem % 4
        if t < 24:
            buf[z][y][x] = c.f32(t)
            buf[z][y][x] += 1.0
        c.syncthreads()
        if t < 24:
            o[t] = buf[z][y][x]

    got, want = launch_both(define(k3, annot(o="f", n="n")), grid=1, block=32, args=(np.zeros(24, np.float32), 24))
    np.testing.assert_array_equal(got["o"], np.arange(24, dtype=np.float32) + 1.0)
    assert_bitwise(got, want)


def test_chained_on_global_rejected():
    def bad(c, o, a):
        o[c.thread_idx()] = a[0][1]

    both_refuse(bad, annot(o="f", a="f"), "chained")


def test_chained_rank_mismatch_rejected():
    def bad(c, o):
        tile = c.shared((4, 4), cox.f32)
        tile[0][1][2] = 1.0
        o[0] = tile[0, 0]

    both_refuse(bad, annot(o="f"), "rank")


def test_mixed_tuple_and_chain_rejected():
    def bad(c, o):
        cube = c.shared((2, 3, 4), cox.f32)
        cube[0, 1][2] = 1.0
        o[0] = cube[0, 0, 0]

    both_refuse(bad, annot(o="f"), "mixing")


def test_linear_index_on_2d_shared_still_works():
    def lin(c, o):
        tile = c.shared((4, 4), cox.f32)
        t = c.thread_idx()
        if t < 16:
            tile[t] = c.f32(t) * 2.0
        c.syncthreads()
        if t < 16:
            o[t] = tile[t // 4][t % 4]

    got, want = launch_both(define(lin, annot(o="f")), grid=1, block=32, args=(np.zeros(16, np.float32),))
    np.testing.assert_array_equal(got["o"], np.arange(16, dtype=np.float32) * 2.0)
    assert_bitwise(got, want)


# ---------------------------------------------------------------------------
# test_frontend_edges: refusals and edge syntax
# ---------------------------------------------------------------------------


def test_break_rejected():
    def k(c, out):
        for i in range(4):
            break

    both_refuse(k, annot(out="f"), "break")


def test_scalar_param_write_rejected():
    def k(c, out, n):
        n = n + 1

    both_refuse(k, annot(out="f", n="n"), "read-only")


def test_chained_compare_rejected():
    def k(c, out, n):
        i = c.thread_idx()
        if 0 < i < n:
            out[i] = 1.0

    both_refuse(k, annot(out="f", n="n"), "chained")


def test_dynamic_tile_width_rejected():
    def k(c, out, w):
        v = out[c.thread_idx()]
        _s = c.red_add(v, width=w)

    both_refuse(k, annot(out="f", w="n"), "static")


def test_warp_call_nested_in_expression_rejected():
    def k(c, out):
        v = out[c.thread_idx()]
        out[c.thread_idx()] = c.shfl_down(v, 1) + 1.0

    both_refuse(k, annot(out="f"), "sole")


def test_return_inside_divergence_rejected():
    def k(c, out):
        if c.thread_idx() < 2:
            return
        out[c.thread_idx()] = 1.0

    both_refuse(k, annot(out="f"), compile_hier=True)


def k_ternary_boolops(c, out, a):
    i = c.thread_idx()
    v = a[i]
    r = v * 2.0 if v > 0.0 and i % 2 == 0 else -v
    out[i] = max(r, 0.5) + min(v, 0.0) + abs(v) * 0.1


def k_math(c, out, a):
    i = c.thread_idx()
    v = abs(a[i]) + 0.5
    out[i] = c.exp(c.log(v)) + c.sqrt(v) * c.rsqrt(v) + c.tanh(v) * 0.0 + c.sigmoid(v) * 0.0 + c.floor(v) * 0.0


def k_ballot(c, out, a):
    i = c.thread_idx()
    b = c.ballot(a[i] > 0)
    out[i] = b


def k_gridstride(c, out, a, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    stride = c.grid_dim() * c.block_dim()
    j = i
    while j < n:
        out[j] = a[j] + 1.0
        j = j + stride


K_TERNARY = define(k_ternary_boolops, annot(out="f", a="f"))
K_MATH = define(k_math, annot(out="f", a="f"))
K_BALLOT = define(k_ballot, annot(out="u", a="i"))
K_GRIDSTRIDE = define(k_gridstride, annot(out="f", a="f", n="n"))


def test_ternary_and_boolops_match_oracle():
    a = np.random.default_rng(5).normal(size=64).astype(np.float32)
    args = (np.zeros(64, np.float32), a)
    ref = poracle.run_grid(K_TERNARY[1].ir, grid=1, block=64, args=args)
    got, want = launch_both(K_TERNARY, grid=1, block=64, args=args)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5, atol=1e-6)


def test_math_intrinsics_match_oracle():
    a = np.random.default_rng(6).normal(size=32).astype(np.float32)
    args = (np.zeros(32, np.float32), a)
    ref = poracle.run_grid(K_MATH[1].ir, grid=1, block=32, args=args)
    got, want = launch_both(K_MATH, grid=1, block=32, args=args)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-4)


def test_ballot_bitmask():
    a = np.array([1, -1] * 16, np.int32)
    args = (np.zeros(32, np.uint32), a)
    got, want = launch_both(K_BALLOT, grid=1, block=32, args=args)
    assert (got["out"] == np.uint32(sum(1 << i for i in range(0, 32, 2)))).all()
    ref = poracle.run_grid(K_BALLOT[1].ir, grid=1, block=32, args=args)
    np.testing.assert_array_equal(got["out"], ref["out"])
    assert_bitwise(got, want)


def test_grid_stride_loop():
    n = 500
    a = np.arange(512, dtype=np.float32)
    got, want = launch_both(K_GRIDSTRIDE, grid=2, block=64, args=(np.zeros(512, np.float32), a, n))
    np.testing.assert_allclose(got["out"], np.where(np.arange(512) < n, a + 1, 0))
    assert_bitwise(got, want)


# ---------------------------------------------------------------------------
# test_core_property: the executor against the oracle on random inputs
# ---------------------------------------------------------------------------


def k_arith(c, out, a, b, alpha, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        x = a[i] * alpha + b[i]
        if x > 0.0:
            x = x * 2.0
        else:
            x = 0.0 - x
        j = 0
        while j < i % 4:
            x = x + 1.0
            j = j + 1
        out[i] = x


def k_warp_mix(c, out, a):
    tid = c.thread_idx()
    v = a[c.block_idx() * c.block_dim() + tid]
    s = c.red_add(v)
    m = c.red_max(v)
    d = c.shfl_xor(v, 1)
    anyneg = c.vote_any(v < 0.0)
    r = s + m + d + c.select(anyneg, 1.0, 0.0)
    out[c.block_idx() * c.block_dim() + tid] = r


def k_shared(c, out, a):
    tile = c.shared((64,), cox.f32)
    tid = c.thread_idx()
    tile[tid] = a[c.block_idx() * c.block_dim() + tid]
    c.syncthreads()
    out[c.block_idx() * c.block_dim() + tid] = tile[(tid + 1) % c.block_dim()]


def k_atomic(c, hist, a, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, a[i], 1.0)


K_ARITH = define(k_arith, annot(out="f", a="f", b="f", alpha="s", n="n"))
K_WARP_MIX = define(k_warp_mix, annot(out="f", a="f"))
K_SHARED = define(k_shared, annot(out="f", a="f"))
K_ATOMIC = define(k_atomic, annot(hist="f", a="i", n="n"))

floats = st.lists(st.floats(-4, 4, allow_nan=False, width=32), min_size=128, max_size=128)


@given(floats, floats, st.floats(-2, 2, allow_nan=False, width=32), st.integers(1, 128), st.sampled_from(["jit", "normal"]))
def test_arith_matches_oracle(av, bv, alpha, n, mode):
    a, b = np.asarray(av, np.float32), np.asarray(bv, np.float32)
    args = (np.zeros(128, np.float32), a, b, np.float32(alpha), n)
    ref = poracle.run_grid(K_ARITH[1].ir, grid=2, block=64, args=args)
    got, want = launch_both(K_ARITH, grid=2, block=64, args=args, mode=mode)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5, atol=1e-5)


@given(floats, st.booleans())
def test_warp_collectives_match_oracle(av, simd):
    a = np.asarray(av, np.float32)
    args = (np.zeros(128, np.float32), a)
    ref = poracle.run_grid(K_WARP_MIX[1].ir, grid=2, block=64, args=args)
    got, want = launch_both(K_WARP_MIX, grid=2, block=64, args=args, simd=simd)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-4)


@given(floats)
def test_shared_memory_rotation(av):
    a = np.asarray(av, np.float32)
    got, want = launch_both(K_SHARED, grid=2, block=64, args=(np.zeros(128, np.float32), a))
    np.testing.assert_allclose(got["out"], a.reshape(2, 64)[:, list(range(1, 64)) + [0]].reshape(-1))
    assert_bitwise(got, want)


@given(st.lists(st.integers(0, 15), min_size=96, max_size=96))
def test_atomic_histogram(idxs):
    a = np.asarray(idxs, np.int32)
    got, want = launch_both(K_ATOMIC, grid=3, block=32, args=(np.zeros(16, np.float32), a, 96))
    np.testing.assert_allclose(got["hist"], np.bincount(a, minlength=16).astype(np.float32))
    assert_bitwise(got, want)


@given(st.integers(1, 4), st.integers(1, 8))
def test_partial_last_warp(grid, rem):
    block = 32 + rem
    n = grid * block
    args = (np.zeros(n, np.float32), np.arange(n, dtype=np.float32), np.ones(n, np.float32), np.float32(1.0), n)
    ref = poracle.run_grid(K_ARITH[1].ir, grid=grid, block=block, args=args)
    got, want = launch_both(K_ARITH, grid=grid, block=block, args=args)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5)


def _make_tile_kernel(width):
    def k(c, out, a):
        tid = c.thread_idx()
        v = a[c.block_idx() * c.block_dim() + tid]
        s = c.red_add(v, width=width)
        out[c.block_idx() * c.block_dim() + tid] = s

    return define(k, annot(out="f", a="f"), name=f"tile_{width}")


_TILE_KERNELS = {w: _make_tile_kernel(w) for w in (2, 4, 8, 16, 32)}


@given(st.sampled_from([2, 4, 8, 16, 32]), floats)
def test_tile_widths(width, av):
    a = np.asarray(av, np.float32)
    pair = _TILE_KERNELS[width]
    args = (np.zeros(128, np.float32), a)
    ref = poracle.run_grid(pair[1].ir, grid=2, block=64, args=args)
    got, want = launch_both(pair, grid=2, block=64, args=args)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-4)


def test_tuned_launches_stay_on_the_cpu_cache():
    """A tuned launch of the corpus measures on the CPU and writes this
    module's temporary cache, never the default file."""
    a = np.random.default_rng(0).normal(size=1024).astype(np.float32)
    plaunch(VEC_ADD[1], grid=4, block=256, args=(np.zeros(1024, np.float32), a, a, 1000))
    assert autotune.stats()["misses"] >= 1 and autotune.cache_path() != autotune.DEFAULT_CACHE
    assert all(rec["fingerprint"].endswith("-cpu-x1") for rec in autotune.entries().values())
