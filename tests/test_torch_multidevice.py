"""COX on a pool of devices: the port's sharded backend and stream
placement against the JAX package's.

* **Sharded launches over several ranks.**  The reference's cases run on
  8 (or 4) XLA host devices in a subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count=N``, as its own
  tests do); the port's run on 8 (or 4) gloo ranks on the host, each a
  process making the same launch with a ``DeviceMesh`` over the world
  (``tests/torch_multidevice_worker.py``).  A module-scoped fixture
  starts all four worlds at once and gathers every case's result, so
  the file pays for one spawn; every process has a timeout of its own,
  and a rank that fails or hangs fails the tests of its world.  Every
  rank's globals are held **bitwise** to the reference's ``shard_map``
  launch and to the oracle: ``vec_madd``, the ``histogram`` atomics and
  the cooperative ``gridReduce`` at 8 ranks, the grid-stride
  ``vec_madd`` over grid 10 at 4 (stripes 3/3/3/1); and the merge's
  numeric corners: a stored ``-0.0`` (the numeric sum returns ``+0.0``
  over several devices), float atomic deltas whose sum depends on the
  order of summation, u32 deltas that wrap modulo 2**32.
* **One rank** (a gloo group opened in this process and destroyed after
  each case): the sharded graph replay, ``gridReduce`` on a one-device
  mesh, the ``-0.0`` store at one device, the mesh refusals and the
  stage key of a mesh made again.
* **A pool of four logical devices** on the host
  (``device_pool(4, logical=True, device_type="cpu")``): the four
  multi-device cases of ``tests/test_placement.py``, each result bitwise
  the reference's on its four host devices.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multidevice_worker as W
from benchmarks import kernels_suite
from repro.core import cox as rcox
from repro.core.backends.plan import LaunchPlan as RPlan
from repro.core.streams import Dispatcher as RDispatcher
from repro_torch.core import cox as pcox
from repro_torch.core import oracle
from repro_torch.core.backends.plan import LaunchPlan as PPlan
from repro_torch.core.streams import Dispatcher
from repro_torch.launch.mesh import device_pool
from torch_suite import one_rank_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(pathlib.Path(__file__).with_name("torch_multidevice_worker.py"))
SPAWN_TIMEOUT_S = 180

RK = W.kernels(rcox)
PK = W.kernels(pcox)
RK["gridReduce"] = W.grid_reduce(kernels_suite).kernel
PK["gridReduce"] = W.grid_reduce(W.port_suite()).kernel
CPU = torch.device("cpu")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the reference's 8- and 4-device processes and the port's 8
    and 4 gloo ranks together; return ``{world: (dir, failures)}``."""
    procs = []
    dirs = {}
    for n in (8, 4):
        d = tmp_path_factory.mktemp(f"world{n}")
        dirs[n] = d
        flags = f"--xla_force_host_platform_device_count={n}"
        cmd = [sys.executable, WORKER, "ref", "--devices", str(n), "--out", str(d)]
        procs.append((n, "reference", cmd, _env(XLA_FLAGS=flags)))
        for r in range(n):
            cmd = [sys.executable, WORKER, "rank", "--rank", str(r), "--world", str(n), "--out", str(d)]
            procs.append((n, f"rank {r}", cmd, _env()))
    running = []
    for n, what, cmd, env in procs:
        log = open(dirs[n] / f"{what.replace(' ', '')}.log", "w+")
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        running.append((n, what, p, log))
    failures = {8: [], 4: []}
    for n, what, p, log in running:
        try:
            rc = p.wait(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, _, q, _ in running:
                q.kill()
            rc = "timeout"
        if rc != 0:
            log.seek(0)
            failures[n].append(f"{what} ({rc}):\n{log.read()[-3000:]}")
        log.close()
    return {n: (dirs[n], failures[n]) for n in dirs}


def _results(worlds, world, case):
    """``(every rank's globals, the reference's, its single-device
    launch)`` of one case; fails when a process of the world failed."""
    d, failures = worlds[world]
    assert not failures, "\n".join(failures)
    ranks = [dict(np.load(d / f"{case}.rank{r}.npz")) for r in range(world)]
    ref = dict(np.load(d / f"{case}.ref.npz"))
    single = dict(np.load(d / f"{case}.single.npz"))
    return ranks, ref, single


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def assert_bitwise(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert same_bits(got[k], want[k]), f"{what}.{k}: {np.asarray(got[k])[:8]} != {np.asarray(want[k])[:8]}"


def _np(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items()}


def _port_scan(case):
    kname, grid, block, args, _ = W.case_args(case)
    return _np(PK[kname].launch(grid=grid, block=block, args=args, device="cpu", backend="scan"))


def _oracle(case):
    kname, grid, block, args, _ = W.case_args(case)
    return oracle.run_grid(PK[kname].ir, grid=grid, block=block, args=args)


# ---------------------------------------------------------------------------
# several ranks: tests/test_multidevice.py and tests/test_grid_stride.py
# ---------------------------------------------------------------------------


def test_cox_grid_sharded_matches_single(worlds):
    """``vec_madd`` dealt over 8 ranks: every rank's globals are the
    reference's 8-device launch, the single-device launch and the
    oracle, bit for bit."""
    ranks, ref, single = _results(worlds, 8, "vec_madd")
    assert_bitwise(ref, single, "reference sharded vs single")
    want = _oracle("vec_madd")
    for r, got in enumerate(ranks):
        assert_bitwise(got, ref, f"rank {r}")
        assert_bitwise(got, _port_scan("vec_madd"), f"rank {r} vs the port's scan")
        assert same_bits(got["out"], want["out"]), r


def test_cox_atomics_psum_merge(worlds):
    """The histogram's atomic deltas summed across 8 ranks."""
    ranks, ref, _ = _results(worlds, 8, "histogram")
    _, _, (_, data, _), _ = W.case_args("histogram")[1:]
    want = np.bincount(data, minlength=16).astype(np.float32)
    for r, got in enumerate(ranks):
        assert_bitwise(got, ref, f"rank {r}")
        assert same_bits(got["hist"], want), r


def test_cox_grid_sync_sharded_8dev(worlds):
    """Cooperative ``gridReduce`` over 8 ranks, one block each: the
    merge at the phase boundary lets a phase-1 block read the phase-0
    partials of every rank."""
    ranks, ref, _ = _results(worlds, 8, "gridReduce")
    want = _oracle("gridReduce")
    for r, got in enumerate(ranks):
        assert_bitwise(got, ref, f"rank {r}")
        for k in want:
            assert same_bits(got[k], want[k]), (r, k)
    data = W.case_args("gridReduce")[3][2]
    assert ranks[0]["total"][0] == data.sum()


def test_stride_placed_multi_device_bitwise(worlds):
    """Grid-stride waves of 2 over 4 ranks, grid 10: each rank strides
    its own stripe (3/3/3/1 blocks) and the merge gives the
    single-device launch exactly."""
    ranks, ref, single = _results(worlds, 4, "stride")
    assert_bitwise(ref, single, "reference sharded vs single")
    for r, got in enumerate(ranks):
        assert_bitwise(got, ref, f"rank {r}")
        assert_bitwise(got, _port_scan("stride"), f"rank {r} vs the port's scan")


@pytest.mark.parametrize("case", ["neg_zero", "neg_zero_atomic", "float_order", "u32_wrap"])
def test_cross_device_merge_numerics(worlds, case):
    """The merge's numeric corners at 8 ranks, each bitwise the
    reference's ``psum``: a stored ``-0.0`` comes back ``+0.0`` (the
    masked sum starts from ``+0.0``) while untouched ``-0.0`` stays;
    float deltas are summed from ``+0.0`` in mesh order (the data is
    chosen so that another order rounds differently); u32 deltas wrap
    modulo 2**32."""
    ranks, ref, single = _results(worlds, 8, case)
    for r, got in enumerate(ranks):
        assert_bitwise(got, ref, f"rank {r}")
    got = ranks[0]
    _, _, args, _ = W.case_args(case)[1:]
    if case.startswith("neg_zero"):
        a, out0 = args[-2], args[0]
        stored_zero = np.arange(512) < 500
        stored_zero &= a == 0
        assert not np.signbit(got["out"][stored_zero]).any()
        assert np.signbit(single["out"][stored_zero]).all()  # one device keeps the sign
        # untouched elements keep their -0.0, unless the kernel has atomics:
        # then every array takes the (zero) delta sum, as in the reference
        assert same_bits(got["out"][500:], out0[500:]) == (case == "neg_zero")
        assert np.signbit(got["out"][500:]).all() == (case == "neg_zero")
    elif case == "float_order":
        vals = args[1].reshape(8, 4).astype(np.float32)
        acc = np.zeros(4, np.float32)
        for row in vals:
            acc = (acc + row).astype(np.float32)
        assert same_bits(got["acc"], acc)
        rev = np.zeros(4, np.float32)
        for row in vals[::-1]:
            rev = (rev + row).astype(np.float32)
        assert not same_bits(rev, acc), "the data must make the order of summation visible"
    else:
        x = args[1].astype(np.uint64)
        total = np.array([x[i::4].sum() for i in range(4)], np.uint64)
        assert (total >= 2**32).all()
        assert same_bits(got["acc"], (total % 2**32).astype(np.uint32))


def test_counted_cost_of_a_sharded_launch(worlds):
    """``costmodel.estimate(mode="xla")`` of vec_madd's sharded launch on
    4 gloo ranks no longer falls back to the static walk: it is counted
    (``source == "xla"``), and ``coll_estimate`` is the result bytes of
    the launch's one merge, the ``all_gather`` of every rank's packed
    copy (41,024 bytes: 4 ranks x 10,256), the same on every rank and
    what the launch itself gathers.  The reference's record of the same
    launch on 4 XLA host devices says 0: its merge is a ``psum``, and its
    record takes ``coll_estimate`` from the HLO parse only where XLA's
    cost analysis comes back empty, which it does not here.  The two
    differ by design (ROADMAP C.3)."""
    d, failures = worlds[4]
    assert not failures, "\n".join(failures)
    ports = [dict(np.load(d / f"coll_cost.rank{r}.npz")) for r in range(4)]
    ref = dict(np.load(d / "coll_cost.ref.npz"))
    for p in ports:
        assert str(p["source"]) == "xla" and float(p["ops"]) > 0
        assert float(p["coll"]) == float(p["gathered"]) == 41024.0
    assert str(ref["source"]) == "xla" and float(ref["coll"]) == 0.0


@pytest.mark.parametrize("grid,ndev,chunk", [(8, 8, 8), (10, 4, 2), (10, 4, 3), (3, 8, 1), (100, 3, 8), (7, 2, 4)])
def test_device_bid_table_matches_reference(grid, ndev, chunk):
    """The round-robin-contiguous deal and the per-device grid-stride
    waves (``stride_bids(base=, limit=)``) equal the reference's."""
    rp = RPlan.build(RK["vec_madd"].compiled(block=32), grid=grid, block=32, chunk=chunk)
    pp = PPlan.build(PK["vec_madd"].compiled(block=32), grid=grid, block=32, chunk=chunk)
    assert same_bits(pp.device_bid_table(ndev), rp.device_bid_table(ndev))
    rs = RPlan.build(RK["vec_madd"].compiled(block=32), grid=grid, block=32, schedule="grid_stride", n_resident=chunk)
    ps = PPlan.build(PK["vec_madd"].compiled(block=32), grid=grid, block=32, schedule="grid_stride", n_resident=chunk)
    per = -(-grid // ndev)
    for d in range(ndev):
        base, limit = d * per, min(d * per + per, grid)
        assert ps.n_stride_waves(per) == rs.n_stride_waves(per)
        for i in range(ps.n_stride_waves(per)):
            want = np.asarray(rs.stride_bids(i, base=base, limit=limit))
            assert same_bits(ps.stride_bids(i, base=base, limit=limit), want), (d, i)


# ---------------------------------------------------------------------------
# one rank: tests/test_graphs.py:132, tests/test_grid_sync.py:49
# ---------------------------------------------------------------------------


def _ref_mesh():
    import jax

    return jax.make_mesh((1,), ("data",))


def test_replay_bitwise_equals_eager_sharded():
    """A sharded launch captured on a stream replays bitwise its eager
    launch, in both packages, and the port's equals the reference's."""
    _, grid, block, args, _ = W.case_args("vec_madd")

    def scenario(cox, kern, mesh):
        d = Dispatcher(devices=[CPU]) if cox is pcox else RDispatcher()
        s = cox.Stream("a", d)
        kw = dict(mesh=mesh, backend="sharded")
        want = _np(s.launch(kern, grid=grid, block=block, args=args, **kw).result())
        g = cox.Graph()
        with g.capture(s):
            s.launch(kern, grid=grid, block=block, args=args, **kw)
        got = _np(g.replay())
        assert_bitwise(got, {k: want[k] for k in got}, "replay vs eager")
        return got

    ref = scenario(rcox, RK["vec_madd"], _ref_mesh())
    with one_rank_mesh() as mesh:
        got = scenario(pcox, PK["vec_madd"], mesh)
    assert_bitwise(got, ref, "port vs reference")


@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_grid_reduce_sharded_one_device_mesh(warp_exec):
    """``gridReduce`` on a one-device mesh is its scan launch, in both
    packages, bitwise one another."""
    _, grid, block, args, _ = W.case_args("gridReduce")
    rk, pk = RK["gridReduce"], PK["gridReduce"]
    rwant = _np(rk.launch(grid=grid, block=block, args=args, backend="scan", warp_exec="serial"))
    rgot = _np(rk.launch(grid=grid, block=block, args=args, mesh=_ref_mesh(), warp_exec=warp_exec))
    assert_bitwise(rgot, rwant, "reference")
    pwant = _np(pk.launch(grid=grid, block=block, args=args, backend="scan", warp_exec="serial", device="cpu"))
    with one_rank_mesh() as mesh:
        pgot = _np(pk.launch(grid=grid, block=block, args=args, mesh=mesh, warp_exec=warp_exec))
    assert_bitwise(pgot, pwant, "port")
    assert_bitwise(pgot, rgot, "port vs reference")


@pytest.mark.parametrize("case", ["neg_zero", "neg_zero_atomic"])
def test_neg_zero_store_on_one_device(case):
    """At one device the reference's ``psum`` is the identity: a stored
    ``-0.0`` keeps its sign, unless the kernel has atomics, whose (zero)
    delta sum turns it into ``+0.0``.  The port gives the same bits."""
    kname, grid, block, args, _ = W.case_args(case)
    ref = _np(RK[kname].launch(grid=grid, block=block, args=args, mesh=_ref_mesh()))
    with one_rank_mesh() as mesh:
        got = _np(PK[kname].launch(grid=grid, block=block, args=args, mesh=mesh))
    assert_bitwise(got, ref, case)
    zeros = (np.arange(512) < 500) & (args[-2] == 0)
    assert np.signbit(got["out"][zeros]).all() == (case == "neg_zero")


def test_mesh_refusals_and_stage_key():
    """A mesh that is not a ``DeviceMesh``, an axis it does not name, or
    a process group that is gone raises; it never runs as one device.
    Two launches on one mesh share a staged runner; a mesh made again
    over a new group stages its own."""
    k = PK["vec_madd"]
    kname, grid, block, args, _ = W.case_args("vec_madd")
    with pytest.raises(TypeError, match="DeviceMesh"):
        k.launch(grid=grid, block=block, args=args, mesh=object())
    with one_rank_mesh() as mesh:
        with pytest.raises(ValueError, match="axis 'model'"):
            k.launch(grid=grid, block=block, args=args, mesh=mesh, axis="model")
        k.launch(grid=grid, block=block, args=args, mesh=mesh)
        n1 = len(k._launch_cache)
        k.launch(grid=grid, block=block, args=args, mesh=mesh)
        assert len(k._launch_cache) == n1
    with pytest.raises(RuntimeError, match="not initialized"):
        k.launch(grid=grid, block=block, args=args, mesh=mesh)
    with one_rank_mesh() as mesh2:
        out = k.launch(grid=grid, block=block, args=args, mesh=mesh2)
        assert len(k._launch_cache) == n1 + 1
    assert same_bits(out["out"].numpy(), _port_scan("vec_madd")["out"])


def test_meshes_over_the_world():
    """``launch/mesh.py`` over a world of one rank: the host mesh clamps
    to it as the reference's clamps to its devices, the production mesh
    needs its 256 ranks, and a mesh's pool is this rank's device."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(device_type="cpu")
    with one_rank_mesh() as mesh:
        host = make_host_mesh(2, 4, device_type="cpu")
        assert host.mesh_dim_names == ("data", "model") and tuple(host.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="512 ranks"):
            make_production_mesh(multi_pod=True, device_type="cpu")
        assert device_pool(mesh=mesh) == (CPU,)
        got = PK["vec_madd"].launch(grid=8, block=256, args=W.case_args("vec_madd")[3], mesh=host)
    assert same_bits(got["out"].numpy(), _port_scan("vec_madd")["out"])


# ---------------------------------------------------------------------------
# a pool of four logical devices: tests/test_placement.py:58, :91, :114, :155
# ---------------------------------------------------------------------------

GRID, BLOCK = 8, 256
N = GRID * BLOCK


def _pool_args():
    rng = np.random.default_rng(0)
    x = rng.normal(size=N).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    return np.zeros(N, np.float32), x, y, N


@pytest.fixture(scope="module")
def ref_pool(worlds):
    d, failures = worlds[4]
    assert not failures, "\n".join(failures)
    return dict(np.load(d / "pool.ref.npz"))


def _pool():
    return device_pool(4, logical=True, device_type="cpu")


def test_round_robin_spread_and_bitwise_equality(ref_pool):
    """Four streams over four logical devices: each its own device, kept
    on the next round; every (backend, warp_exec) cell bitwise the
    reference's placed launches."""
    args = _pool_args()
    k = PK["vec_madd"]
    d = Dispatcher(devices=_pool())
    streams = [pcox.Stream(f"s{i}", dispatcher=d) for i in range(4)]
    for backend, we in [("scan", "serial"), ("scan", "batched"), ("vmap", "serial"), ("vmap", "batched")]:
        hs = [s.launch(k, grid=GRID, block=BLOCK, args=args, backend=backend, warp_exec=we) for s in streams]
        got = np.stack([h.result()["out"].numpy() for h in hs])
        assert same_bits(got, ref_pool[f"spread_{backend}_{we}"]), (backend, we)
        assert same_bits(got[0], ref_pool["unplaced"])
    devs = [s.device for s in streams]
    assert len({str(dv) for dv in devs}) == 4 and set(devs) == set(d.devices)
    used = {name for name, c in d.device_health().items() if c["dispatches"] > 0}
    assert used == {str(dv) for dv in devs}
    for h in [s.launch(k, grid=GRID, block=BLOCK, args=args) for s in streams]:
        h.result()
    assert [s.device for s in streams] == devs


def test_cross_device_event_and_data_edges(ref_pool):
    """Producer pinned to logical device 0, consumer to 1: the event edge
    orders them, the consumer reads the producer's output, and the
    result is the reference's cross-device chain.  One physical device
    holds both, so the launch's own copy of its inputs is the transfer
    and no tensor is copied between devices."""
    o, x, y, n = _pool_args()
    k = PK["vec_madd"]
    d = Dispatcher(devices=_pool())
    dev0, dev1 = d.devices[0], d.devices[1]
    s0 = pcox.Stream("prod", dispatcher=d, device=dev0)
    s1 = pcox.Stream("cons", dispatcher=d, device=dev1)
    h0 = s0.launch(k, grid=GRID, block=BLOCK, args=(o, x, y, n))
    ev = s0.record_event()
    s1.wait_event(ev)
    h1 = s1.launch(k, grid=GRID, block=BLOCK, args=(o, h0.outputs["out"], y, n))
    out = h1.result()["out"]
    assert h1.request.device == dev1 and h0.request.device == dev0
    assert h0.request.seq in h1.request.deps
    assert d.transfers == 0 and out.device == CPU
    assert same_bits(out.numpy(), ref_pool["edge"])
    np.testing.assert_allclose(out.numpy(), 2.0 * (2.0 * x + y) + y, rtol=1e-6)


def test_health_aware_routing_and_device_reset():
    """A sticky fault poisons one logical device: placement routes new
    work around it, the poisoned stream re-places, and
    ``device_reset(device=)`` restores that device alone."""
    o, x, y, n = args = _pool_args()
    k = PK["vec_madd"]
    want = k.launch(grid=GRID, block=BLOCK, args=args, device="cpu")["out"]
    d = Dispatcher(devices=_pool(), placement=pcox.HealthAwarePlacement())
    s = pcox.Stream("victim", dispatcher=d)
    with pcox.faults.inject("_vec_madd", site="sticky-device", times=1):
        h = s.launch(k, grid=GRID, block=BLOCK, args=args)
        with pytest.raises(pcox.CoxDeviceError):
            h.result()
    bad = s.device
    health = d.health()
    assert list(health["sticky_devices"]) == [str(bad)]
    assert health["devices"][str(bad)]["failures"] == 1
    others = [pcox.Stream(f"n{i}", dispatcher=d) for i in range(6)]
    for h2 in [st.launch(k, grid=GRID, block=BLOCK, args=args) for st in others]:
        assert same_bits(h2.result()["out"].numpy(), want.numpy())
    assert all(st.device != bad for st in others)
    assert len({st.device for st in others}) == 3
    s.launch(k, grid=GRID, block=BLOCK, args=args).result()
    assert s.device != bad
    d.device_reset(device=bad)
    assert d.health()["sticky_devices"] == {}
    pcox.Stream("fresh", dispatcher=d).launch(k, grid=GRID, block=BLOCK, args=args).result()


def test_graph_replay_on_placed_device(ref_pool):
    """A graph captured on a stream pinned to logical device 2 replays
    there, bitwise its eager chain and the reference's replay."""
    o, x, y, n = args = _pool_args()
    k = PK["vec_madd"]
    d = Dispatcher(devices=_pool())
    dev2 = d.devices[2]
    s = pcox.Stream("gcap", dispatcher=d, device=dev2)
    g = pcox.Graph(name="placed-chain")
    with g.capture(s):
        h = s.launch(k, grid=GRID, block=BLOCK, args=args)
        s.launch(k, grid=GRID, block=BLOCK, args=(o, h.outputs["out"], y, n))
    exe = g.instantiate()
    assert exe.device is dev2
    out = exe.replay()["out"]
    he = s.launch(k, grid=GRID, block=BLOCK, args=args)
    he2 = s.launch(k, grid=GRID, block=BLOCK, args=(o, he.outputs["out"], y, n))
    assert same_bits(out.numpy(), he2.result()["out"].numpy())
    assert same_bits(out.numpy(), ref_pool["graph"])
    assert d.device_health()[str(dev2)]["dispatches"] >= 3
