"""The port's CUDA graphs (capture -> instantiate -> replay) against the
JAX package's.

The cases of ``tests/test_graphs.py`` run on both packages (``Side``),
with the same inputs drawn once from a seed.  Within the port a replay
is bitwise the eager stream schedule, across the 2 x 2 (backend,
warp_exec) cells, with atomics and a grid-sync kernel; against the
reference its outputs carry the same names and values -- bitwise, but
for the multiply-add kernels ``_saxpy`` and ``_scale``, which XLA
contracts into fused multiply-adds while eager torch rounds twice (rtol
= atol = 1e-5, as ``FMA_KERNELS``).  Rebinding, the stage hit of a
second instantiation, the cache shared with eager launches and every
capture-time refusal follow the reference.  On the CPU a replay runs
the captured nodes in order; the ``torch.cuda.CUDAGraph`` replay and
the refusal of host-reading kernels are held on the card in
``tests/test_torch_cuda.py``.

The sharded replay case runs on a one-rank gloo mesh in
``tests/test_torch_multidevice.py``.  A capturing launch
with ``donate=True`` is refused with the reference's reason, and one
with ``autotune=True`` keeps its heuristic knobs (no measurement runs
while a graph captures).
"""

import numpy as np
import pytest

from repro_torch.core.types import CoxUnsupported, GraphRef
from torch_suite import SIDES, annot, define, on_both


def _saxpy(c, out, x, y, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


def _scale(c, out, x, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] * 3.0 + 1.0


def _tile_sum(c, out, x, n):
    tile = c.shared((256,))
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    v = 0.0
    if i < n:
        v = x[i]
    tile[c.thread_idx()] = v
    c.syncthreads()
    s = 0.0
    for k in range(256):
        s += tile[k]
    out[c.block_idx()] = s


def _hist(c, hist, data, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, data[i], 1.0)


def _coop_scan(c, out, scratch, a):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    v = a[i] * 2.0
    scratch[i] = v
    c.grid_sync()
    w = scratch[(i + 64) % 256]
    out[i] = v + w


SAXPY = define(_saxpy, annot(out="f", x="f", y="f", n="n"))
SCALE = define(_scale, annot(out="f", x="f", n="n"))
TILE_SUM = define(_tile_sum, annot(out="f", x="f", n="n"))
HIST = define(_hist, annot(hist="f", data="i", n="n"))
COOP_SCAN = define(_coop_scan, annot(out="f", scratch="f", a="f"))


def _args(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return (np.zeros(n, np.float32), x, y, np.int32(n))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_fma_close(got, want):
    """Port against reference where a multiply-add kernel wrote."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _chain(side, s, kw, o, x, y, n):
    """saxpy -> scale -> tile_sum on ``s``; the eager handles, or (under
    capture) the graph handles."""
    h1 = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n), **kw)
    h2 = s.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), h1.outputs["out"], n), **kw)
    return s.launch(
        side.k(TILE_SUM), grid=8, block=256, args=(np.zeros(8, np.float32), h2.outputs["out"], n), **kw
    )


# ---------------------------------------------------------------------------
# bitwise equivalence: replay == eager, across backends x warp-exec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_replay_bitwise_equals_eager(backend, warp_exec):
    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        kw = dict(backend=backend, warp_exec=warp_exec)
        want = np.asarray(_chain(side, s, kw, o, x, y, n).result()["out"])
        g = side.cox.Graph()
        with g.capture(s):
            _chain(side, s, kw, o, x, y, n)
        res = _np(g.replay())
        # both upstream 'out's were consumed and elided: the terminal
        # tile_sum output keeps the bare name
        assert "out" in res and not any(k.startswith("out_") for k in res)
        np.testing.assert_array_equal(res["out"], want)
        res2 = _np(g.replay())  # replay is pure
        for k in res:
            np.testing.assert_array_equal(res2[k], res[k])
        return res

    ref, port = on_both(scenario)
    assert_fma_close(port, ref)  # tile_sum sums the multiply-add chain's values


def test_replay_bitwise_equals_eager_atomics_and_coop():
    """A grid-sync (multi-phase) kernel and an atomics kernel in one
    capture: the node walk threads the phases and the atomic merges as
    the eager path does."""

    def scenario(side):
        d, s, _ = side.fresh()
        rng = np.random.default_rng(3)
        a = rng.normal(size=256).astype(np.float32)
        data = rng.integers(0, 64, size=600).astype(np.int32)
        coop_args = (np.zeros(256, np.float32), np.zeros(256, np.float32), a)
        hist_args = (np.zeros(64, np.float32), data, np.int32(600))
        want_coop = np.asarray(s.launch(side.k(COOP_SCAN), grid=4, block=64, args=coop_args).result()["out"])
        want_hist = np.asarray(s.launch(side.k(HIST), grid=6, block=128, args=hist_args).result()["hist"])
        g = side.cox.Graph()
        with g.capture(s):
            s.launch(side.k(COOP_SCAN), grid=4, block=64, args=coop_args)
            s.launch(side.k(HIST), grid=6, block=128, args=hist_args)
        res = _np(g.replay())
        np.testing.assert_array_equal(res["out"], want_coop)
        np.testing.assert_array_equal(res["hist"], want_hist)
        return res

    ref, port = on_both(scenario)
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_capture_with_event_edges_across_streams():
    """A two-stream capture joined by an event edge records the edge, and
    replay equals the eager two-stream run."""

    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        ha = s1.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        s2.wait_event(s1.record_event())
        hb = s2.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), ha.outputs["out"], n))
        want = np.asarray(hb.result()["out"])
        g = side.cox.Graph()
        with g.capture(s1, s2):
            ca = s1.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
            s2.wait_event(s1.record_event())
            cb = s2.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), ca.outputs["out"], n))
            assert isinstance(cb.outputs["out"], side.cox.GraphRef)
        assert g.nodes[0].idx in g.nodes[1].deps  # the event edge
        res = _np(g.replay())
        np.testing.assert_array_equal(res["out"], want)
        return res

    ref, port = on_both(scenario)
    assert_fma_close(port, ref)


def test_diamond_fanout_replay():
    """One producer feeding two consumers feeding a joint consumer."""

    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        g = side.cox.Graph()
        with g.capture(s):
            p = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
            left = s.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), p.outputs["out"], n))
            right = s.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), p.outputs["out"], n))
            s.launch(
                side.k(SAXPY),
                grid=8,
                block=256,
                args=(np.zeros_like(o), left.outputs["out"], right.outputs["out"], n),
            )
        return _np(g.replay())

    ref, port = on_both(scenario)
    _, x, y, _ = _args()
    leg = (2.5 * x + y) * 3.0 + 1.0
    np.testing.assert_allclose(port["out"], (2.5 * leg + leg).astype(np.float32), rtol=1e-5, atol=1e-5)
    assert_fma_close(port, ref)


# ---------------------------------------------------------------------------
# rebinding
# ---------------------------------------------------------------------------


def test_replay_with_rebound_inputs():
    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        g = side.cox.Graph()
        with g.capture(s):
            h1 = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
            s.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), h1.outputs["out"], n))
        first = _np(g.replay())
        x2 = np.asarray(x) * -1.5
        res = _np(g.replay(x=x2))
        np.testing.assert_allclose(res["out"], ((2.5 * x2 + y) * 3.0 + 1.0).astype(np.float32), rtol=1e-5, atol=1e-5)
        res2 = _np(g.replay())  # rebinding persists
        np.testing.assert_array_equal(res2["out"], res["out"])
        assert not np.array_equal(first["out"], res["out"])
        return res

    ref, port = on_both(scenario)
    assert_fma_close(port, ref)


def test_replay_rejects_unknown_input():
    for side in SIDES:
        d, s, _ = side.fresh()
        g = side.cox.Graph()
        with g.capture(s):
            s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
        with pytest.raises(KeyError):
            g.replay(bogus=np.zeros(4, np.float32))


def test_bare_name_rebinds_every_matching_input():
    """The same external name on two nodes: a bare-name rebind updates
    both bindings; the suffixed name addresses one."""

    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args(512)
        g = side.cox.Graph()
        with g.capture(s):
            s.launch(side.k(SCALE), grid=2, block=256, args=(o, x, n))
            s.launch(side.k(SCALE), grid=2, block=256, args=(np.zeros_like(o), x, n))
        exe = g.instantiate()
        assert "x_n0" in exe.input_names and "x_n1" in exe.input_names
        x2 = np.asarray(x) + 1.0
        both = _np(exe.replay(x=x2))
        want = (x2 * 3.0 + 1.0).astype(np.float32)
        np.testing.assert_allclose(both["out_n0"], want, rtol=1e-5)
        np.testing.assert_allclose(both["out_n1"], want, rtol=1e-5)
        one = _np(exe.replay(x_n1=np.asarray(x)))
        np.testing.assert_array_equal(one["out_n0"], both["out_n0"])
        np.testing.assert_allclose(one["out_n1"], (np.asarray(x) * 3.0 + 1.0).astype(np.float32), rtol=1e-5)
        return sorted(exe.input_names), sorted(exe.output_names), both, one

    ref, port = on_both(scenario)
    assert port[:2] == ref[:2]
    assert_fma_close(port[2], ref[2])
    assert_fma_close(port[3], ref[3])


# ---------------------------------------------------------------------------
# staging: double-instantiate + cache sharing with eager launches
# ---------------------------------------------------------------------------


def test_double_instantiate_is_a_stage_hit():
    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        g = side.cox.Graph()
        with g.capture(s):
            s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        e1 = g.instantiate()
        hits = d.stage_hits
        e2 = g.instantiate()
        assert d.stage_hits == hits + 1  # same DAG: staged once
        assert e1._exe is e2._exe and e1 is not e2
        e2.replay(x=np.zeros_like(x))
        r1 = np.asarray(e1.replay()["out"])  # e1's bindings are untouched
        want = np.asarray(s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n)).result()["out"])
        np.testing.assert_array_equal(r1, want)
        return r1

    ref, port = on_both(scenario)
    assert_fma_close({"out": port}, {"out": ref})


def test_structurally_identical_recapture_shares_executable():
    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        g1 = side.cox.Graph()
        with g1.capture(s):
            s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        e1 = g1.instantiate()
        g2 = side.cox.Graph()
        with g2.capture(s):  # same kernel/geometry/structure
            s.launch(side.k(SAXPY), grid=8, block=256, args=(o, y, x, n))
        e2 = g2.instantiate()
        assert e1._exe is e2._exe
        got = np.asarray(e2.replay()["out"])  # its own bindings (x, y swapped)
        want = side.k(SAXPY).launch(grid=8, block=256, args=(o, y, x, n), **side.dev)["out"]
        np.testing.assert_array_equal(got, np.asarray(want))
        return got

    ref, port = on_both(scenario)
    assert_fma_close({"out": port}, {"out": ref})


def test_graph_shares_traces_with_eager_launches():
    """Eager launches fill the raw-runner cache; a graph over the same
    launch shapes stages nothing new, and graph entries never leak into
    the kernel's ``_launch_cache`` view."""
    for side in SIDES:
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n)).result()
        misses = d.stage_fn_misses
        g = side.cox.Graph()
        with g.capture(s):
            s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        g.instantiate()
        assert d.stage_fn_misses == misses
        assert d.stage_fn_hits >= 1
        assert any(k[0] == "graph" for k in d._staged)
        ck = next(iter(side.k(SAXPY)._cache.values()))
        assert all(isinstance(k[0], tuple) for k in d.cache_view([ck]))


# ---------------------------------------------------------------------------
# capture-time legality
# ---------------------------------------------------------------------------


def test_capture_rejects_synchronize():
    for side in SIDES:
        d, s, _ = side.fresh()
        with side.cox.Graph().capture(s):
            s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
            with pytest.raises(side.cox.CoxUnsupported):
                s.synchronize()
            with pytest.raises(side.cox.CoxUnsupported):
                d.sync_all()
        assert not s.capturing


def test_capture_rejects_donation():
    """A capturing launch with donate=True raises with the reference's
    reason: donation is not capturable."""
    for side in SIDES:
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        with side.cox.Graph().capture(s):
            h1 = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
            with pytest.raises(side.cox.CoxUnsupported, match="donate=True is not capturable"):
                s.launch(
                    side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), h1.outputs["out"], n), donate=True
                )


def test_capture_does_not_tune(tmp_path, monkeypatch):
    """A launch issued while a graph captures keeps its heuristic knobs:
    the tuner measures nothing (a synchronize inside a CUDA graph
    capture raises), and the replay is bitwise the eager launch."""
    from repro_torch.core import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    autotune.reset()
    side = SIDES[1]
    d, s, _ = side.fresh()
    o, x, y, n = _args()
    g = side.cox.Graph()
    with g.capture(s):
        h = s.launch(side.k(TILE_SUM), grid=8, block=256, args=(o[:8], x, n), autotune=True)
    assert h.request.rl.chunk_source == "heuristic"
    assert autotune.stats()["measurements"] == 0 and autotune.stats()["misses"] == 0
    want = side.k(TILE_SUM).launch(grid=8, block=256, args=(o[:8], x, n), device="cpu")
    assert np.array_equal(np.asarray(g.replay()["out"]), np.asarray(want["out"]))
    autotune.reset()


def test_capture_rejects_event_query_and_sync():
    for side in SIDES:
        d, s, _ = side.fresh()
        with side.cox.Graph().capture(s):
            s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
            ev = s.record_event()
            with pytest.raises(side.cox.CoxUnsupported):
                ev.query()
            with pytest.raises(side.cox.CoxUnsupported):
                ev.synchronize()


def test_capture_rejects_eager_event_wait():
    for side in SIDES:
        d, s1, s2 = side.fresh()
        h = s1.launch(side.k(SAXPY), grid=8, block=256, args=_args())
        eager_ev = s1.record_event()
        h.result()
        with side.cox.Graph().capture(s2):
            with pytest.raises(side.cox.CoxUnsupported):
                s2.wait_event(eager_ev)


def test_placeholder_escape_rejected():
    """A GraphRef consumed outside its capture fails at enqueue, as an
    array and as a scalar."""
    for side in SIDES:
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        g = side.cox.Graph()
        with g.capture(s):
            ref = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n)).outputs["out"]
        with pytest.raises(side.cox.CoxUnsupported):
            s.launch(side.k(SCALE), grid=8, block=256, args=(np.zeros_like(o), ref, n))
        with pytest.raises(side.cox.CoxUnsupported):
            s.launch(side.k(SCALE), grid=8, block=256, args=(o, x, ref))


def test_captured_handle_has_no_results():
    for side in SIDES:
        d, s, _ = side.fresh()
        with side.cox.Graph().capture(s):
            h = s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
            with pytest.raises(side.cox.CoxUnsupported):
                h.result()
            with pytest.raises(side.cox.CoxUnsupported):
                h.done()


def test_empty_graph_and_nested_capture_rejected():
    for side in SIDES:
        d, s, _ = side.fresh()
        g = side.cox.Graph()
        with pytest.raises(side.cox.CoxUnsupported):
            g.instantiate()
        with g.capture(s):
            with pytest.raises(side.cox.CoxUnsupported):
                s.begin_capture()  # already capturing
        with g.capture(s):  # re-open the same graph: fine
            s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
        g.instantiate()
        with pytest.raises(side.cox.CoxUnsupported):  # instantiated: frozen
            s.begin_capture(g)


def test_capture_does_not_dispatch():
    """Capture records the schedule without running it, while eager
    launches on other streams flow; replay bypasses dispatch."""

    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        logged = len(d.dispatch_log)
        g = side.cox.Graph()
        with g.capture(s1):
            s1.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
            r = s2.launch(side.k(SCALE), grid=8, block=256, args=(o, x, n)).result()
            np.testing.assert_allclose(np.asarray(r["out"]), np.asarray(x) * 3.0 + 1.0, rtol=1e-5)
        assert len(d.dispatch_log) == logged + 1  # only the eager launch
        assert not d._pending
        g.replay()
        assert len(d.dispatch_log) == logged + 1
        return isinstance(g.nodes[0].req.globals_["x"], GraphRef)

    assert on_both(scenario) == (False, False)


def test_cpu_replay_has_no_cuda_graph():
    """On the host the executable is the node walk: no CUDAGraph, and
    instantiating on another device than the capture's is refused."""
    side = SIDES[1]
    d, s, _ = side.fresh()
    g = side.cox.Graph()
    with g.capture(s):
        s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
    exe = g.instantiate()
    assert exe.cuda_graph is None and str(exe.device) == "cpu"
    g2 = side.cox.Graph()
    with g2.capture(s):
        s.launch(side.k(SAXPY), grid=8, block=256, args=_args())
    with pytest.raises(CoxUnsupported, match="one device"):
        g2.instantiate(device="cuda")
