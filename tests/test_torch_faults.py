"""The port's error model under injected faults, against the JAX
package's.

The 20 cases of ``tests/test_fault_tolerance.py``, each run on both
packages (``Side``) with the same inputs: the error types, where each
surfaces (its own sync), the blast radius (program-order, event and
data-edge descendants fail fast with ``CoxDependencyError`` and are
never run), stream poisoning and reset, the ``cudaGetLastError``
contract, sticky device errors until ``device_reset``, the deadline, the
bounded transient retry, the degradation ladder (batched -> serial ->
scan, bitwise), graph faults and their replay -> eager rung, the serving
pool's slot isolation and bounded retention.  The counters the
reference asserts (fired faults, retries, degradations, failures,
timeouts, strikes) must come out the same on the port, and the
surviving outputs the reference's values: bitwise, but for the
multiply-add kernels ``_ft_saxpy`` / ``_ft_scale`` (XLA contracts them,
eager torch rounds twice: rtol = atol = 1e-5).
"""

import numpy as np
import pytest

from repro_torch.core import cox as pcox
from repro_torch.core import errors as perrors
from repro_torch.core import faults as pfaults
from torch_suite import SIDES, annot, define, on_both


def _ft_saxpy(c, out, x, y, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


def _ft_scale(c, out, x, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] * 3.0 + 1.0


def _ft_warpstage(c, out, a):
    """Shared memory + warp collective + block barrier: auto-resolves to
    backend='vmap', warp_exec='batched' at block=128, so the whole
    batched -> serial -> scan ladder is walkable."""
    tile = c.shared((4,))
    tid = c.thread_idx()
    v = a[c.block_idx() * c.block_dim() + tid]
    s = c.red_add(v)
    if c.lane_id() == 0:
        tile[c.warp_id()] = s
    c.syncthreads()
    t = tile[tid % 4]
    out[c.block_idx() * c.block_dim() + tid] = v + t


SAXPY = define(_ft_saxpy, annot(out="f", x="f", y="f", n="n"))
SCALE = define(_ft_scale, annot(out="f", x="f", n="n"))
WARPSTAGE = define(_ft_warpstage, annot(out="f", a="f"))


def _args(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return (np.zeros(n, np.float32), x, y, np.int32(n))


def _saxpy_want(args):
    return 2.5 * args[1] + args[2]


def _scale_want(side, stream, x, n=1024):
    """A clean launch of ``_ft_scale``: the bitwise reference within a
    package."""
    h = stream.launch(side.k(SCALE), grid=4, block=256, args=(np.zeros(n, np.float32), x, np.int32(n)))
    return np.asarray(h.result()["out"])


def _scale(side, s, x):
    return s.launch(side.k(SCALE), grid=4, block=256, args=(np.zeros(1024, np.float32), x, 1024))


def _close(port, ref):
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# typed surfacing at the failing request's own sync
# ---------------------------------------------------------------------------


def test_injected_dispatch_fault_is_typed_and_surfaces_at_own_sync():
    def scenario(side):
        d, s1, s2 = side.fresh()
        args = _args()
        want = _scale_want(side, s2, args[1])
        with side.faults.inject("_ft_saxpy", site="dispatch") as spec:
            bad = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
            good = _scale(side, s2, args[1])
        assert spec.fired == 1
        got = np.asarray(good.result()["out"])
        np.testing.assert_array_equal(got, want)
        with pytest.raises(side.errors.CoxLaunchError, match="injected dispatch fault"):
            bad.result()
        assert bad.request.seq not in d._inflight
        assert bad.request.seq not in d._errored
        assert s1.error is None
        assert bad.request.outputs is None
        return got

    ref, port = on_both(scenario)
    _close(port, ref)


def test_stage_fault_is_cox_compile_error():
    for side in SIDES:
        d, s1, _ = side.fresh()
        with side.faults.inject("_ft_saxpy", site="stage"):
            bad = s1.launch(side.k(SAXPY), grid=4, block=256, args=_args())
        with pytest.raises(side.errors.CoxCompileError, match="injected stage fault"):
            bad.result()
        assert isinstance(d.get_last_error(), side.errors.CoxCompileError)
        assert d.peek_at_last_error() is None


# ---------------------------------------------------------------------------
# DAG failure propagation: one test per edge kind
# ---------------------------------------------------------------------------


def test_program_order_descendant_fails_fast():
    def scenario(side):
        d, s1, s2 = side.fresh()
        args = _args()
        want = _scale_want(side, s2, args[1])
        with side.faults.inject("_ft_saxpy", site="dispatch"):
            bad = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
            dep = _scale(side, s1, args[1])
            sib = _scale(side, s2, args[1])
        with pytest.raises(side.errors.CoxDependencyError) as ei:
            dep.result()
        assert isinstance(ei.value.root, side.errors.CoxLaunchError)
        assert dep.request.outputs is None
        with pytest.raises(side.errors.CoxLaunchError):
            bad.result()
        got = np.asarray(sib.result()["out"])
        np.testing.assert_array_equal(got, want)
        return got

    ref, port = on_both(scenario)
    _close(port, ref)


def test_event_edge_descendant_fails_fast():
    def scenario(side):
        d, s1, s2 = side.fresh()
        args = _args()
        want = _scale_want(side, s2, args[1])
        sib = _scale(side, s2, args[1])
        with side.faults.inject("_ft_saxpy", site="dispatch"):
            bad = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        s2.wait_event(s1.record_event())
        dep = _scale(side, s2, args[1])
        with pytest.raises(side.errors.CoxDependencyError):
            dep.result()
        assert dep.request.outputs is None
        got = np.asarray(sib.result()["out"])
        np.testing.assert_array_equal(got, want)
        with pytest.raises(side.errors.CoxLaunchError):
            bad.result()
        return got

    ref, port = on_both(scenario)
    _close(port, ref)


def test_data_edge_descendant_fails_fast_after_timeout():
    """A launch consuming a (later) timed-out producer's outputs fails at
    its sync with CoxDependencyError."""

    def scenario(side):
        d, s1, s2 = side.fresh()
        args = _args()
        want = _scale_want(side, s2, args[1])
        sib = _scale(side, s2, args[1])
        with side.faults.inject("_ft_saxpy", site="timeout"):
            prod = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        cons = s2.launch(
            side.k(SCALE), grid=4, block=256, args=(np.zeros(1024, np.float32), prod.outputs["out"], 1024)
        )
        assert prod.request.seq in cons.request.data_deps
        with pytest.raises(side.errors.CoxTimeoutError):
            s1.synchronize()
        with pytest.raises(side.errors.CoxDependencyError) as ei:
            cons.result()
        assert isinstance(ei.value.root, side.errors.CoxTimeoutError)
        got = np.asarray(sib.result()["out"])
        np.testing.assert_array_equal(got, want)
        return got

    ref, port = on_both(scenario)
    _close(port, ref)


# ---------------------------------------------------------------------------
# stream poisoning, reset, get_last_error
# ---------------------------------------------------------------------------


def test_unsurfaced_error_poisons_stream_until_reset():
    def scenario(side):
        d, s1, _ = side.fresh()
        args = _args()
        with side.faults.inject("_ft_saxpy", site="dispatch"):
            bad = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        del bad  # handle dropped, never surfaced
        assert isinstance(s1.error, side.errors.CoxLaunchError)
        poisoned = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        with pytest.raises(side.errors.CoxDependencyError):
            poisoned.result()
        s1.reset()
        assert s1.error is None
        ok = np.asarray(s1.launch(side.k(SAXPY), grid=4, block=256, args=args).result()["out"])
        np.testing.assert_allclose(ok, _saxpy_want(args), rtol=1e-5, atol=1e-6)
        return ok

    ref, port = on_both(scenario)
    _close(port, ref)


def test_get_last_error_returns_and_clears():
    for side in SIDES:
        d, s1, _ = side.fresh()
        with side.faults.inject("_ft_saxpy", site="dispatch"):
            s1.launch(side.k(SAXPY), grid=4, block=256, args=_args())
        err = d.peek_at_last_error()
        assert isinstance(err, side.errors.CoxLaunchError)
        assert d.peek_at_last_error() is err
        assert d.get_last_error() is err
        assert d.get_last_error() is None
        assert s1.error is None  # consuming = surfacing
        ok = s1.launch(side.k(SAXPY), grid=4, block=256, args=_args())
        np.testing.assert_allclose(np.asarray(ok.result()["out"]), _saxpy_want(_args()), rtol=1e-5, atol=1e-6)


def test_sticky_device_error_poisons_until_device_reset():
    for side in SIDES:
        d, s1, s2 = side.fresh()
        args = _args()
        with side.faults.inject("_ft_saxpy", site="sticky-device"):
            bad = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        with pytest.raises(side.errors.CoxDeviceError):
            bad.result()
        with pytest.raises(side.errors.CoxDeviceError):
            _scale(side, s2, args[1])  # every enqueue fails, any stream
        assert isinstance(d.get_last_error(), side.errors.CoxDeviceError)
        assert isinstance(d.get_last_error(), side.errors.CoxDeviceError)
        with pytest.raises(side.errors.CoxDeviceError):
            s1.synchronize()
        d.device_reset()
        assert d.peek_at_last_error() is None
        ok = s2.launch(side.k(SAXPY), grid=4, block=256, args=args)
        np.testing.assert_allclose(np.asarray(ok.result()["out"]), _saxpy_want(args), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# per-launch deadline (watchdog wiring)
# ---------------------------------------------------------------------------


def test_deadline_turns_hang_into_timeout_and_recovers():
    def scenario(side):
        d, s1, _ = side.fresh(launch_deadline_s=0.05)
        args = _args()
        with side.faults.inject("_ft_saxpy", site="timeout"):
            hung = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        with pytest.raises(side.errors.CoxTimeoutError, match="deadline"):
            hung.result()
        counters = [d.timeouts, d.watchdog.strikes]
        ok = np.asarray(s1.launch(side.k(SAXPY), grid=4, block=256, args=args).result()["out"])
        np.testing.assert_allclose(ok, _saxpy_want(args), rtol=1e-5, atol=1e-6)
        return counters + [d.watchdog.strikes]

    assert on_both(scenario) == ([1, 1, 0], [1, 1, 0])


# ---------------------------------------------------------------------------
# retry (transient) + degradation ladder
# ---------------------------------------------------------------------------


def test_transient_fault_cleared_by_bounded_retry():
    def scenario(side):
        d, s1, _ = side.fresh()
        args = _args()
        with side.faults.inject("_ft_saxpy", site="dispatch", transient=True, times=2) as spec:
            got = np.asarray(s1.launch(side.k(SAXPY), grid=4, block=256, args=args).result()["out"])
        np.testing.assert_allclose(got, _saxpy_want(args), rtol=1e-5, atol=1e-6)
        return spec.fired, d.retries, d.degradations, d.failures

    assert on_both(scenario) == ((2, 2, 0, 0), (2, 2, 0, 0))


def test_transient_retry_exhaustion_surfaces_the_error():
    for side in SIDES:
        d, s1, _ = side.fresh()
        with side.faults.inject("_ft_saxpy", site="dispatch", transient=True, times=None):
            h = s1.launch(side.k(SAXPY), grid=4, block=256, args=_args())
            with pytest.raises(side.errors.CoxLaunchError):
                h.result()
        assert d.retries == d.retry_limit == 3


def _ws_args(seed=3):
    a = np.random.default_rng(seed).integers(-8, 9, 256).astype(np.float32)
    return (np.zeros(256, np.float32), a)


def _ladder(side, seed, times):
    d, s1, _ = side.fresh()
    args = _ws_args(seed)
    want = np.asarray(s1.launch(side.k(WARPSTAGE), grid=2, block=128, args=args).result()["out"])
    assert d.degradations == 0  # clean run: no fallback
    with side.faults.inject("_ft_warpstage", site="dispatch", times=times):
        got = np.asarray(s1.launch(side.k(WARPSTAGE), grid=2, block=128, args=args).result()["out"])
    np.testing.assert_array_equal(got, want)
    return got, d.degradations, [e["to"] for e in d.degradation_log], d.failures


def test_ladder_batched_to_serial_is_bitwise():
    (rgot, *rc), (pgot, *pc) = on_both(lambda side: _ladder(side, 3, 1))
    np.testing.assert_array_equal(pgot, rgot)  # small integers: exact sums
    assert pc == rc == [1, ["warp_exec=serial"], 0]


def test_ladder_walks_to_scan_when_serial_also_fails():
    (rgot, *rc), (pgot, *pc) = on_both(lambda side: _ladder(side, 4, 2))
    np.testing.assert_array_equal(pgot, rgot)
    assert pc == rc == [2, ["warp_exec=serial", "backend=scan"], 0]


def test_explicit_knobs_never_degrade():
    for side in SIDES:
        d, s1, _ = side.fresh()
        with side.faults.inject("_ft_warpstage", site="dispatch", times=1):
            h = s1.launch(
                side.k(WARPSTAGE), grid=2, block=128, args=_ws_args(5), backend="vmap", warp_exec="batched"
            )
            with pytest.raises(side.errors.CoxLaunchError):
                h.result()
        assert d.degradations == 0


# ---------------------------------------------------------------------------
# graphs: node-typed staging errors + replay -> eager fallback
# ---------------------------------------------------------------------------


def _capture_pair(side, s1, name, args):
    g = side.cox.Graph(name=name)
    with g.capture(s1):
        h0 = s1.launch(side.k(SAXPY), grid=4, block=256, args=args)
        s1.launch(side.k(SCALE), grid=4, block=256, args=(np.zeros(1024, np.float32), h0.outputs["out"], 1024))
    return g


def test_graph_node_stage_fault_fails_replay_with_node_error():
    for side in SIDES:
        d, s1, _ = side.fresh()
        g = _capture_pair(side, s1, "ft-graph-stage", _args())
        with side.faults.inject("_ft_scale", site="stage"):
            with pytest.raises(side.errors.CoxCompileError, match="injected stage fault"):
                g.replay()


def test_graph_replay_falls_back_to_eager_bitwise():
    def scenario(side):
        d, s1, _ = side.fresh()
        exe = _capture_pair(side, s1, "ft-graph-replay", _args(seed=7)).instantiate()
        want = {k: np.asarray(v) for k, v in exe.replay().items()}
        with side.faults.inject("ft-graph-replay", site="dispatch", times=1) as spec:
            got = {k: np.asarray(v) for k, v in exe.replay().items()}
        assert spec.fired == 1
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert d.degradations == 1
        ev = d.degradation_log[-1]
        assert ev["from"] == "graph-replay" and ev["to"] == "eager"
        with pytest.raises(KeyError):  # a user error is never swallowed
            exe.replay(nope=np.zeros(4, np.float32))
        return got

    ref, port = on_both(scenario)
    assert set(port) == set(ref)
    for k in ref:
        _close(port[k], ref[k])


# ---------------------------------------------------------------------------
# serving pool: slot isolation
# ---------------------------------------------------------------------------


def test_request_pool_isolates_faulting_slot():
    from repro.launch.serve import RequestKernelPool as RefPool
    from repro_torch.launch.serve import RequestKernelPool

    results = []
    for side, pool in zip(SIDES, (RefPool(3, nbins=8), RequestKernelPool(3, nbins=8, device="cpu"))):
        with side.faults.inject("_token_hist", site="dispatch", index=0, times=1):
            pool.submit(0, [1, 2, 3])  # forced to fail
            pool.submit(1, [4, 4, 4, 4])
            pool.submit(2, [5, 6])
            hists = pool.collect()
        assert pool.health["submitted"] == 3
        assert pool.health["failed"] == 1 and pool.health["failed_slots"] == [0]
        assert pool.health["completed"] == 2 and len(hists) == 2
        np.testing.assert_array_equal(hists[0], np.bincount(np.array([4, 4, 4, 4]) % 8, minlength=8))
        np.testing.assert_array_equal(hists[1], np.bincount(np.array([5, 6]) % 8, minlength=8))
        assert pool.ok_tokens == 6
        pool.submit(0, [7])  # the faulted slot's stream was reset
        assert int(np.asarray(pool.handles[-1].result()["hist"]).sum()) == 1
        side.cox.get_last_error()  # drain the default dispatcher's register
        results.append([np.asarray(h) for h in hists])
    for p, r in zip(results[1], results[0]):
        np.testing.assert_array_equal(p, r)


# ---------------------------------------------------------------------------
# bounded retention, scope, exports
# ---------------------------------------------------------------------------


def test_errored_retention_stays_bounded_under_repeated_failures():
    for side in SIDES:
        d, s1, _ = side.fresh(error_log_max=8)
        with side.faults.inject("_ft_saxpy", site="stage", times=None):
            for _ in range(40):
                s1.launch(side.k(SAXPY), grid=4, block=256, args=_args())
        assert len(d._errored) <= 8
        assert not d._pending
        assert all(r.error is None for r in d._inflight.values())
        assert d.health()["errored_retained"] <= 8
        assert d.failures == 40
        assert isinstance(d.get_last_error(), (side.errors.CoxCompileError, side.errors.CoxDependencyError))
        assert d.get_last_error() is None


def test_fault_scope_ends_with_the_context():
    def scenario(side):
        d, s1, _ = side.fresh()
        args = _args(seed=9)
        with side.faults.inject("_ft_saxpy", site="dispatch"):
            pass  # armed and disarmed, never hit
        assert side.faults.active() == []
        got = np.asarray(s1.launch(side.k(SAXPY), grid=4, block=256, args=args).result()["out"])
        np.testing.assert_allclose(got, _saxpy_want(args), rtol=1e-5, atol=1e-6)
        assert d.failures == 0
        return got

    ref, port = on_both(scenario)
    _close(port, ref)


def test_typed_hierarchy_is_exported():
    for cls in (
        perrors.CoxError,
        perrors.CoxCompileError,
        perrors.CoxLaunchError,
        perrors.CoxTimeoutError,
        perrors.CoxDependencyError,
        perrors.CoxDeviceError,
    ):
        assert getattr(pcox, cls.__name__) is cls
    assert pcox.faults is pfaults
    assert callable(pcox.get_last_error) and callable(pcox.peek_at_last_error)
    assert callable(pcox.device_reset)
    assert issubclass(perrors.CoxDeviceError, perrors.CoxError) and perrors.CoxDeviceError.sticky
    # the same names as the reference's cox exports
    ref_cox = SIDES[0].cox
    for name in ("Stream", "Event", "Graph", "GraphExec", "LaunchHandle", "get_dispatcher",
                 "synchronize", "default_stream", "device_reset", "get_last_error",
                 "peek_at_last_error", "PlacementPolicy", "RoundRobinPlacement",
                 "AffinityPlacement", "HealthAwarePlacement", "faults", "placement",
                 "costmodel", "errors", "GraphRef"):
        assert hasattr(ref_cox, name) and hasattr(pcox, name), name


def test_real_cuda_fault_text_classifies_sticky():
    """A torch error naming a CUDA fault that leaves the context unusable
    is the sticky CoxDeviceError; out of memory stays transient."""
    from repro_torch.core.streams import classify

    err = classify(RuntimeError("CUDA error: an illegal memory access was encountered"), site="dispatch")
    assert isinstance(err, perrors.CoxDeviceError) and perrors.is_sticky(err)
    err = classify(RuntimeError("CUDA error: unspecified launch failure"), site="dispatch")
    assert perrors.is_sticky(err)
    oom = classify(RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), site="dispatch")
    assert isinstance(oom, perrors.CoxLaunchError) and perrors.is_transient(oom)
    assert not perrors.is_sticky(oom)
