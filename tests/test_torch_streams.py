"""The port's CUDA streams and events against the JAX package's.

The cases of ``tests/test_streams.py`` run on both packages (``Side``:
the port's dispatchers pool the CPU), with the same inputs drawn once
from a seed: program order, event edges, the default stream's legacy
sync and the priority-free edge sets must be the reference's edge for
edge, and every output the reference's -- bitwise, but for ``_saxpy``
and ``_scale``, whose ``a * b + c`` XLA contracts into one fused
multiply-add while eager torch rounds twice (rtol = atol = 1e-5, as
``FMA_KERNELS``).  Within the port, a stream schedule is bitwise the
serial launches, across the 2 x 2 (backend, warp_exec) cells.

Buffer donation runs each donate case of the reference's file on both
packages: a donated 1-D device tensor is consumed (a later launch over
it raises), a chained relaunch over its own outputs and a consumed
producer output keep the bookkeeping whole, a donating launch never
shares a staged entry with a plain one, and the sharded refusal is the
reference's.  The card-side half (device waits, the legacy barrier,
``record_stream``) is in ``tests/test_torch_cuda.py``.
"""

from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.core import cox as pcox
from repro_torch.core import runtime as pruntime
from repro_torch.core.streams import Dispatcher
from repro_torch.core.types import CoxUnsupported
from torch_suite import SIDES, Side, annot, define, on_both, one_rank_mesh


def _saxpy(c, out, x, y, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


def _scale(c, out, x, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] * 3.0 + 1.0


def _tile_sum(c, out, x, n):
    """Shared-memory kernel (so warp_exec='batched' is exercisable)."""
    tile = c.shared((256,))
    t = c.thread_idx()
    i = c.block_idx() * c.block_dim() + t
    tile[t] = c.select(i < n, x[i], 0.0)
    c.syncthreads()
    if t == 0:
        s = 0.0
        for k in range(256):
            s += tile[k]
        out[c.block_idx()] = s


def _ticket(c, out, cnt):
    t = c.atomic_add_old(cnt, 0, 1.0)
    out[c.block_idx()] = t


SAXPY = define(_saxpy, annot(out="f", x="f", y="f", n="n"))
SCALE = define(_scale, annot(out="f", x="f", n="n"))
TILE_SUM = define(_tile_sum, annot(out="f", x="f", n="n"))
TICKET = define(_ticket, annot(out="f", cnt="f"))


def _args(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return (np.zeros(n, np.float32), x, y, np.int32(n))


def _np(t):
    return np.asarray(t)


def assert_fma_close(got, want):
    """Port against reference for the multiply-add kernels."""
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# ordering: program order, event edges, legacy default-stream sync
# ---------------------------------------------------------------------------


def _rel(seqs, *hs):
    """Request seqs as positions among ``hs`` (the packages number their
    requests from different counters)."""
    pos = {h.request.seq: i for i, h in enumerate(hs)}
    return [pos[s] for s in seqs if s in pos]


def test_in_order_within_stream():
    def scenario(side):
        d, s, _ = side.fresh()
        o, x, y, n = _args()
        h1 = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        h2 = s.launch(side.k(SCALE), grid=8, block=256, args=(o, x, n))
        h3 = s.launch(side.k(SAXPY), grid=8, block=256, args=(o, y, x, n))
        assert h1.request.seq in h2.request.deps
        assert h2.request.seq in h3.request.deps
        d.flush()
        return _rel(d.dispatch_log, h1, h2, h3), _np(h3.result()["out"])

    (ref_order, ref_out), (order, out) = on_both(scenario)
    assert order == ref_order == [0, 1, 2]
    assert_fma_close(out, ref_out)


def test_event_edge_orders_across_streams():
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        ha = s1.launch(side.k(SAXPY), grid=4, block=256, args=(o, x, y, n))
        ev = s1.record_event()
        s2.wait_event(ev)
        hb = s2.launch(side.k(SCALE), grid=4, block=256, args=(o, x, n))
        hc = s2.launch(side.k(SCALE), grid=4, block=256, args=(o, y, n))
        assert ha.request.seq in hb.request.deps  # the event edge
        assert hb.request.seq in hc.request.deps  # then program order
        d.flush()
        return _rel(d.dispatch_log, ha, hb, hc), [_np(h.result()["out"]) for h in (ha, hb, hc)]

    (ref_order, ref_outs), (order, outs) = on_both(scenario)
    assert order == ref_order and order.index(0) < order.index(1)
    for got, want in zip(outs, ref_outs):
        assert_fma_close(got, want)


def test_wait_on_unrecorded_event_is_noop():
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        s2.wait_event(side.cox.Event())  # never recorded
        hb = s2.launch(side.k(SCALE), grid=4, block=256, args=(o, x, n))
        deps = hb.request.deps
        d.sync_all()
        return deps

    assert on_both(scenario) == ((), ())


def test_default_stream_legacy_sync():
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        h1 = s1.launch(side.k(SAXPY), grid=4, block=256, args=(o, x, y, n))
        hd = d.default.launch(side.k(SAXPY), grid=4, block=256, args=(o, y, x, n))
        assert h1.request.seq in hd.request.deps
        h2 = s2.launch(side.k(SCALE), grid=4, block=256, args=(o, x, n))
        assert hd.request.seq in h2.request.deps
        d.flush()
        return _rel(d.dispatch_log, h1, hd, h2), _np(hd.result()["out"])

    (ref_order, ref_out), (order, out) = on_both(scenario)
    assert order == ref_order == [0, 1, 2]
    assert_fma_close(out, ref_out)


def test_independent_streams_have_no_edges():
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        h1 = s1.launch(side.k(SAXPY), grid=4, block=256, args=(o, x, y, n))
        h2 = s2.launch(side.k(SCALE), grid=4, block=256, args=(o, x, n))
        deps = (h1.request.deps, h2.request.deps)
        d.sync_all()
        return deps

    assert on_both(scenario) == (((), ()), ((), ()))


# ---------------------------------------------------------------------------
# synchronization
# ---------------------------------------------------------------------------


def test_synchronize_idempotent():
    def scenario(side):
        d, s1, _ = side.fresh()
        o, x, y, n = _args()
        h = s1.launch(side.k(SAXPY), grid=4, block=256, args=(o, x, y, n))
        s1.synchronize()
        n_dispatched = len(d.dispatch_log)
        s1.synchronize()  # idle stream: no-op
        s1.synchronize()
        d.sync_all()
        d.sync_all()
        assert len(d.dispatch_log) == n_dispatched  # nothing re-dispatched
        r1, r2 = _np(h.result()["out"]), _np(h.result()["out"])
        np.testing.assert_array_equal(r1, r2)  # result() is repeatable
        return r1

    ref, port = on_both(scenario)
    assert_fma_close(port, ref)


def test_event_synchronize_and_elapsed():
    def scenario(side):
        d, s1, _ = side.fresh()
        o, x, y, n = _args()
        start = side.cox.Event().record(s1)
        s1.launch(side.k(SAXPY), grid=4, block=256, args=(o, x, y, n))
        stop = s1.record_event()
        stop.synchronize()
        stop.synchronize()  # idempotent
        ms = start.elapsed(stop)
        return ms >= 0.0, stop.query(), start.elapsed_time(stop) >= 0.0

    assert on_both(scenario) == ((True, True, True), (True, True, True))


def test_event_elapsed_before_record_raises():
    for side in SIDES:
        with pytest.raises(side.cox.CoxUnsupported):
            side.cox.Event().synchronize()
        with pytest.raises(side.cox.CoxUnsupported):
            side.cox.Event().elapsed(side.cox.Event())


# ---------------------------------------------------------------------------
# bitwise equality: any legal stream schedule == serial issue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["scan", "vmap"])
@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_stream_schedule_bitwise_equals_serial(backend, warp_exec):
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n32 = _args()
        a1 = (o, x, n32)
        a2 = (np.zeros(8, np.float32), y, n32)
        kw = dict(backend=backend, warp_exec=warp_exec)
        want1 = side.k(SCALE).launch(grid=8, block=256, args=a1, **kw, **side.dev)
        want2 = side.k(TILE_SUM).launch(grid=8, block=256, args=a2, **kw, **side.dev)
        h1 = s1.launch(side.k(SCALE), grid=8, block=256, args=a1, **kw)
        ev = s1.record_event()
        s2.wait_event(ev)
        h2 = s2.launch(side.k(TILE_SUM), grid=8, block=256, args=a2, **kw)
        got1, got2 = _np(h1.result()["out"]), _np(h2.result()["out"])
        np.testing.assert_array_equal(got1, _np(want1["out"]))
        np.testing.assert_array_equal(got2, _np(want2["out"]))
        return got1, got2

    (r1, r2), (p1, p2) = on_both(scenario)
    assert_fma_close(p1, r1)
    np.testing.assert_array_equal(p2, r2)  # a sum of adds: no contraction


def test_handle_chaining_without_host_sync():
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        h1 = s1.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        h2 = s2.launch(side.k(SCALE), grid=8, block=256, args=(o, h1.outputs["out"], n))
        return _np(h2.result()["out"])

    ref, port = on_both(scenario)
    _, x, y, _ = _args()
    np.testing.assert_allclose(port, (2.5 * x + y) * 3.0 + 1.0, rtol=1e-5, atol=1e-6)
    assert_fma_close(port, ref)


# ---------------------------------------------------------------------------
# staging-cache sharing
# ---------------------------------------------------------------------------


def test_cache_shared_across_streams():
    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        s1.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n)).result()
        misses, hits = d.stage_misses, d.stage_hits
        h2 = s2.launch(side.k(SAXPY), grid=8, block=256, args=(o, y, x, n))
        h3 = d.default.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        h2.result()
        h3.result()
        return d.stage_misses - misses, d.stage_hits - hits

    assert on_both(scenario) == ((0, 2), (0, 2))


def test_kernelfn_launch_cache_view_still_works():
    """The ``_launch_cache`` view keeps the reference's shape: token
    first, phase count second, (plan, runner) values."""
    for side in SIDES:
        o, x, y, n = _args()
        k = side.k(SAXPY)
        k.launch(grid=2, block=256, args=(o, x, y, n), **side.dev)
        cache = k._launch_cache
        assert len(cache) >= 1
        for key, (plan, exe) in cache.items():
            choice, ws = key[0]
            assert choice in ("flat", "hier") and isinstance(ws, int)
            assert key[1] == 1  # single-phase kernel
            assert callable(exe)


# ---------------------------------------------------------------------------
# error surfacing
# ---------------------------------------------------------------------------


def test_stage_error_surfaces_at_that_requests_sync():
    """A bad request (explicit vmap for a ticket kernel) raises at *its
    own* sync and poisons no unrelated launch, on both packages."""

    def scenario(side):
        d, s1, s2 = side.fresh()
        o, x, y, n = _args()
        tk = side.k(TICKET)
        targs = (np.zeros(4, np.float32), np.zeros(1, np.float32))
        bad = s1.launch(tk, grid=4, block=32, args=targs, backend="vmap")
        good = s2.launch(side.k(SAXPY), grid=8, block=256, args=(o, x, y, n))
        r = _np(good.result()["out"])
        with pytest.raises(side.cox.CoxUnsupported):
            bad.result()
        assert bad.request.seq not in d._inflight
        bad2 = s1.launch(tk, grid=4, block=32, args=targs, backend="vmap")
        with pytest.raises(side.cox.CoxUnsupported):
            bad2.outputs
        assert bad2.request.seq not in d._inflight
        return r

    ref, port = on_both(scenario)
    assert_fma_close(port, ref)


# ---------------------------------------------------------------------------
# the serving pool, and retention
# ---------------------------------------------------------------------------


def test_request_kernel_pool_on_per_slot_streams():
    """Per-request histograms on per-slot streams, one sync, totals exact
    and equal to the reference's pool."""
    from repro.launch.serve import RequestKernelPool as RefPool
    from repro_torch.launch.serve import RequestKernelPool

    got = []
    for pool in (RefPool(2, nbins=8), RequestKernelPool(2, nbins=8, device="cpu")):
        pool.submit(0, [1, 2, 3, 9])
        pool.submit(1, [4, 4, 4])
        pool.submit(0, [])  # empty request: no launch
        hists = pool.collect()
        assert {h.stream.name for h in pool.handles} == {"req-slot0", "req-slot1"}
        got.append([_np(h) for h in hists])
    ref, port = got
    assert len(port) == 2
    np.testing.assert_array_equal(port[0], np.bincount(np.array([1, 2, 3, 9]) % 8, minlength=8))
    np.testing.assert_array_equal(port[1], np.bincount(np.array([4, 4, 4]) % 8, minlength=8))
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)


def test_dispatch_log_is_bounded_deque():
    """A long launch loop keeps host bookkeeping flat: the log is a
    ``deque(maxlen=...)`` holding the most recent dispatches in order,
    and nothing in flight survives a sync."""
    d = Dispatcher(dispatch_log_max=16, devices=[torch.device("cpu")])
    s = pcox.Stream("loop", d)
    assert isinstance(d.dispatch_log, deque) and d.dispatch_log.maxlen == 16
    o, x, y, n = _args(256)
    handles = [s.launch(SAXPY[1], grid=1, block=64, args=(o, x, y, n)) for _ in range(40)]
    s.synchronize()
    assert list(d.dispatch_log) == [h.request.seq for h in handles[-16:]]
    assert not d._inflight and not d._pending


# ---------------------------------------------------------------------------
# donation: the reference's cases, each run on both packages
# ---------------------------------------------------------------------------


def _arrays(side, *vals):
    """Each value as the package's own 1-D device array: a jax array for
    the reference, a CPU tensor for the port (what donation aliases)."""
    if side.port:
        return tuple(torch.from_numpy(np.array(v)) for v in vals)
    import jax.numpy as jnp

    return tuple(jnp.asarray(v) for v in vals)


def _donate_correct():
    """Outputs stay correct, and a donated 1-D input is consumed:
    launching over it again raises.  A numpy input, a tensor of another
    dtype (which needed a cast) and a 2-D tensor are never consumed."""
    n = 1024
    x0 = np.arange(n, dtype=np.float32)

    def scenario(side):
        o, x, y = _arrays(side, np.zeros(n, np.float32), x0, np.ones(n, np.float32))
        r = side.k(SAXPY).launch(grid=4, block=256, args=(o, x, y, n), donate=True, **side.dev)
        with pytest.raises(Exception):
            side.k(SAXPY).launch(grid=4, block=256, args=(np.zeros(n, np.float32), x, y, n), **side.dev)
        return _np(r["out"]), x

    (want, _), (got, x) = on_both(scenario)
    assert_fma_close(got, want)
    np.testing.assert_allclose(got, 2.5 * x0 + 1.0, rtol=1e-6)
    assert x.numel() == 0
    kept = (np.zeros(n, np.float32), torch.from_numpy(x0).double(), torch.ones(2, n // 2))
    SAXPY[1].launch(grid=4, block=256, args=(*kept, n), donate=True, device="cpu")
    assert kept[1].numel() == n and kept[2].numel() == n
    with pytest.raises(CoxUnsupported, match="donated"):
        SAXPY[1].launch(grid=4, block=256, args=(np.zeros(n, np.float32), x, x, n), device="cpu")


def _donate_chained():
    """The donation payoff: an in-order stream relaunching over its own
    previous outputs, each step consuming the last step's buffer (the
    reference's chain, and the port's with ``donate=True``)."""
    n = 1024
    x0 = np.arange(n, dtype=np.float32) / n

    def scenario(side, donate):
        d, s, _ = side.fresh()
        cur, x, z = _arrays(side, np.zeros(n, np.float32), x0, np.zeros(n, np.float32))
        h = s.launch(side.k(SAXPY), grid=4, block=256, args=(cur, x, z, n))
        for _ in range(3):
            h = s.launch(side.k(SCALE), grid=4, block=256, args=(h.outputs["out"], h.outputs["out"], n), donate=donate)
        return _np(h.result()["out"])

    want = scenario(SIDES[0], False)
    for donate in (False, True):
        got = scenario(SIDES[1], donate)
        assert_fma_close(got, want)
    ref = 2.5 * x0
    for _ in range(3):
        ref = ref * 3.0 + 1.0
    np.testing.assert_allclose(want, ref, rtol=1e-5)


def _donate_producer_output():
    """A donating consumer consumes its producer's output; the in-flight
    pruning and the syncs treat it as complete, and the producer's handle
    says its output is gone."""
    n = 1024
    x0 = np.arange(n, dtype=np.float32) / n

    def scenario(side):
        d, s1, s2 = side.fresh()
        (x,) = _arrays(side, x0)
        h1 = s1.launch(side.k(SCALE), grid=4, block=256, args=(np.zeros(n, np.float32), x, n))
        h2 = s2.launch(
            side.k(SCALE), grid=4, block=256, args=(np.zeros(n, np.float32), h1.outputs["out"], n), donate=True
        )
        got = _np(h2.result()["out"])
        d.sync_all()
        s1.synchronize()
        assert h1.done() and h2.done()
        if side.port:
            with pytest.raises(CoxUnsupported, match="donated"):
                h1.result()
        return got

    want, got = on_both(scenario)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, (x0 * 3.0 + 1.0) * 3.0 + 1.0, rtol=1e-5)


def _donate_uncached_runtime():
    """``runtime.launch(donate=True)``: correct, and the donated input
    consumed."""
    n = 512
    x0 = np.arange(n, dtype=np.float32)
    ck = SAXPY[1].compiled(block=256)
    x, y = torch.from_numpy(x0.copy()), torch.ones(n)
    out = pruntime.launch(ck, grid=2, block=256, args=(torch.zeros(n), x, y, n), donate=True, device="cpu")
    np.testing.assert_allclose(out["out"].numpy(), 2.5 * x0 + 1.0, rtol=1e-6)
    assert x.numel() == 0 and y.numel() == 0
    with pytest.raises(CoxUnsupported, match="donated"):
        pruntime.launch(ck, grid=2, block=256, args=(torch.zeros(n), x, y, n), device="cpu")


def _donate_splits_cache():
    """A donating launch never shares a staged entry with a non-donating
    one of the same geometry."""
    for side in SIDES:
        o, x, y, n = _args(512)
        k = side.k(SAXPY)
        k.launch(grid=2, block=128, args=(o, x, y, n), **side.dev)
        n1 = len(k._launch_cache)
        k.launch(grid=2, block=128, args=(o, x, y, n), donate=True, **side.dev)
        assert len(k._launch_cache) == n1 + 1, side


def _donate_on_sharded():
    """Refused on the sharded backend: a donating launch on a one-rank
    mesh reaches the shared ``check_donate_supported``, in both
    packages."""
    import jax

    from repro.core.types import CoxUnsupported as RefUnsupported
    from repro_torch.core.backends.plan import check_donate_supported

    with pytest.raises(RefUnsupported, match="donate=True is unsupported on the sharded"):
        SAXPY[0].launch(grid=2, block=128, args=_args(512), donate=True, mesh=jax.make_mesh((1,), ("data",)))
    with one_rank_mesh() as mesh:
        with pytest.raises(CoxUnsupported, match="donate=True is unsupported on the sharded"):
            SAXPY[1].launch(grid=2, block=128, args=_args(512), donate=True, mesh=mesh)
    check_donate_supported("vmap", "_saxpy")


def _donate_stream_launch():
    """``Stream.launch(..., donate=True)`` on a CPU-pooled dispatcher:
    bitwise the plain launch, its tensor inputs consumed."""
    d = Dispatcher(devices=[torch.device("cpu")])
    s = pcox.Stream("don", d)
    o, x, y, n = _args(1024)
    want = SAXPY[1].launch(grid=4, block=256, args=(o, x, y, n), device="cpu")["out"]
    held = (torch.from_numpy(o), torch.from_numpy(x.copy()), torch.from_numpy(y.copy()))
    h = s.launch(SAXPY[1], grid=4, block=256, args=(*held, n), donate=True)
    assert torch.equal(h.result()["out"], want)
    assert all(t.numel() == 0 for t in held) and h.request.consumed == 3 * 4 * 1024


DONATE_CASES = {
    "donate_correct_and_consumes_inputs": _donate_correct,
    "donate_chained_stream_relaunch": _donate_chained,
    "donated_producer_output_does_not_break_bookkeeping": _donate_producer_output,
    "donate_uncached_runtime_launch": _donate_uncached_runtime,
    "donate_splits_launch_cache": _donate_splits_cache,
    "donate_rejected_on_sharded": _donate_on_sharded,
    "stream_launch_donate": _donate_stream_launch,
}


@pytest.mark.parametrize("case", sorted(DONATE_CASES))
def test_donation_waits_for_a93(case):
    """The reference's donation cases (named for the refusal they
    replace)."""
    DONATE_CASES[case]()


def test_failed_donating_attempt_is_not_retried(monkeypatch):
    """A donating attempt that fails after consuming its inputs takes no
    retry and no ladder rung (its inputs are gone, as the reference's
    donated buffers are); an injected dispatch fault fires before
    anything is consumed, so the ladder still saves the launch."""
    from repro_torch.core import errors

    d = Dispatcher(devices=[torch.device("cpu")])
    s = pcox.Stream("don", d)
    o, x, y, n = _args(1024)
    with pcox.faults.inject("_saxpy", site="dispatch", index=0, times=1, transient=True):
        held = tuple(torch.from_numpy(a.copy()) for a in (o, x, y))
        h = s.launch(SAXPY[1], grid=4, block=256, args=(*held, n), donate=True)
        h.result()
    assert d.retries == 1 and all(t.numel() == 0 for t in held)
    calls = []
    real = d._attempt

    def flaky(req, name):
        calls.append(req.consumed)
        out = real(req, name)
        raise errors.CoxLaunchError("lost after the run", transient=True)

    monkeypatch.setattr(d, "_attempt", flaky)
    held = tuple(torch.from_numpy(a.copy()) for a in (o, x, y))
    h = s.launch(SAXPY[1], grid=4, block=256, args=(*held, n), donate=True)
    with pytest.raises(errors.CoxLaunchError):
        h.result()
    assert calls == [0]


def test_side_helper_pools_the_cpu():
    """The port's side of every scenario runs on the host: its
    dispatchers pool the CPU, and a launch without device= lands there."""
    d, s, _ = Side(True).fresh()
    h = s.launch(SCALE[1], grid=1, block=256, args=(np.zeros(256, np.float32), np.ones(256, np.float32), 256))
    assert h.request.target == torch.device("cpu") and h.request.device is None
    assert h.result()["out"].device.type == "cpu"
