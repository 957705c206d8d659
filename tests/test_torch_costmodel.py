"""The port's per-launch cost estimate against the JAX package's.

``costmodel.estimate(mode="static")`` walks the IR (arithmetic
instructions x threads, twice the bound global bytes) and must give the
reference's record field by field for every runnable kernel of
``benchmarks/kernels_suite.py`` at its suite geometry and arguments.
The estimate is cached per launch shape; ``gflops``/``gbps`` turn a
measured time into rates; the dispatcher's telemetry rows carry the
estimate.  ``mode="xla"`` -- XLA's cost analysis of the compiled
program in the reference -- counts one launch of the shape op by op in
the port (``costmodel.OP_RULES``): positive counts for every runnable
suite kernel, the static record's shared-memory features, the static
walk with ``source='static'`` where the counting pass refuses the
launch, and ``COX_COSTMODEL=xla`` on the dispatcher's telemetry.
"""

import dataclasses

import pytest
import torch

from repro.core import costmodel as rcostmodel
from repro_torch.core import costmodel
from repro_torch.core.streams import Dispatcher
from repro_torch.core.types import CoxUnsupported
from torch_suite import pairs

SUITE = pairs("port_kernels_suite_costmodel")
FIELDS = [f.name for f in dataclasses.fields(costmodel.CostEstimate)]


def _requests(name):
    r, p, args = SUITE[name]
    rreq = r.kernel.make_request(grid=r.grid, block=r.block, args=args)
    preq = p.kernel.make_request(grid=p.grid, block=p.block, args=args, device="cpu")
    return rreq, preq


@pytest.mark.parametrize("name", sorted(SUITE))
def test_static_estimate_is_the_references(name):
    rreq, preq = _requests(name)
    want = rcostmodel.estimate_request(rreq, mode="static")
    got = costmodel.estimate_request(preq, mode="static")
    assert FIELDS == [f.name for f in dataclasses.fields(rcostmodel.CostEstimate)]
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), (name, f)


def test_estimate_is_cached_per_launch_shape():
    costmodel.clear_cache()
    _, preq = _requests(sorted(SUITE)[0])
    first = costmodel.estimate_request(preq)
    assert costmodel.estimate_request(preq) is first  # a cache hit
    costmodel.clear_cache()
    again = costmodel.estimate_request(preq)
    assert again is not first and again == first


def test_gflops_and_gbps():
    est = costmodel.CostEstimate(
        op_estimate=2e9,
        mem_estimate=4e9,
        coll_estimate=0.0,
        shared_footprint=0,
        peel_count=0,
        collective_density=0.0,
        source="static",
    )
    assert est.gflops(0.5) == 4.0 and est.gbps(2.0) == 2.0
    assert est.gflops(0.0) == 0.0 and est.gbps(-1.0) == 0.0
    ref = rcostmodel.CostEstimate(**dataclasses.asdict(est))
    assert ref.gflops(0.5) == est.gflops(0.5) and ref.gbps(2.0) == est.gbps(2.0)


def test_telemetry_rows_carry_the_estimate():
    name = "vectorAdd" if "vectorAdd" in SUITE else sorted(SUITE)[0]
    _, p, args = SUITE[name]
    d = Dispatcher(devices=[torch.device("cpu")])
    h = d.default.launch(p.kernel, grid=p.grid, block=p.block, args=args)
    h.result()
    (row,) = [r for r in d.telemetry() if r["kernel"] == p.kernel.name]
    est = costmodel.estimate_request(h.request)
    assert row["launches"] == 1 and row["estimate_source"] == "static"
    assert row["op_estimate"] == est.op_estimate and row["bytes"] == est.mem_estimate
    assert row["time_basis"] == "dispatch" and row["gflops"] > 0
    d.note_measurement(h.request, 0.5)
    (row,) = [r for r in d.telemetry() if r["kernel"] == p.kernel.name]
    assert row["time_basis"] == "measured" and row["gflops"] == pytest.approx(est.gflops(0.5))


def test_xla_mode_waits_for_a93(monkeypatch):
    """The reference's ``test_xla_estimate_positive`` and
    ``test_telemetry_mode_env`` (named for the refusal they replace):
    the counted record is positive and says 'xla'; ``COX_COSTMODEL``
    reads 'xla', anything unknown as 'static'; a launch under
    ``COX_COSTMODEL=xla`` keeps the counted record in its telemetry."""
    costmodel.clear_cache()
    _, preq = _requests("vectorAdd" if "vectorAdd" in SUITE else sorted(SUITE)[0])
    est = costmodel.estimate_request(preq, mode="xla")
    assert est.source == "xla" and est.op_estimate > 0 and est.mem_estimate > 0
    monkeypatch.delenv(costmodel.ENV_MODE, raising=False)
    assert costmodel.telemetry_mode() == "static"
    monkeypatch.setenv(costmodel.ENV_MODE, "xla")
    assert costmodel.telemetry_mode() == "xla"
    _, p, args = SUITE[preq.ck.kernel.name]
    d = Dispatcher(devices=[torch.device("cpu")])
    h = d.default.launch(p.kernel, grid=p.grid, block=p.block, args=args)
    h.result()
    (row,) = [r for r in d.telemetry() if r["kernel"] == p.kernel.name]
    assert row["estimate_source"] == "xla" and row["op_estimate"] == est.op_estimate
    monkeypatch.setenv(costmodel.ENV_MODE, "garbage")
    assert costmodel.telemetry_mode() == "static"


@pytest.mark.parametrize("name", sorted(SUITE))
def test_counted_estimate_of_every_suite_kernel(name):
    """The counted record of every runnable suite kernel: positive
    operations and bytes, the static walk's kernel features, and at
    least the bytes of the bound globals (each is read once, into the
    launch's own copy)."""
    costmodel.clear_cache()
    _, preq = _requests(name)
    est = costmodel.estimate_request(preq, mode="xla")
    st = costmodel.estimate_request(preq, mode="static")
    assert est.source == "xla" and est.op_estimate > 0, name
    assert est.mem_estimate >= costmodel.global_bytes(preq.ck, preq.shapes) / 2, name
    for f in ("shared_footprint", "peel_count", "collective_density"):
        assert getattr(est, f) == getattr(st, f), (name, f)


def test_count_op_rules():
    """The counting rules, op by op: a product is 2 m n k, a pointwise op
    its output elements, a reduction its input elements, a view nothing;
    bytes are operands plus outputs."""
    counter = costmodel.OpCounter()
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    with counter:
        torch.mm(a, b)
    assert counter.ops == 2 * 3 * 5 * 7 and counter.bytes == 4 * (15 + 35 + 21)
    counter = costmodel.OpCounter()
    with counter:
        a.add(1.0)
        a.sum()
        a[1:]
    assert counter.ops == 15 + 15 and counter.n_ops == 3
    assert counter.bytes == 4 * (15 + 15) + 4 * (15 + 1)


def test_counted_estimate_degrades_to_static(monkeypatch):
    """A launch the counting pass refuses (``CoxUnsupported``) takes the
    static record, named so; any other error is not caught."""
    from repro_torch.core import runtime

    costmodel.clear_cache()
    _, preq = _requests(sorted(SUITE)[0])

    def refuse(*a, **k):
        raise CoxUnsupported("refused")

    monkeypatch.setattr(runtime, "build_resolved", refuse)
    est = costmodel.estimate_request(preq, mode="xla")
    assert est == costmodel.estimate_request(preq, mode="static")
    assert est.source == "static"
    costmodel.clear_cache()

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(runtime, "build_resolved", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        costmodel.estimate_request(preq, mode="xla")
    costmodel.clear_cache()
