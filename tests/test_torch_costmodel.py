"""The port's per-launch cost estimate against the JAX package's.

``costmodel.estimate(mode="static")`` walks the IR (arithmetic
instructions x threads, twice the bound global bytes) and must give the
reference's record field by field for every runnable kernel of
``benchmarks/kernels_suite.py`` at its suite geometry and arguments.
The estimate is cached per launch shape; ``gflops``/``gbps`` turn a
measured time into rates; the dispatcher's telemetry rows carry the
estimate.  ``mode="xla"`` -- XLA's cost analysis of the compiled
program, which nothing in PyTorch reproduces without running the launch
-- raises ``CoxUnsupported`` naming ROADMAP A.9.3, at the call and, with
``COX_COSTMODEL=xla``, at the launch.
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
    _, preq = _requests(sorted(SUITE)[0])
    with pytest.raises(CoxUnsupported, match="A.9.3"):
        costmodel.estimate_request(preq, mode="xla")
    _, p, args = SUITE[sorted(SUITE)[0]]
    monkeypatch.setenv(costmodel.ENV_MODE, "xla")
    with pytest.raises(CoxUnsupported, match="A.9.3"):
        costmodel.telemetry_mode()
    with pytest.raises(CoxUnsupported, match="A.9.3"):
        p.kernel.launch(grid=p.grid, block=p.block, args=args, device="cpu")
    monkeypatch.setenv(costmodel.ENV_MODE, "static")
    assert costmodel.telemetry_mode() == "static"
