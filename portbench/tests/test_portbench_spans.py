"""The readers of the program's own spans (``program_spans`` and the five
metrics on it) and AdamW's byte count: None where a run holds nothing to
read (not traced, a program without a span recorder, spans without
device times as on the CPU), and the right numbers on a planted summary."""

import math
import pathlib
import sys
import time
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import catalog, program_spans, run  # noqa: E402
from portbench.arith.adamw_bytes import adamw_bytes  # noqa: E402
from portbench.drivers import train as drv  # noqa: E402
from portbench_small import reduced  # noqa: E402

READERS = ["forward_ms", "backward_ms", "recompute_ms", "adamw_roofline", "activations_kept_gib"]
GRANITE = catalog.config("granite-20b-4l")


def _span(name, device_ms, mem_delta=0, **attrs):
    return {"name": name, "attrs": attrs, "device_ms": device_ms, "mem_delta": mem_delta}


def _planted_step(scale):
    return [
        _span("train.forward", 60.0 * scale, mem_delta=3 * 2**30),
        _span("model.block", 10.0 * scale, layer=0),
        _span("train.backward", 150.0 * scale),
        _span("model.block", 11.0 * scale, layer=0, recompute=True),
        _span("model.block", 12.0 * scale, layer=1, recompute=True),
        _span("adamw.update", 130.0 * scale),
    ]


def _fake_run(n_steps=2, config=GRANITE):
    return types.SimpleNamespace(trace=types.SimpleNamespace(n_steps=lambda: n_steps), config=config)


@pytest.fixture
def planted(monkeypatch):
    from repro_torch import obs

    steps = {7: _planted_step(1.0), 8: _planted_step(2.0)}
    calls = []

    def summary(last_steps=None):
        calls.append(last_steps)
        return steps

    monkeypatch.setattr(obs, "summary", summary)
    return calls


def test_readers_on_a_planted_summary(planted):
    rec = _fake_run()
    got = {m: catalog.reader(m)(rec) for m in READERS}
    assert got["forward_ms"] == pytest.approx(90.0)
    assert got["backward_ms"] == pytest.approx(225.0)
    assert got["recompute_ms"] == pytest.approx(34.5)
    assert got["activations_kept_gib"] == pytest.approx(3.0)
    assert got["adamw_roofline"] == pytest.approx(100 * adamw_bytes(GRANITE) / 3.35e12 / 0.195)
    assert planted == [2] * len(READERS)  # each reads the run's traced steps


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(monkeypatch, name):
    from repro_torch import obs

    assert catalog.reader(name)(types.SimpleNamespace(trace=None, config=GRANITE)) is None
    cpu = {1: [dict(_span("train.forward", None, mem_delta=None), attrs={})]}
    monkeypatch.setattr(obs, "summary", lambda last_steps=None: cpu)
    assert catalog.reader(name)(_fake_run()) is None
    monkeypatch.setattr(obs, "summary", lambda last_steps=None: {})
    assert catalog.reader(name)(_fake_run()) is None


def test_a_program_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # import fails: an older program
    assert program_spans.steps(_fake_run()) is None


def test_a_broken_program_raises(monkeypatch):
    def import_module(name):
        # the recorder is there, but a module it imports is not
        raise ModuleNotFoundError(f"No module named {name}.missing", name=f"{name}.missing")

    monkeypatch.setattr(program_spans, "importlib", types.SimpleNamespace(import_module=import_module))
    with pytest.raises(ModuleNotFoundError):
        program_spans.steps(_fake_run())


def test_no_recompute_without_remat(monkeypatch):
    from repro_torch import obs

    rows = [r for r in _planted_step(1.0) if not r["attrs"].get("recompute")]
    monkeypatch.setattr(obs, "summary", lambda last_steps=None: {1: rows})
    rec = _fake_run(1)
    assert catalog.reader("recompute_ms")(rec) is None
    assert catalog.reader("forward_ms")(rec) == pytest.approx(60.0)


def test_adamw_bytes():
    # bf16 matrices at 24 B a parameter, the f32 norm weights and biases at 32 B
    by_size = {2: 0, 4: 0}
    for _, leaf in drv.leaves(drv.layout(GRANITE)):
        by_size[leaf.dtype.itemsize] += math.prod(leaf.shape)
    assert by_size[4] == 2 * GRANITE["d_model"] * (2 * GRANITE["n_layers"] + 1)
    assert adamw_bytes(GRANITE) == 24 * by_size[2] + 32 * by_size[4] == 43_641_077_760
    small = reduced(GRANITE)  # float32 everywhere
    assert adamw_bytes(small) == 32 * sum(math.prod(leaf.shape) for _, leaf in drv.leaves(drv.layout(small)))


def test_cpu_run_reports_none_of_them():
    cell = catalog.cell("granite-20b.train-2x4k")
    config = reduced(GRANITE)
    mix = {"kind": "train", "batch": 2, "seq": 64, "zipf_a": 1.2}
    rec = drv.run(cell, config, mix, seed=2**31 + 99, seconds=0.1, trace=True, device="cpu", t0=time.perf_counter())
    assert rec.correct and rec.trace.n_steps() == cell["trace_steps"]
    assert program_spans.steps(rec) is None  # spans recorded, but no device times on the CPU
    line = run.result_line(rec, [{"name": m, "unit": "x"} for m in READERS], traced=True)
    assert line["metrics"] == {}
