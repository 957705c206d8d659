"""The port's autotuner, measured cost model and telemetry against the
JAX package's.

The cases of ``tests/test_autotune.py`` run on the port (its launches on
the CPU, every tuner fixture on a temporary cache file), with the same
kernel source parsed by both packages and the same inputs:

* chunk resolution is one resolved field (``ResolvedLaunch.chunk`` and
  ``chunk_source``), the reference's field for field, and the tuner
  moves only knobs left on auto -- an explicit ``chunk=``/``backend=``/
  ``warp_exec=`` is never overridden;
* a tuned launch is bitwise the heuristic launch and the reference's;
  the winner is persisted (version-stamped, atomic), and a warm lookup,
  in memory or from disk in a simulated fresh process, measures nothing;
* a corrupt, truncated or stale cache file degrades to the heuristics,
  concurrent writers never tear the file, ``COX_AUTOTUNE_CACHE=off``
  leaves the disk alone;
* the cost model gives positive records in both modes, the footprint
  scales with the chunk, and the dispatcher's telemetry rows and
  ``health()`` carry the estimate and the tuner's counters; the
  reference's ``benchmarks.roofline.from_telemetry`` reads the port's
  rows unchanged.

Beside them: the two autotune cases of ``tests/test_grid_stride.py``,
the candidate set of the port's tuner against the reference's for the
same kernels and shapes, and a check that no port module reads or
writes the reference's cache file.
"""

import json
import os
import pathlib
import threading

import numpy as np
import pytest
import torch

from repro.core import autotune as rat
from repro.core import runtime as rrt
from repro_torch.core import autotune as at
from repro_torch.core import costmodel
from repro_torch.core import runtime as rt
from repro_torch.core.backends.plan import DEFAULT_CHUNK
from repro_torch.core.streams import Dispatcher
from repro_torch.core.types import CoxUnsupported
from torch_suite import define

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _atSaxpy(c, out, x, y, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.0 * x[i] + y[i]


def _atGridSum(c, out, x):
    s = c.shared(32, cox.f32)
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    s[c.thread_idx()] = x[i]
    c.syncthreads()
    if c.thread_idx() == 0:
        acc = 0.0
        for j in range(32):
            acc = acc + s[j]
        out[c.block_idx()] = acc


def _atGridSync(c, out, x):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    out[i] = x[i] * 2.0
    c.grid_sync()
    out[i] = out[i] + 1.0


def _annot(**kinds):
    def annotations(m):
        table = {"f": m.Array(m.f32), "n": m.i32}
        return {name: table[k] for name, k in kinds.items()}

    return annotations


SAXPY = define(_atSaxpy, _annot(out="f", x="f", y="f", n="n"))
GRID_SUM = define(_atGridSum, _annot(out="f", x="f"))
GRID_SYNC = define(_atGridSync, _annot(out="f", x="f"))
P_SAXPY, P_GRID_SUM, P_GRID_SYNC = SAXPY[1], GRID_SUM[1], GRID_SYNC[1]

GRID, BLOCK = 16, 64
N = GRID * BLOCK


def _args():
    x = np.arange(N, dtype=np.float32) / N
    y = np.ones(N, np.float32)
    return (np.zeros(N, np.float32), x, y, N)


def _req(kern=P_SAXPY, **kw):
    kw.setdefault("grid", GRID)
    kw.setdefault("block", BLOCK)
    kw.setdefault("args", _args())
    return kern.make_request(device="cpu", **kw)


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """Isolated autotune state: fresh counters, a tmp cache file."""
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv(at.ENV_CACHE, str(cache))
    monkeypatch.delenv(at.ENV_ENABLE, raising=False)
    at.reset()
    yield cache
    at.reset()


# ---------------------------------------------------------------------------
# chunk resolution: one resolved field, explicit never overridden
# ---------------------------------------------------------------------------


class TestChunkResolution:
    def test_heuristic_default(self):
        ck = P_SAXPY.compiled(block=BLOCK)
        for chunk in (None, "auto"):
            got = rt.resolve_chunk(ck, GRID, chunk)
            assert got == (min(GRID, DEFAULT_CHUNK), "heuristic")
            assert got == rrt.resolve_chunk(SAXPY[0].compiled(block=BLOCK), GRID, chunk)

    def test_explicit(self):
        ck = P_SAXPY.compiled(block=BLOCK)
        assert rt.resolve_chunk(ck, GRID, 3) == (3, "explicit")
        assert rt.resolve_chunk(ck, GRID, 999) == (GRID, "explicit")
        with pytest.raises(ValueError):
            rt.resolve_chunk(ck, GRID, 0)

    def test_resolved_launch_carries_source(self):
        req = _req(chunk=5)
        assert (req.rl.chunk, req.rl.chunk_source, req.chunk) == (5, "explicit", 5)
        req = _req()
        assert (req.rl.chunk, req.rl.chunk_source) == (min(GRID, DEFAULT_CHUNK), "heuristic")
        ref = SAXPY[0].make_request(grid=GRID, block=BLOCK, args=_args())
        assert (req.rl.backend, req.rl.warp_exec, req.rl.chunk) == (
            ref.rl.backend,
            ref.rl.warp_exec,
            ref.rl.chunk,
        )

    def test_explicit_never_autotuned(self, tuner):
        req = _req(chunk=5, autotune=True)
        assert (req.rl.chunk, req.rl.chunk_source) == (5, "explicit")

    def test_explicit_backend_never_autotuned(self, tuner):
        req = _req(backend="scan", warp_exec="serial", chunk=5, autotune=True)
        assert (req.rl.backend, req.rl.warp_exec, req.rl.chunk) == ("scan", "serial", 5)
        assert at.stats()["measurements"] == 0

    def test_tuned_source_marked(self, tuner):
        req = _req(autotune=True)
        assert req.rl.backend in ("scan", "vmap") and req.rl.chunk >= 1
        assert req.rl.chunk_source == "autotuned" and at.stats()["tuned"] >= 1


# ---------------------------------------------------------------------------
# tuning correctness + persistence
# ---------------------------------------------------------------------------


class TestTune:
    def test_cold_tune_writes_cache(self, tuner):
        out = P_SAXPY.launch(grid=GRID, block=BLOCK, args=_args(), autotune=True, device="cpu")
        want = 2.0 * np.arange(N, dtype=np.float32) / N + 1.0
        np.testing.assert_allclose(out["out"].numpy(), want, rtol=1e-6)
        st = at.stats()
        assert st["misses"] == 1 and st["measurements"] > 0 and st["disk_writes"] == 1
        doc = json.loads(tuner.read_text())
        assert doc["version"] == at.AUTOTUNE_VERSION == rat.AUTOTUNE_VERSION
        assert len(doc["entries"]) == 1
        rec = next(iter(doc["entries"].values()))
        assert rec["backend"] in ("scan", "vmap") and rec["chunk"] >= 1
        assert rec["op_estimate"] > 0 and rec["mem_estimate"] > 0
        assert rec["fingerprint"] == at.cpu_fingerprint(CPU)

    def test_warm_memory_hit(self, tuner):
        _req(autotune=True)
        n = at.stats()["measurements"]
        req = _req(autotune=True)
        st = at.stats()
        assert st["hits"] == 1 and st["measurements"] == n and req.rl.chunk >= 1

    def test_warm_disk_hit_fresh_process(self, tuner):
        req1 = _req(autotune=True)
        cold = at.stats()["measurements"]
        at.reset(memory_only=True)  # simulated fresh process, disk intact
        req2 = _req(autotune=True)
        st = at.stats()
        assert st["disk_hits"] == 1 and st["measurements"] == cold
        knobs = lambda r: (r.rl.backend, r.rl.warp_exec, r.rl.chunk, r.rl.schedule)  # noqa: E731
        assert knobs(req2) == knobs(req1)

    def test_bitwise_equal_grid_sum(self, tuner):
        x = np.random.default_rng(0).random(8 * 32).astype(np.float32)
        args = (np.zeros(8, np.float32), x)
        base = P_GRID_SUM.launch(grid=8, block=32, args=args, device="cpu")
        tuned = P_GRID_SUM.launch(grid=8, block=32, args=args, autotune=True, device="cpu")
        ref = GRID_SUM[0].launch(grid=8, block=32, args=args)
        np.testing.assert_array_equal(tuned["out"].numpy(), base["out"].numpy())
        np.testing.assert_array_equal(tuned["out"].numpy(), np.asarray(ref["out"]))

    def test_heuristic_cell_always_candidate(self, tuner):
        _req(autotune=True)
        rec = next(iter(at.entries().values()))
        rl = rt.resolve_launch(P_SAXPY.compiled(block=BLOCK), grid=GRID, block=BLOCK)
        heur = "%s/%s/c%d" % (rl.backend, rl.warp_exec, rl.chunk)
        assert heur in rec["times_us"], sorted(rec["times_us"])

    def test_env_enable_tunes_all_auto(self, tuner, monkeypatch):
        monkeypatch.setenv(at.ENV_ENABLE, "1")
        _req()
        assert at.stats()["misses"] == 1


# ---------------------------------------------------------------------------
# cache robustness
# ---------------------------------------------------------------------------


class TestCacheRobustness:
    def test_corrupt_cache_falls_back(self, tuner):
        tuner.write_text("{not json at all")
        req = _req(autotune=True)
        assert req.rl.chunk >= 1 and at.stats()["load_errors"] >= 1
        assert json.loads(tuner.read_text())["version"] == at.AUTOTUNE_VERSION

    def test_truncated_cache_falls_back(self, tuner):
        _req(autotune=True)
        whole = tuner.read_text()
        tuner.write_text(whole[: len(whole) // 2])
        at.reset()
        req = _req(autotune=True)
        st = at.stats()
        assert st["load_errors"] >= 1 and st["misses"] == 1 and req.rl.chunk >= 1

    def test_stale_version_invalidates(self, tuner):
        _req(autotune=True)
        doc = json.loads(tuner.read_text())
        doc["version"] = at.AUTOTUNE_VERSION - 1
        tuner.write_text(json.dumps(doc))
        at.reset()
        _req(autotune=True)
        st = at.stats()
        assert st["disk_hits"] == 0 and st["misses"] == 1

    def test_wrong_shape_entries_tolerated(self, tuner):
        tuner.write_text(json.dumps({"version": at.AUTOTUNE_VERSION, "entries": ["not", "a", "map"]}))
        _req(autotune=True)
        assert at.stats()["load_errors"] >= 1

    def test_concurrent_writers_atomic(self, tuner):
        recs = {f"key-{i}": {"backend": "scan", "warp_exec": "serial", "chunk": i + 1} for i in range(16)}
        errs = []

        def save(k):
            try:
                at._save_disk(str(tuner), {k: recs[k]})
            except Exception as e:  # pragma: no cover - the failure mode
                errs.append(e)

        threads = [threading.Thread(target=save, args=(k,)) for k in recs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        doc = json.loads(tuner.read_text())  # never torn
        assert doc["version"] == at.AUTOTUNE_VERSION
        assert doc["entries"] and set(doc["entries"]) <= set(recs)
        for k, v in doc["entries"].items():
            assert v == recs[k]

    def test_cache_off_env(self, tuner, monkeypatch):
        monkeypatch.setenv(at.ENV_CACHE, "off")
        _req(autotune=True)
        st = at.stats()
        assert st["misses"] == 1 and st["disk_writes"] == 0
        assert at.cache_path() is None and not tuner.exists()

    def test_no_leftover_temp_files(self, tuner):
        _req(autotune=True)
        assert [p for p in os.listdir(tuner.parent) if p.startswith(".autotune-")] == []


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


class TestCostModel:
    def test_static_estimate_positive(self):
        req = _req()
        est = costmodel.estimate(req.ck, req.rl, req.shapes, mode="static")
        assert est.source == "static" and est.op_estimate > 0 and est.mem_estimate > 0
        assert est.gflops(1.0) == pytest.approx(est.op_estimate / 1e9)
        assert est.gflops(0.0) == 0.0

    def test_xla_estimate_positive(self):
        req = _req()
        est = costmodel.estimate(req.ck, req.rl, req.shapes, mode="xla", device="cpu")
        assert est.source == "xla" and est.op_estimate > 0 and est.mem_estimate > 0

    def test_estimate_cached(self):
        req = _req()
        a = costmodel.estimate(req.ck, req.rl, req.shapes, mode="static")
        assert costmodel.estimate(req.ck, req.rl, req.shapes, mode="static") is a

    def test_footprint_scales_with_chunk(self):
        req = _req(P_GRID_SUM, grid=8, block=32, args=(np.zeros(8, np.float32), np.zeros(8 * 32, np.float32)))
        f4 = costmodel.chunk_footprint(req.ck, req.shapes, chunk=4, n_warps=1)
        f8 = costmodel.chunk_footprint(req.ck, req.shapes, chunk=8, n_warps=1)
        assert f8 == 2 * f4 > 0
        fb = costmodel.chunk_footprint(req.ck, req.shapes, chunk=4, n_warps=2, warp_exec="batched")
        assert fb > f4

    def test_kernel_features_shared(self):
        shared, peels, density = costmodel.kernel_features(P_GRID_SUM.compiled(block=32))
        assert shared == 32 * 4 and peels >= 0 and 0.0 <= density <= 1.0

    def test_telemetry_mode_env(self, monkeypatch):
        monkeypatch.delenv(costmodel.ENV_MODE, raising=False)
        assert costmodel.telemetry_mode() == "static"
        monkeypatch.setenv(costmodel.ENV_MODE, "xla")
        assert costmodel.telemetry_mode() == "xla"
        monkeypatch.setenv(costmodel.ENV_MODE, "garbage")
        assert costmodel.telemetry_mode() == "static"


# ---------------------------------------------------------------------------
# dispatcher telemetry + health
# ---------------------------------------------------------------------------


def _cpu_stream(name):
    from repro_torch.core import cox

    d = Dispatcher(devices=[CPU])
    return d, cox.Stream(name, dispatcher=d)


class TestTelemetry:
    def test_rows_recorded(self):
        d, s = _cpu_stream("telemetry-test")
        s.launch(P_SAXPY, grid=GRID, block=BLOCK, args=_args()).result()
        (row,) = d.telemetry()
        assert row["kernel"] == "_atSaxpy" and row["launches"] == 1 and row["chunk"] >= 1
        assert row["chunk_source"] in ("heuristic", "explicit", "cooperative", "autotuned")
        assert row["op_estimate"] > 0 and row["mem_estimate"] > 0
        assert row["estimate_source"] in ("static", "xla")
        assert row["time_basis"] in ("dispatch", "measured") and row["s_per_launch"] > 0

    def test_health_carries_autotune_and_telemetry(self):
        d, s = _cpu_stream("health-test")
        s.launch(P_SAXPY, grid=GRID, block=BLOCK, args=_args()).result()
        h = d.health()
        assert h["telemetry_keys"] == 1 and h["dispatch_s"] > 0 and h["bytes"] > 0
        assert isinstance(h["autotune"], dict)
        assert set(h["autotune"]) >= {"hits", "misses", "measurements"}
        assert set(h["autotune"]) == set(rat.stats())

    def test_roofline_from_telemetry(self):
        from benchmarks.roofline import from_telemetry

        d, s = _cpu_stream("roofline-test")
        s.launch(P_SAXPY, grid=GRID, block=BLOCK, args=_args()).result()
        (r,) = from_telemetry(d.telemetry(), peak_flops=1e9, mem_bw=1e9)
        assert r["dominant"] in ("compute", "memory")
        assert r["t_compute"] > 0 and r["t_memory"] > 0
        assert 0.0 <= r["roofline_fraction"] <= 1.0


# ---------------------------------------------------------------------------
# cooperative launches pin the chunk
# ---------------------------------------------------------------------------


class TestCooperative:
    ARGS = (np.zeros(4 * 32, np.float32), np.ones(4 * 32, np.float32))

    def test_chunk_pinned_to_grid(self):
        req = _req(P_GRID_SYNC, grid=4, block=32, args=self.ARGS)
        assert (req.rl.chunk, req.rl.chunk_source) == (4, "cooperative")

    def test_explicit_small_chunk_rejected(self):
        with pytest.raises(CoxUnsupported):
            _req(P_GRID_SYNC, grid=4, block=32, chunk=2, args=self.ARGS)

    def test_autotune_respects_cooperative(self, tuner):
        req = _req(P_GRID_SYNC, grid=4, block=32, autotune=True, args=self.ARGS)
        assert (req.rl.chunk, req.rl.chunk_source) == (4, "cooperative")
        got = P_GRID_SYNC.launch(grid=4, block=32, args=self.ARGS, autotune=True, device="cpu")
        want = GRID_SYNC[0].launch(grid=4, block=32, args=self.ARGS)
        np.testing.assert_array_equal(got["out"].numpy(), np.asarray(want["out"]))


# ---------------------------------------------------------------------------
# tests/test_grid_stride.py's autotune cases: grid-stride cells replace the
# blind chunk clamp
# ---------------------------------------------------------------------------


def _saxpy_rl(**kw):
    ck = P_SAXPY.compiled(block=64)
    rl = rt.resolve_launch(ck, grid=4096, block=64, backend="vmap", warp_exec="serial", **kw)
    return ck, rl


SHAPES = {"out": (256,), "x": (256,), "y": (256,)}


def test_autotune_candidates_stride_when_no_chunk_fits(monkeypatch):
    monkeypatch.setenv(costmodel.ENV_BUDGET, str(4 << 10))
    ck, rl = _saxpy_rl()
    rl = rt.resolve_schedule(ck, rl, SHAPES)
    assert rl.schedule == "grid_stride"
    assert at._chunk_candidates(ck, rl, SHAPES, warp_exec="serial", tunable_chunk=True, allow_empty=True) == []
    cands = at._candidates(ck, rl, SHAPES, tunable=(False, False, True, True))
    assert cands and all(c.schedule == "grid_stride" for c in cands)
    assert all(c.label.split("/")[-1].startswith("gs") for c in cands)
    exp = {
        costmodel.resident_slots(ck, SHAPES, grid=4096, n_warps=rl.n_warps, warp_exec="serial"),
        rl.n_resident,
    }
    assert {c.n_resident for c in cands} <= exp


def test_autotune_clamp_survives_only_when_chunked_is_pinned(monkeypatch):
    monkeypatch.setenv(costmodel.ENV_BUDGET, "64")
    ck, rl = _saxpy_rl(schedule="chunked")
    assert at._chunk_candidates(ck, rl, SHAPES, warp_exec="serial", tunable_chunk=True) == [1]
    cands = at._candidates(ck, rl, SHAPES, tunable=(False, False, True, False))
    assert all(c.schedule == "chunked" for c in cands)


# ---------------------------------------------------------------------------
# the candidate set is the reference's
# ---------------------------------------------------------------------------

CANDIDATE_CASES = {
    "saxpy_all_auto": (SAXPY, dict(grid=GRID, block=BLOCK), {}, "1111", None),
    "saxpy_batched_plane": (SAXPY, dict(grid=GRID, block=BLOCK), {"collapse": "hier"}, "1111", None),
    "saxpy_chunk_only": (SAXPY, dict(grid=GRID, block=BLOCK, backend="vmap"), {}, "0011", None),
    "saxpy_over_budget": (SAXPY, dict(grid=4096, block=64), {}, "1111", str(4 << 10)),
    "saxpy_pinned_chunked": (SAXPY, dict(grid=4096, block=64, schedule="chunked"), {}, "1110", "64"),
    "grid_sum": (GRID_SUM, dict(grid=8, block=32), {}, "1111", None),
    "grid_sync": (GRID_SYNC, dict(grid=4, block=32), {}, "1100", None),
}


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_candidates_are_the_references(case, monkeypatch):
    """For the same kernel, shapes and tunable mask, the port's tuner
    measures the reference's cells, in the reference's order."""
    pair, launch, compile_kw, mask, budget = CANDIDATE_CASES[case]
    if budget is not None:
        monkeypatch.setenv(costmodel.ENV_BUDGET, budget)
    grid = launch["grid"]
    n = 4 * 32 if pair is GRID_SYNC else (grid * launch["block"] if pair is not GRID_SUM else 8 * 32)
    shapes = {"out": (n,), "x": (n,), "y": (n,)} if pair is SAXPY else {"out": (n,), "x": (n,)}
    tunable = tuple(c == "1" for c in mask)
    got, want = [], []
    for kern, runtime, tuner, out in ((pair[1], rt, at, got), (pair[0], rrt, rat, want)):
        ck = kern.compiled(block=launch["block"], **compile_kw)
        rl = runtime.resolve_launch(ck, **launch)
        rl = runtime.resolve_schedule(ck, rl, shapes)
        out.extend(c.key for c in tuner._candidates(ck, rl, shapes, tunable=tunable))
    assert got == want and got


def test_no_port_module_touches_the_references_cache(tmp_path, monkeypatch):
    """The port keeps its own default file: no module of it names the
    reference's ``~/.cache/cox/autotune.json``, and a tune with no
    ``COX_AUTOTUNE_CACHE`` writes the port's file under ``HOME``."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert "autotune.json" not in path.read_text(), path
    monkeypatch.delenv(at.ENV_CACHE, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    at.reset()
    assert at.cache_path() == str(tmp_path / ".cache" / "cox" / "autotune_torch.json")
    _req(autotune=True)
    assert sorted(p.name for p in (tmp_path / ".cache" / "cox").iterdir()) == ["autotune_torch.json"]
    at.reset()
