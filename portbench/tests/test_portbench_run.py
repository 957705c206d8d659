"""A run of the harness with the look for a card skipped: on the CPU, at a
reduced size of each cell's configuration, the sound program comes out
correct, and each fault that a training cell can have, planted under the
timed path, comes out not correct against the cell's own limits; so does
the control (the reference in float8).  Without a card, ``run.py`` exits
non-zero and prints no result."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import catalog, compare, run  # noqa: E402
from portbench.drivers import train as drv  # noqa: E402
from portbench_small import reduced  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
MIX = {"kind": "train", "batch": 2, "seq": 64, "zipf_a": 1.2}
SEED = 2**31 + 1234


def small_run(cell_name: str, dtype: str, fault: str = "", trace: bool = False):
    cell = catalog.cell(cell_name)
    config = reduced(catalog.config(cell["config"]), dtype)
    return drv.run(
        cell, config, MIX, seed=SEED, seconds=0.2, trace=trace, device="cpu", t0=time.perf_counter(), fault=fault
    )


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    rec = small_run(cell, "float32", trace=True)
    assert rec.correct, rec.checks
    line = run.result_line(rec, [{"name": "train_tokens_per_s", "unit": "tokens/s"}], traced=True)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert set(line["checks"]) == set(compare.NUMBERS)
    assert line["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "grad_doubled", "update_doubled"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    rec = small_run(cell, "float32", fault=fault)
    assert not rec.correct, rec.checks
    line = json.loads(json.dumps(run.result_line(rec, [], traced=False)))
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(cell):
    c = catalog.cell(cell)
    config = reduced(catalog.config(c["config"]), "bfloat16")
    prog = drv.Program(config, MIX, SEED, torch.device("cpu"))
    ref = drv.reference_readings(config, SEED, torch.device("cpu"), prog.batch_at)
    ctrl = drv.reference_readings(config, SEED, torch.device("cpu"), prog.batch_at, precision="fp8")
    correct, checks = compare.judge(compare.numbers(ctrl, ref), c["limits"])
    assert not correct, checks


def _cpu_only_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=_cpu_only_env(), timeout=300,
    )
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[-1], "--seed", "7", "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, capture_output=True, text=True, env=_cpu_only_env(), timeout=300,
    )
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_unknown_workload_is_refused():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nope", "--seed", "7", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, env=_cpu_only_env(), timeout=300,
    )
    assert out.returncode != 0 and "{" not in out.stdout
