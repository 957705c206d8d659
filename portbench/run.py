"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is ``portbench/workloads/<cell>.json``;
it names its configuration (``portbench/configs/``) and its traffic mix
(``portbench/traffic/``), whose ``kind`` picks the driver
(``portbench/drivers/<kind>.py``).  ``BENCHMARK.json`` says which metrics
the run reports: the cell's end-to-end metrics untraced, its per-layer
metrics with ``--trace 1``, each read by ``portbench/metrics/<name>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), and last ``checks``, each compared number beside its limit;
the same numbers end standard error.  A run exits non-zero and prints no
result where there is no CUDA card (or fewer than the cell asks for),
where a name (the cell's, its configuration's family, ...) is unknown, where
the program cannot be imported, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package
    (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def result_line(run, names: list, traced: bool) -> dict:
    """The result's JSON object (``checks`` last)."""
    from portbench import catalog

    metrics = {}
    for m in names:
        value = catalog.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": run.correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": dict(run.device),
    }
    if traced and run.trace is not None and run.trace.ops:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s()
        out["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in run.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import catalog

    try:
        bench = catalog.benchmark()
        cell = catalog.cell(args.workload)
        config = catalog.config(cell["config"])
        catalog.family(config["family"])
        mix = catalog.traffic(cell["traffic"])
        driver = catalog.driver(mix["kind"])
    except catalog.Unknown as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    names = catalog.metrics_of(bench, args.workload, bool(args.trace))

    # every build of the program inside the checkout, at a fixed path
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 3

    run = driver.run(
        cell, config, mix, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda", t0=T0
    )
    run.device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": int(cell["chips"]),
        "memory_peak_bytes": run.peak_bytes,
        "name_and_power_limit": _power_limit(),
    }
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad} (JAX or the JAX package)", file=sys.stderr)
        return 4
    line = result_line(run, names, bool(args.trace))
    for k, v in run.checks.items():
        print(f"check {k}: {v['value']!r} (at {v['where']}) limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
