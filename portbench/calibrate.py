"""The readings that the limits of a cell are set from, at the cell's own
size, on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half_batch,grad_doubled] [--out FILE]

For every seed the program's compared first steps (as a benchmark run's
set-up takes them) against the reference's; for every control seed the
control (the reference in float8, ``reference.model.Numerics``) and each
planted fault (``program.train_step(fault=)``) against the same
reference.  One JSON line a reading, on standard output and in ``--out``.
Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import catalog, compare, program
    from portbench.drivers import train as drv

    cell = catalog.cell(args.workload)
    config = catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    dev = torch.device(args.device)
    if dev.type == "cuda":
        program.build_kernels()
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def side_readings(seed: int, fault: str = ""):
        t = time.perf_counter()
        prog = drv.Program(config, mix, seed, dev, fault)
        side = drv.program_readings(prog)
        prog.free()
        return side, prog.batch_at, time.perf_counter() - t

    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        side, batch_at, prog_s = side_readings(seed)
        t = time.perf_counter()
        ref = drv.reference_readings(config, seed, dev, batch_at)
        ref_s = time.perf_counter() - t
        rows = []
        if seed in args.seeds:
            rows.append(("program", side, prog_s))
        if seed in args.control_seeds:
            t = time.perf_counter()
            ctrl = drv.reference_readings(config, seed, dev, batch_at, precision="fp8")
            rows.append(("control_fp8", ctrl, time.perf_counter() - t))
            for f in faults:
                fs, _, fs_s = side_readings(seed, f)
                rows.append((f"fault_{f}", fs, fs_s))
        for who, readings, secs in rows:
            nums = compare.numbers(readings, ref)
            emit(
                {
                    "workload": args.workload,
                    "seed": seed,
                    "who": who,
                    **{k: v["value"] for k, v in nums.items()},
                    "where": {k: v["where"] for k, v in nums.items()},
                    "losses": readings.losses,
                    "ref_losses": ref.losses,
                    "seconds": secs,
                    "ref_seconds": ref_s,
                }
            )
        if seed == (args.seeds + args.control_seeds)[0]:
            emit({"workload": args.workload, "seed": seed, "who": "leaves", "ref_grad": ref.grad_norms,
                  "ref_change": ref.change_norms, "program_grad": side.grad_norms,
                  "program_change": side.change_norms})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
