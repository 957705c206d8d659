#!/usr/bin/env python3
"""The encoder-decoder main path's step times of several checkouts, on one CUDA card.

    python3 scripts/encdec_steps.py DIR [DIR ...]

Each DIR is a checkout of this repository (``.`` for this one).  For each
DIR, in the order given, a child process imports that checkout's
``chip_smoke.py`` and runs its seamless-m4t-large-v2 phases on the card:
the one-device server (``phase_serve``: bf16, full depth, batch 4, ctx
512, 4 requests) and the one-device train step (``phase_train``: bf16,
24 + 24 layers, batch 2 of 4,096, 3 steps).  Name two checkouts as
``A B B A`` to compare them within one call.  It prints each run's
``step_ms_median`` (serve) and ``step_ms_median_2_3`` (train), one JSON
object per line, then the card's name and power limit.
"""

import json
import pathlib
import subprocess
import sys

CHILD = """
import sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs import registry
cs.phase_device()
cs.phase_build()
cs.phase_serve(cs.cpu_token_count(cs.ENCDEC_ARCH), cs.ENCDEC_ARCH)
cs.phase_train(registry.get(cs.ENCDEC_ARCH), cs.ENCDEC_TRAIN)
"""

KEYS = {"encdec_serve": "step_ms_median", "encdec_train": "step_ms_median_2_3"}


def run(checkout: pathlib.Path) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=checkout, capture_output=True, text=True, timeout=900
    )
    if out.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {out.returncode}\n{out.stderr[-3000:]}")
    rec = {"checkout": str(checkout)}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            if r.get("phase") in KEYS:
                rec[r["phase"] + "_ms"] = r[KEYS[r["phase"]]]
    missing = [p for p in KEYS if p + "_ms" not in rec]
    if missing:
        raise RuntimeError(f"{checkout}: no record of {missing}")
    return rec


def main() -> int:
    dirs = [pathlib.Path(d).resolve() for d in sys.argv[1:]]
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        print(json.dumps(run(d)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
