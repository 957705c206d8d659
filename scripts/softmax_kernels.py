#!/usr/bin/env python3
"""The softmax kernel at chip_smoke.py's shapes, on one CUDA card.

    python3 scripts/softmax_kernels.py [--src DIR] [--tag NAME]

Times ``softmax_cuda`` at every case of chip_smoke.py's SOFTMAX_CASES plus
64 x 152,067 in f32 and bf16 (rows off the 16-byte boundary), with
``torch.softmax`` beside each: CUDA events around batches of back-to-back
calls, the median (``ms``, as chip_smoke.py times them); a CUDA graph of
the calls replayed (``graph_ms``: the device alone, which the small cases'
eager calls do not show); the host time a call of 300 back-to-back
calls (``host_us``, as chip_smoke.py's ``wrapper_host`` line reads it);
each launch's device time from ``torch.profiler`` by kernel name
(``by_kernel``); the bound (x read and y written once at 3.35 TB/s) and
the share of it; the largest relative error against the plain version and
whether two calls agree bitwise; and the plan (regime, blocks a cluster,
clusters, stages, shared memory, waves), where the tree has one.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit, so that two trees are compared in one call, in turns:
parent, change, change, parent).

One JSON object per line, then the card's name and power limit as
``nvidia-smi`` prints them.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 152064  # qwen2.5-14b's vocabulary
# chip_smoke.py SOFTMAX_CASES, then 64 x 152,067 in f32
CASES = [
    ((64, VOCAB), torch.float32),
    ((64, VOCAB), torch.bfloat16),
    ((4096, 4096), torch.float32),
    ((3, 1001), torch.float32),
    ((3, 1001), torch.bfloat16),
    ((2, VOCAB), torch.float32),
    ((64, VOCAB + 3), torch.bfloat16),
    ((64, VOCAB + 3), torch.float32),
]
HBM_BYTES_PER_S = 3.35e12


def median_ms(fn, batches: int = 7, calls: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time a call: the calls captured in one CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, batches=reps, calls=1) / calls


def host_us(fn, calls: int = 300) -> float:
    """Host time a call of back-to-back calls (the device work queues
    behind them, so the host clock reads the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel_name(key: str) -> str:
    """A profiler key without return type, namespaces, template arguments
    and parameters."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1]


def device_ms(fn, calls: int = 10) -> dict:
    """{kernel: [device ms a call, launches a call]} from torch.profiler."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms, n = out.get(kernel_name(e.key), (0.0, 0.0))
            out[kernel_name(e.key)] = [ms + e.self_device_time_total / 1e3 / calls,
                                       n + e.count / calls]
    return out


def emit(tag: str, rec: dict) -> None:
    print(json.dumps({"tree": tag, **rec}), flush=True)


def plan_of(sm, x) -> dict:
    """The tree's plan for x, where it has one."""
    if not hasattr(sm, "softmax_plan"):
        return {}
    rows = x.numel() // x.shape[-1]
    return sm.softmax_plan(rows, x.shape[-1], x.dtype, x.device).summary(rows)


def cases(sm, ref, gen, tag: str) -> None:
    for shape, dtype in CASES:
        x = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

        def kernel():
            return sm.softmax_cuda(x)

        def library():
            return torch.softmax(x, dim=-1)

        got = kernel()
        want = ref.softmax(x)
        rel = float(((got.float() - want.float()).abs() / want.float().abs()).max())
        nbytes = 2 * x.numel() * x.element_size()
        rec = {
            "kernel": "softmax",
            "shape": list(shape),
            "dtype": str(dtype).split(".")[1],
            "plan": plan_of(sm, x),
            "ms": median_ms(kernel),
            "graph_ms": graph_ms(kernel),
            "library_ms": median_ms(library),
            "library_graph_ms": graph_ms(library),
            "host_us": host_us(kernel),
            "library_host_us": host_us(library),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "max_rel_err": rel,
            "bitwise_twice": bool(torch.equal(got, kernel())),
            "by_kernel": device_ms(kernel),
            "library_by_kernel": device_ms(library),
        }
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        emit(tag, rec)
        del x, got, want
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to import")
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax as sm

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases(sm, ref, gen, args.tag)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
