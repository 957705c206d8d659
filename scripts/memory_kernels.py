#!/usr/bin/env python3
"""flash_decode, the norm forwards and the norm backwards at the main paths'
shapes, on one CUDA card.

    python3 scripts/memory_kernels.py [--src DIR] [--tag NAME]
                                      [--splits 1,2,...] [--team-rows 1,4,...]
    python3 scripts/memory_kernels.py --bwd [--src DIR] [--tag NAME]
                                      [--bwd-blocks 1,2,...]

Times the kernels through their wrappers (``flash_decode_cuda``,
``rmsnorm_cuda``, ``layernorm_cuda``) with the PyTorch call that computes
the same function beside each (SDPA, ``F.rms_norm``, ``F.layer_norm``):
CUDA events around batches of back-to-back calls, the median (``ms``,
as ``chip_smoke.py`` times them).  At the serving shapes a call's device
work is shorter than its host work, so ``ms`` reads the host there; those
shapes also report a CUDA graph of the calls replayed (``graph_ms``: the
device alone) and the wrapper's host time a call (``host_us``).

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit, so that two trees are compared in one call, in turns);
``--splits`` also times flash_decode's headline at each forced split
count (the wrapper's num_splits picks 4 there), ``--team-rows`` the bf16 norm headlines with each team walking
that many rows (the wrapper's NORM_ROWS is 4; about 21 is one wave of
three 256-thread blocks an SM).

``--bwd`` times the norm backwards instead (``rmsnorm_bwd_cuda``,
``layernorm_bwd_cuda``) at the main paths' bf16 shapes and the f32
headlines, against ``F.rms_norm``'s and ``F.layer_norm``'s backward alone
(``torch.autograd.grad`` through a kept graph), with each launch's device
time from ``torch.profiler`` by kernel name (``by_kernel``: pass 1, pass 2,
and the library's kernels), the bound (x and dy read, dx written, w read,
dw and db written, at 3.35 TB/s) and the errors against ``ref``'s
backward in f32; ``--bwd-blocks`` also times each case with the
wrapper's ``BWD_BLOCKS_PER_SM`` set to each value.

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

# flash_decode: (case, B, S, kv_len, H, Hkv), bf16, heads of 128: the
# long-context headline, then the serve phase's shape at qwen2.5-14b's
# 40/8 and granite-20b's 48/1 heads
DECODE = [
    ("headline", 8, 32768, [32768] * 8, 40, 8),
    ("serve", 4, 512, [300, 400, 500, 512], 40, 8),
    ("mqa_serve", 4, 512, [300, 400, 500, 512], 48, 1),
]
# the norms: (kernel, rows, cols, x dtype), w (and b) in f32: the
# headlines (qwen2.5-14b's and granite-20b's widths at the train phases'
# tokens, mamba2-130m's inner norm), the serving shapes and f32
NORMS = [
    ("rmsnorm", 8192, 5120, torch.bfloat16),
    ("rmsnorm", 32768, 1536, torch.bfloat16),
    ("rmsnorm", 4, 5120, torch.bfloat16),
    ("rmsnorm", 4, 768, torch.bfloat16),
    ("rmsnorm", 8192, 5120, torch.float32),
    ("layernorm", 8192, 6144, torch.bfloat16),
    ("layernorm", 32768, 6144, torch.bfloat16),
    ("layernorm", 4, 6144, torch.bfloat16),
    ("layernorm", 8192, 6144, torch.float32),
]
SERVE_ROWS = 4
# the norm backwards (--bwd): (kernel, rows, cols, x dtype), w in f32: the
# main paths' bf16 shapes (qwen2.5-14b's train step; mamba2-130m's inner
# norm, then its ln1 and final norm; granite-20b's train step and
# chip_smoke's case at four times its rows), then the f32 headlines
NORM_BWD = [
    ("rmsnorm", 8192, 5120, torch.bfloat16),
    ("rmsnorm", 32768, 1536, torch.bfloat16),
    ("rmsnorm", 32768, 768, torch.bfloat16),
    ("layernorm", 8192, 6144, torch.bfloat16),
    ("layernorm", 32768, 6144, torch.bfloat16),
    ("rmsnorm", 8192, 5120, torch.float32),
    ("layernorm", 8192, 6144, torch.float32),
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


def decode_cases(fa, gen, tag: str, splits: list) -> None:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, B, S, kv_len, H, Hkv in DECODE:
        q = torch.randn(B, H, 128, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, Hkv, 128, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, Hkv, 128, generator=gen, device="cuda").bfloat16()
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        mask = None
        if min(kv_len) < S:
            mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None]
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

        def kernel():
            return fa.flash_decode_cuda(q, k, v, lens)

        def library():
            return sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True)

        rec = {"kernel": "flash_decode", "case": case, "shape": [B, S, H, Hkv, 128]}
        rec["ms"] = median_ms(kernel)
        rec["library_ms"] = median_ms(library)
        if case != "headline":
            rec["graph_ms"] = graph_ms(kernel)
            rec["library_graph_ms"] = graph_ms(library)
            rec["host_us"] = host_us(kernel)
        emit(tag, rec)
        if case == "headline" and splits:
            picker = fa.num_splits
            try:
                for n in splits:
                    fa.num_splits = lambda *args, n=n: n
                    emit(tag, {"kernel": "flash_decode", "case": "headline", "splits": n,
                               "ms": median_ms(kernel)})
            finally:
                fa.num_splits = picker
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()


def norm_cases(norms, gen, tag: str, team_rows: list) -> None:
    F = torch.nn.functional
    for name, rows, cols, dtype in NORMS:
        x = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.3 * torch.randn(cols, generator=gen, device="cuda")
        b = 0.3 * torch.randn(cols, generator=gen, device="cuda")
        wl, bl = w.to(dtype), b.to(dtype)  # the library takes x's dtype
        if name == "rmsnorm":
            def kernel():
                return norms.rmsnorm_cuda(x, w)

            def library():
                return F.rms_norm(x, (cols,), wl, eps=1e-6)
        else:
            def kernel():
                return norms.layernorm_cuda(x, w, b)

            def library():
                return F.layer_norm(x, (cols,), wl, bl, eps=1e-6)

        rec = {"kernel": name, "shape": [rows, cols], "dtype": str(dtype).split(".")[1]}
        rec["ms"] = median_ms(kernel)
        rec["library_ms"] = median_ms(library)
        if rows == SERVE_ROWS:
            rec["graph_ms"] = graph_ms(kernel)
            rec["library_graph_ms"] = graph_ms(library)
            rec["host_us"] = host_us(kernel)
        emit(tag, rec)
        plan = getattr(norms, "norm_plan", None)
        if plan is not None and rows > SERVE_ROWS and dtype == torch.bfloat16:
            for walk in team_rows:
                def forced(r, c, dev, walk=walk):
                    warps, teams, _ = plan(r, c, dev)
                    return warps, teams, -(-r // (teams * walk))

                norms.norm_plan = forced
                try:
                    emit(tag, {"kernel": name, "shape": [rows, cols], "team_rows": walk,
                               "plan": forced(rows, cols, x.device), "ms": median_ms(kernel)})
                finally:
                    norms.norm_plan = plan
        del x
        torch.cuda.empty_cache()


def norm_bwd_cases(norms, ref, gen, tag: str, blocks: list) -> None:
    F = torch.nn.functional
    for name, rows, cols, dtype in NORM_BWD:
        ln = name == "layernorm"
        x = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.3 * torch.randn(cols, generator=gen, device="cuda")
        b = 0.3 * torch.randn(cols, generator=gen, device="cuda")
        dy = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
        leaves = [t.detach().requires_grad_(True) for t in (x, w.to(dtype), b.to(dtype))]
        if ln:
            y = F.layer_norm(leaves[0], (cols,), leaves[1], leaves[2], eps=1e-6)
            want = ref.layernorm_bwd(x.float(), w, b, dy.float())

            def kernel():
                return norms.layernorm_bwd_cuda(x, w, dy)
        else:
            leaves = leaves[:2]
            y = F.rms_norm(leaves[0], (cols,), leaves[1], eps=1e-6)
            want = ref.rmsnorm_bwd(x.float(), w, dy.float())

            def kernel():
                return norms.rmsnorm_bwd_cuda(x, w, dy)

        def library():
            return torch.autograd.grad(y, leaves, dy, retain_graph=True)

        got = kernel()
        errs = {
            g: float((a.float() - e).abs().max())
            for g, a, e in zip(("dx", "dw", "db"), got, want)
        }
        # x and dy read, dx written; w read, dw (and db) written
        nbytes = 3 * x.numel() * x.element_size() + (3 if ln else 2) * w.numel() * 4
        case = {"kernel": name + "_bwd", "shape": [rows, cols], "dtype": str(dtype).split(".")[1]}
        rec = {
            **case,
            "ms": median_ms(kernel),
            "library_ms": median_ms(library),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": errs,
            "by_kernel": device_ms(kernel),
            "library_by_kernel": device_ms(library),
        }
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        emit(tag, rec)
        default = norms.BWD_BLOCKS_PER_SM
        try:
            for k in blocks:
                norms.BWD_BLOCKS_PER_SM = k
                emit(tag, {**case, "bwd_blocks_per_sm": k, "ms": median_ms(kernel),
                           "by_kernel": device_ms(kernel)})
        finally:
            norms.BWD_BLOCKS_PER_SM = default
        del x, dy, leaves, y, want, got
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to import")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--splits", default="", help="forced split counts, comma-separated")
    ap.add_argument("--team-rows", default="", help="norm rows a team, comma-separated")
    ap.add_argument("--bwd", action="store_true", help="the norm backwards instead")
    ap.add_argument("--bwd-blocks", default="", help="BWD_BLOCKS_PER_SM values, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import norms, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    ints = lambda s: [int(t) for t in s.split(",") if t]  # noqa: E731
    if args.bwd:
        norm_bwd_cases(norms, ref, gen, args.tag, ints(args.bwd_blocks))
    else:
        decode_cases(fa, gen, args.tag, ints(args.splits))
        norm_cases(norms, gen, args.tag, ints(args.team_rows))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
