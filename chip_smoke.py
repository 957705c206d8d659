#!/usr/bin/env python3
"""Smoke run of the repro_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the widths of qwen2.5-14b
(vocabulary 152,064; d_model 5,120), launches COX kernels on CUDA tensors
against the port's numpy oracle, and runs the three-way check of
``examples/cox_kernels_in_models.py`` in the port: a COX warp-collective
kernel, the CUDA kernel and the plain version agree.  Each phase prints
one JSON line; the last line is ``{"ok": true, "device": {...}}``.

It needs a CUDA card and fails without one, and imports neither ``jax``
nor the JAX package.  The COX kernels are defined in this file because
the frontend parses kernel source with ``inspect.getsource``.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import cox, execute, oracle  # noqa: E402
from repro_torch.core.typeinfer import infer  # noqa: E402
from repro_torch.core.types import ArraySpec  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import softmax as sm  # noqa: E402
from repro_torch.kernels import warp_reduce as wr  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
VOCAB = 152064  # qwen2.5-14b vocabulary (src/repro/configs/qwen2_5_14b.py)
D_MODEL = 5120  # qwen2.5-14b d_model
MM_N = 320  # CUDA SDK matrixMul sample: default width of A
VEC_N = 50000  # CUDA SDK vectorAdd sample: default element count
DEVICE = "cuda"  # the COX and three-way phases also run on "cpu" for a rehearsal
SOFTMAX_ROWS = 2  # three-way softmax: rows of the full vocabulary, one warp each
STATS_ROWS = 64  # three-way row reduction: rows of d_model width


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# COX kernels (restricted-Python CUDA, parsed from this file)
# ---------------------------------------------------------------------------


@cox.kernel
def vectorAdd(
    c,
    out: cox.Array(cox.f32),
    a: cox.Array(cox.f32),
    b: cox.Array(cox.f32),
    n: cox.i32,
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] + b[i]


@cox.kernel
def MatrixMulCUDA(
    c,
    out: cox.Array(cox.f32),
    a: cox.Array(cox.f32),
    b: cox.Array(cox.f32),
    n: cox.i32,
):
    # the SDK's tiled 16x16 matmul, <<<dim3(n/16, n/16), dim3(16, 16)>>>;
    # the tile loop is bounded by the module constant MM_N
    tile_a = c.shared((16, 16), cox.f32)
    tile_b = c.shared((16, 16), cox.f32)
    ty = c.thread_idx("y")
    tx = c.thread_idx("x")
    row = c.block_idx("y") * 16 + ty
    col = c.block_idx("x") * 16 + tx
    acc = 0.0
    for t in range(0, MM_N, 16):
        tile_a[ty, tx] = a[row * n + t + tx]
        tile_b[ty, tx] = b[(t + ty) * n + col]
        c.syncthreads()
        for kk in range(16):
            acc = acc + tile_a[ty, kk] * tile_b[kk, tx]
        c.syncthreads()
    out[row * n + col] = acc


@cox.kernel
def warpReduce(c, out: cox.Array(cox.f32), val: cox.Array(cox.f32)):
    # reduce4's shape: shfl_down within each warp, then across warps
    tile = c.shared((8,), cox.f32)
    tid = c.thread_idx()
    v = val[c.block_idx() * c.block_dim() + tid]
    offset = 16
    while offset > 0:
        s = c.shfl_down(v, offset)
        v = v + s
        offset = offset // 2
    if c.lane_id() == 0:
        tile[c.warp_id()] = v
    c.syncthreads()
    if tid < 8:
        w = tile[tid]
        off2 = 4
        while off2 > 0:
            s2 = c.shfl_down(w, off2, width=8)
            w = w + s2
            off2 = off2 // 2
        if tid == 0:
            out[c.block_idx()] = w


@cox.kernel
def voteBallot(
    c,
    any_out: cox.Array(cox.i32),
    all_out: cox.Array(cox.i32),
    bits: cox.Array(cox.u32),
    inp: cox.Array(cox.i32),
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    p = inp[i] > 0
    va = c.vote_any(p)
    vl = c.vote_all(p)
    m = c.ballot(p)
    any_out[i] = c.i32(va)
    all_out[i] = c.i32(vl)
    bits[i] = m


@cox.kernel
def gridReduce(
    c,
    total: cox.Array(cox.f32),
    partial: cox.Array(cox.f32),
    data: cox.Array(cox.f32),
    n: cox.i32,
):
    # cooperative two-pass reduction: per-block tree, grid sync, block 0 sums
    tile = c.shared((128,), cox.f32)
    tid = c.thread_idx()
    i = c.block_idx() * c.block_dim() + tid
    tile[tid] = data[i] if i < n else 0.0
    c.syncthreads()
    s = 64
    while s > 0:
        if tid < s:
            tile[tid] = tile[tid] + tile[tid + s]
        c.syncthreads()
        s = s // 2
    if tid == 0:
        partial[c.block_idx()] = tile[0]
    c.grid_sync()
    if c.block_idx() == 0:
        acc = 0.0
        j = tid
        while j < c.grid_dim():
            acc = acc + partial[j]
            j = j + c.block_dim()
        tile[tid] = acc
        c.syncthreads()
        s2 = 64
        while s2 > 0:
            if tid < s2:
                tile[tid] = tile[tid] + tile[tid + s2]
            c.syncthreads()
            s2 = s2 // 2
        if tid == 0:
            total[0] = tile[0]


@cox.kernel
def softmax_rows(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), cols: cox.i32):
    # examples/cox_kernels_in_models.py: one warp per row, warp collectives
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    lane = c.lane_id()
    m = -1e30
    j = lane
    while j < cols:
        m = max(m, x[row * cols + j])
        j = j + 32
    m = c.red_max(m)
    s = 0.0
    j = lane
    while j < cols:
        s = s + c.exp(x[row * cols + j] - m)
        j = j + 32
    s = c.red_add(s)
    j = lane
    while j < cols:
        out[row * cols + j] = c.exp(x[row * cols + j] - m) / s
        j = j + 32


@cox.kernel
def rowStats(
    c,
    sums: cox.Array(cox.f32),
    maxes: cox.Array(cox.f32),
    x: cox.Array(cox.f32),
    cols: cox.i32,
):
    # one warp per row: lane partials, then red_add / red_max
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    lane = c.lane_id()
    s = 0.0
    m = -1e30
    j = lane
    while j < cols:
        v = x[row * cols + j]
        s = s + v
        m = max(m, v)
        j = j + 32
    s = c.red_add(s)
    m = c.red_max(m)
    if lane == 0:
        sums[row] = s
        maxes[row] = m


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def median_ms(fn, batches: int = 7, calls: int = 10) -> float:
    """Device time of one call: CUDA events around a batch of back-to-back
    calls, divided by the count; the median over batches, after a warm-up."""
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


def bound(bytes_moved: int, ops: int) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> bool:
    return bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))


def max_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float() - b.float()).abs() / b.float().abs()).max())


# Softmax is checked relative to each entry (atol 0): at vocabulary width
# the mean output is 1/152064 and most entries lie far below any fixed
# atol, so an absolute floor would let zeroed or garbled entries pass.
SOFTMAX_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
THREE_WAY_RTOL = 1e-4


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def timed_launch(kern, **kw):
    """One COX launch on DEVICE: outputs, wall seconds, host flag reads."""
    sync()
    syncs0 = execute.host_syncs
    t0 = time.perf_counter()
    out = kern.launch(device=DEVICE, **kw)
    sync()
    wall = time.perf_counter() - t0
    return out, wall, execute.host_syncs - syncs0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    rec = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(rec)
    return rec


def phase_build() -> None:
    t0 = time.perf_counter()
    log = build.build_all()
    for name in build.SIGNATURES:
        build.library(name)
    ptxas = {
        name: sorted(
            {
                ln.split(":", 1)[-1].strip()
                for ln in str(rec["ptxas"]).splitlines()
                if "registers" in ln or "spill" in ln
            }
        )
        for name, rec in log.items()
    }
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "cached": {n: r["cached"] for n, r in log.items()},
            "ptxas": ptxas,
        }
    )


# the first case of each kernel is its headline; the main path's own
# shapes (the three-way phase) are among the cases
SOFTMAX_CASES = [
    ((64, VOCAB), torch.float32),
    ((64, VOCAB), torch.bfloat16),
    ((4096, 4096), torch.float32),
    ((3, 1001), torch.float32),  # a tail, and rows that start unaligned
    ((3, 1001), torch.bfloat16),
    ((SOFTMAX_ROWS, VOCAB), torch.float32),
]
REDUCE_CASES = [
    ((8192, D_MODEL), torch.float32),
    ((5, 3001), torch.float32),
    ((STATS_ROWS, D_MODEL), torch.float32),
    ((SOFTMAX_ROWS, VOCAB), torch.float32),
]


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version at the main path's widths;
    the first case of each kernel is its headline in the kernels line."""
    headline = {}
    for shape, dtype in SOFTMAX_CASES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3.0).to(dtype)
        got = sm.softmax_cuda(x)
        want = ref.softmax(x)
        torch.cuda.synchronize()
        rtol, atol = SOFTMAX_RTOL[dtype], 0.0
        err, rel = max_err(got, want), max_rel_err(got, want)
        check(close(got, want, rtol, atol), f"softmax {shape} {dtype}: rel err {rel}")
        nbytes = 2 * x.numel() * x.element_size()
        rec = {
            "phase": "kernel",
            "name": "softmax",
            "shape": list(shape),
            "dtype": str(dtype).replace("torch.", ""),
            "rtol": rtol,
            "atol": atol,
            "max_abs_err": err,
            "max_rel_err": rel,
            "ms": median_ms(lambda: sm.softmax_cuda(x)),
            "plain_ms": median_ms(lambda: ref.softmax(x)),
            "library_ms": median_ms(lambda: torch.softmax(x, dim=-1)),
        }
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 5 * x.numel())
        emit(rec)
        headline.setdefault("softmax", rec)
    library = {
        "sum": lambda x: torch.sum(x, dim=-1, dtype=torch.float32),
        "max": lambda x: torch.amax(x, dim=-1),
        "absmax": lambda x: torch.linalg.vector_norm(x, ord=float("inf"), dim=-1),
    }
    for shape, dtype in REDUCE_CASES:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for op in ("sum", "max", "absmax"):
            got = wr.row_reduce_cuda(x, op)
            want = ref.row_reduce(x, op)
            torch.cuda.synchronize()
            err = max_err(got, want)
            if op == "sum":  # summation order differs
                rtol, atol = 1e-5, 1e-4
                ok = close(got, want, rtol, atol)
            else:  # a max does not depend on order: bitwise
                rtol, atol = 0.0, 0.0
                ok = torch.equal(got, want)
            check(ok and got.dtype == want.dtype, f"row_reduce {op} {shape}: err {err}")
            out_bytes = got.numel() * got.element_size()
            rec = {
                "phase": "kernel",
                "name": "row_reduce",
                "op": op,
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "rtol": rtol,
                "atol": atol,
                "max_abs_err": err,
                "ms": median_ms(lambda: wr.row_reduce_cuda(x, op)),
                "plain_ms": median_ms(lambda: ref.row_reduce(x, op)),
                "library_ms": median_ms(lambda: library[op](x)),
            }
            nbytes = x.numel() * x.element_size() + out_bytes
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, x.numel())
            emit(rec)
            headline.setdefault("row_reduce", rec)
    return headline


def _oracle_blocks(kern, bids, *, grid, block, args) -> dict:
    """Run chosen blocks of a launch through the numpy oracle (blocks that
    read only their own inputs; used where the whole grid would be slow)."""
    ir = kern.ir
    g3, b3 = cox.as_dim3(grid), cox.as_dim3(block)
    globals_, scalars = {}, {}
    for spec, val in zip(ir.params, args):
        if isinstance(spec, ArraySpec):
            globals_[spec.name] = np.asarray(val, spec.dtype.np).reshape(-1).copy()
        else:
            scalars[spec.name] = spec.dtype.np.type(val)
    for bid in bids:
        oracle.run_block(
            ir,
            bid=bid,
            block=b3.total,
            grid=g3.total,
            warp_size=32,
            scalars=scalars,
            globals_=globals_,
            var_types=infer(ir),
            block_dim=b3,
            grid_dim=g3,
        )
    return globals_


def phase_cox(rng: np.random.Generator) -> None:
    """COX launches on CUDA tensors against the numpy oracle."""

    def report(name, wall, syncs, **extra):
        rec = {"phase": "cox", "kernel": name, "wall_s": wall, "host_syncs": syncs}
        emit({**rec, **extra})

    # vectorAdd: the SDK default size, whole grid against the oracle (one
    # f32 add per element on both sides: bitwise)
    a = rng.normal(size=VEC_N).astype(np.float32)
    b = rng.normal(size=VEC_N).astype(np.float32)
    args = (np.zeros(VEC_N, np.float32), a, b, VEC_N)
    grid = -(-VEC_N // 256)
    out, wall, syncs = timed_launch(vectorAdd, grid=grid, block=256, args=args)
    want = oracle.run_grid(vectorAdd.ir, grid=grid, block=256, args=args)
    check(np.array_equal(out["out"].cpu().numpy(), want["out"]), "vectorAdd != oracle")
    report("vectorAdd", wall, syncs, n=VEC_N, grid=grid, block=256, check="bitwise")

    # MatrixMulCUDA at n = 320: the whole product against numpy, two blocks
    # against the oracle (the per-thread oracle of all 400 blocks is slow)
    n = MM_N
    ma = rng.normal(size=(n, n)).astype(np.float32)
    mb = rng.normal(size=(n, n)).astype(np.float32)
    args = (np.zeros((n, n), np.float32), ma, mb, n)
    grid, block = (n // 16, n // 16), (16, 16)
    out, wall, syncs = timed_launch(MatrixMulCUDA, grid=grid, block=block, args=args)
    got = out["out"].cpu().numpy()
    full = ma.astype(np.float64) @ mb.astype(np.float64)
    check(np.allclose(got, full, rtol=1e-4, atol=1e-4), "MatrixMulCUDA != a @ b")
    bids = [0, (n // 16) ** 2 - 1]
    blocks = _oracle_blocks(MatrixMulCUDA, bids, grid=grid, block=block, args=args)
    want = blocks["out"].reshape(n, n)
    tiles = [(slice(0, 16), slice(0, 16)), (slice(n - 16, n), slice(n - 16, n))]
    tile_err = max(float(np.abs(got[t] - want[t]).max()) for t in tiles)
    check(tile_err <= 1e-5, f"MatrixMulCUDA oracle blocks: max err {tile_err}")
    report(
        "MatrixMulCUDA",
        wall,
        syncs,
        n=n,
        grid=list(grid),
        block=list(block),
        check="a@b rtol 1e-4 atol 1e-4; oracle blocks 0 and last atol 1e-5",
        oracle_max_err=tile_err,
    )

    # warp shuffle reduction: small integers, so every sum is exact
    nb = 128
    val = rng.integers(-8, 9, size=nb * 256).astype(np.float32)
    args = (np.zeros(nb, np.float32), val)
    out, wall, syncs = timed_launch(warpReduce, grid=nb, block=256, args=args)
    want = oracle.run_grid(warpReduce.ir, grid=nb, block=256, args=args)
    got = out["out"].cpu().numpy()
    check(np.array_equal(got, want["out"]), "warpReduce != oracle")
    check(np.array_equal(got, val.reshape(nb, 256).sum(1)), "warpReduce != sums")
    report("warpReduce", wall, syncs, grid=nb, block=256, check="bitwise")

    # vote / ballot: lane 31 sets bit 31 of the u32 ballot
    nb = 64
    inp = rng.integers(-1, 2, size=nb * 256).astype(np.int32)
    inp[31::32] = 1
    zeros = np.zeros(nb * 256, np.int32)
    args = (zeros, zeros, zeros.astype(np.uint32), inp)
    out, wall, syncs = timed_launch(voteBallot, grid=nb, block=256, args=args)
    want = oracle.run_grid(voteBallot.ir, grid=nb, block=256, args=args)
    for k in ("any_out", "all_out", "bits"):
        got = out[k].cpu().numpy()
        same = got.dtype == want[k].dtype and np.array_equal(got, want[k])
        check(same, f"voteBallot {k} != oracle")
    check(bool((out["bits"].cpu().numpy() >> 31).all()), "ballot lost bit 31")
    report("voteBallot", wall, syncs, grid=nb, block=256, check="bitwise")

    # gridReduce: grid sync, phased scan
    nb, n = 64, 8000
    data = rng.integers(-8, 9, size=n).astype(np.float32)
    args = (np.zeros(1, np.float32), np.zeros(nb, np.float32), data, n)
    out, wall, syncs = timed_launch(gridReduce, grid=nb, block=128, args=args)
    want = oracle.run_grid(gridReduce.ir, grid=nb, block=128, args=args)
    for k in ("total", "partial"):
        same = np.array_equal(out[k].cpu().numpy(), want[k])
        check(same, f"gridReduce {k} != oracle")
    check(float(out["total"][0]) == float(data.sum()), "gridReduce total")
    report("gridReduce", wall, syncs, grid=nb, block=128, n=n, check="bitwise")
    check(all(t.device.type == DEVICE for t in out.values()), "outputs left the card")


def phase_three_way(gen: torch.Generator) -> None:
    """The three-way check: COX kernel == CUDA kernel == plain version."""
    rows = SOFTMAX_ROWS
    x = torch.randn((rows, VOCAB), generator=gen, device=DEVICE) * 3.0
    out, wall, syncs = timed_launch(
        softmax_rows,
        grid=1,
        block=32 * rows,
        args=(torch.zeros_like(x), x, VOCAB),
    )
    got_cox = out["out"]
    got_cuda = ops.softmax(x)
    want = ref.softmax(x)
    for name, got in (("cox", got_cox), ("cuda", got_cuda)):
        rel = max_rel_err(got, want)
        ok = close(got, want, THREE_WAY_RTOL, 0.0)
        check(ok, f"three-way softmax {name}: rel err {rel}")
    sums = ops.row_reduce(got_cox, "sum")
    check(close(sums, torch.ones_like(sums), 1e-4, 1e-4), "COX softmax rows sum to 1")
    emit(
        {
            "phase": "three_way",
            "kernel": "softmax",
            "shape": [rows, VOCAB],
            "rtol": THREE_WAY_RTOL,
            "atol": 0.0,
            "max_err_cox": max_err(got_cox, want),
            "max_err_cuda": max_err(got_cuda, want),
            "max_rel_err_cox": max_rel_err(got_cox, want),
            "max_rel_err_cuda": max_rel_err(got_cuda, want),
            "cox_wall_s": wall,
            "cox_host_syncs": syncs,
        }
    )

    rows = STATS_ROWS
    x = torch.randn((rows, D_MODEL), generator=gen, device=DEVICE)
    out, wall, syncs = timed_launch(
        rowStats,
        grid=rows // 2,
        block=64,
        args=(x.new_zeros(rows), x.new_zeros(rows), x, D_MODEL),
    )
    for op, cox_out in (("sum", out["sums"]), ("max", out["maxes"])):
        got_cuda = ops.row_reduce(x, op)
        want = ref.row_reduce(x, op)
        if op == "sum":
            ok = close(cox_out, want, 1e-5, 1e-4) and close(got_cuda, want, 1e-5, 1e-4)
        else:
            ok = torch.equal(cox_out, want) and torch.equal(got_cuda, want)
        check(ok, f"three-way row_reduce {op}")
    emit(
        {
            "phase": "three_way",
            "kernel": "row_reduce",
            "shape": [rows, D_MODEL],
            "check": "sum rtol 1e-5 atol 1e-4; max bitwise",
            "cox_wall_s": wall,
            "cox_host_syncs": syncs,
        }
    )


KERNEL_META = {
    "softmax": ("src/repro_torch/csrc/softmax.cu", "src/repro/kernels/softmax.py:18"),
    "row_reduce": (
        "src/repro_torch/csrc/row_reduce.cu",
        "src/repro/kernels/warp_reduce.py:29",
    ),
}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    headline = phase_kernels(gen)

    # the main path: COX launches and the three-way checks, counted alone
    ops.reset_launch_counts()
    phase_cox(rng)
    phase_three_way(gen)
    counts = ops.launch_counts()
    kernels = []
    for name, rec in headline.items():
        source, replaces = KERNEL_META[name]
        check(counts[name] > 0, f"{name} was not launched on the main path")
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": counts[name],
                "shape": rec["shape"],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
            }
        )
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(dev["nvidia_smi"], flush=True)
    device = {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
