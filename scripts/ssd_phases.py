#!/usr/bin/env python3
"""Where the SSD kernels' time goes, on one CUDA card: cycles per phase.

    python3 scripts/ssd_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` under
``build/ssd_phases/`` with ``clock64()`` counters at the kernels' barriers:
thread 0 of every block adds the cycles since its last mark into one
counter per phase (``atomicAdd`` into a ``__device__`` array, read back
with ``cudaMemcpyFromSymbol``).  Runs the forward and the backward once at
mamba2-130m's train shape (B 8, S 4,096, 24 heads, P 64, N 128, f32) and
prints the mean cycles a (block, head) in each phase, thread 0's view: a
phase that ends at a barrier includes the wait for the slowest warp.  The
counters cost a few percent; the kernels' times come from
``scripts/ssd_kernels.py``.

Also probes the card's ``mma.sync.m16n8k8`` TF32 rate: a kernel of
independent product chains per warp, timed with CUDA events, for 1-8
chains a warp and 4-16 warps an SM.  One JSON object per line, then the
card's name and power limit as ``nvidia-smi`` prints them.
"""

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

OUT = ROOT / "build" / "ssd_phases"
SHAPE = (8, 4096, 24, 64, 128)

CLOCKS = """
__device__ unsigned long long g_clk[16];
#define CLK_START unsigned long long clk_t = clock64();
#define CLK(n) if (threadIdx.x == 0) { unsigned long long clk_n = clock64(); \\
    atomicAdd(&g_clk[n], clk_n - clk_t); clk_t = clk_n; }
"""
READ = """
extern "C" int read_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
}
extern "C" int zero_clocks() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
"""
# (text in the source, the same text with a mark) and the phase each mark ends
MARKS = [
    ("  const int warp = threadIdx.x / 32;\n  const float* x_tile",
     "  const int warp = threadIdx.x / 32;\n  CLK_START\n  const float* x_tile"),
    ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n",
     "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n  CLK_START\n"),
    ("    __syncthreads();  // the previous head is done with the other X and decays, ms and hs\n",
     "    __syncthreads();  // the previous head is done with the other X and decays, ms and hs\n"
     "    CLK(0)\n"),
    ("    wg::cp_async_wait<1>();  // this head's X\n    __syncthreads();\n",
     "    wg::cp_async_wait<1>();  // this head's X\n    __syncthreads();\n    CLK(1)\n"),
    ("    if (tile > 0 && threadIdx.x == 0) wait_flag(flags + bh * n_tiles + tile);\n"
     "    __syncthreads();\n",
     "    CLK(2)\n    if (tile > 0 && threadIdx.x == 0) wait_flag(flags + bh * n_tiles + tile);\n"
     "    __syncthreads();\n    CLK(3)\n"),
    ("    publish(flags + bh * n_tiles + tile + 1, tile + 1 < n_tiles);\n",
     "    publish(flags + bh * n_tiles + tile + 1, tile + 1 < n_tiles);\n    CLK(4)\n"),
    ("    __syncthreads();  // the previous head is done with every per-head buffer\n",
     "    __syncthreads();  // the previous head is done with every per-head buffer\n    CLK(8)\n"),
    ("    wg::cp_async_wait<0>();\n    __syncthreads();\n\n    // E .* G",
     "    wg::cp_async_wait<0>();\n    __syncthreads();\n    CLK(9)\n\n    // E .* G"),
    ("    __syncthreads();  // egs is written\n",
     "    __syncthreads();  // egs is written\n    CLK(10)\n"),
    ("    if (tile + 1 < n_tiles && threadIdx.x == 0) wait_flag(flags + bh * n_tiles + tile);\n"
     "    __syncthreads();\n",
     "    CLK(11)\n    if (tile + 1 < n_tiles && threadIdx.x == 0) "
     "wait_flag(flags + bh * n_tiles + tile);\n    __syncthreads();\n    CLK(12)\n"),
    ("    publish(flags + bh * n_tiles + tile - 1, tile > 0);\n",
     "    publish(flags + bh * n_tiles + tile - 1, tile > 0);\n    CLK(13)\n"),
    ("    __syncthreads();  // the parts are written\n",
     "    __syncthreads();  // the parts are written\n    CLK(14)\n"),
]
FWD_PHASES = {
    0: "y = intra + exp(A) C h_in, the store, the head's barrier",
    1: "(C B^T) .* L, the next head's decays, this head's X (prefetched)",
    2: "S and the intra-tile output (warp 0)",
    3: "the slowest warp's products and the chain's wait",
    4: "the chain step: h_in from L2, h_out out, the release",
}
BWD_PHASES = {
    8: "dA and da (warp 0), the head's barrier",
    9: "X, dY, h_in and the decays",
    10: "E .* G and the chained term U",
    11: "the row and column sums",
    12: "the chain's wait",
    13: "the chain step: dH from L2, the previous tile's dH out",
    14: "dX, dB and dC",
}

PEAK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CH>
__global__ void peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float acc[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0;
  for (int c = 0; c < CH; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_peak(float* out, int chains, int blocks, int threads, int iters) {
  if (chains == 1) peak<1><<<blocks, threads>>>(out, iters);
  if (chains == 2) peak<2><<<blocks, threads>>>(out, iters);
  if (chains == 4) peak<4><<<blocks, threads>>>(out, iters);
  if (chains == 8) peak<8><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def compile_lib(src: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def phases() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    src = (csrc / "ssd_scan.cu").read_text()
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + CLOCKS, 1)
    for plain, marked in MARKS:
        if src.count(plain) != 1:
            raise RuntimeError(f"ssd_phases: the source changed; no single {plain!r}")
        src = src.replace(plain, marked)
    (OUT / "ssd_scan.cu").write_text(src + READ)
    lib = compile_lib(OUT / "ssd_scan.cu", OUT / "libssd_phases.so")
    for fn_name, argtypes in build.SIGNATURES["ssd_scan"].items():
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
    build._LIBS["ssd_scan"] = lib  # the wrappers launch the instrumented kernels

    B, S, H, P, N = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.5 * torch.randn(B, S, H, P, generator=gen, device="cuda")
    a = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda") - 1)
    b = 0.3 * torch.randn(B, S, N, generator=gen, device="cuda")
    c = 0.3 * torch.randn(B, S, N, generator=gen, device="cuda")
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda")
    units = B * -(-S // ssd.tile_rows(N, P)) * H  # (block, head) pairs
    buf = (ctypes.c_ulonglong * 16)()
    for kernel, names in (("forward", FWD_PHASES), ("backward", BWD_PHASES)):
        for _ in range(2):  # the first call warms up
            lib.zero_clocks()
            y, states = ssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
            if kernel == "backward":
                torch.cuda.synchronize()
                lib.zero_clocks()
                ssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)
            torch.cuda.synchronize()
        lib.read_clocks(buf)
        cycles = {i: buf[i] / units for i in names}
        total = sum(cycles.values())
        for i, what in names.items():
            rec = {"kernel": kernel, "phase": i, "what": what, "cycles_per_head": cycles[i],
                   "share": cycles[i] / total}
            print(json.dumps(rec), flush=True)


def mma_rate() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mma_peak.cu").write_text(PEAK)
    lib = compile_lib(OUT / "mma_peak.cu", OUT / "libmma_peak.so")
    lib.run_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    iters = 2000
    for chains in (1, 2, 4, 8):
        for warps in (4, 8, 16):
            lib.run_peak(out.data_ptr(), chains, sms, 32 * warps, iters)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run_peak(out.data_ptr(), chains, sms, 32 * warps, iters)
            end.record()
            end.synchronize()
            flops = sms * warps * iters * chains * 2 * 16 * 8 * 8
            rec = {"probe": "mma.sync m16n8k8 tf32", "chains_per_warp": chains,
                   "warps_per_sm": warps, "tflop_per_s": flops / start.elapsed_time(end) / 1e9}
            print(json.dumps(rec), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("ssd_phases.py needs a CUDA card")
    mma_rate()
    phases()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
