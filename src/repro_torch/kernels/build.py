"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` -- no PyTorch headers, so
a build takes seconds.  Libraries land in ``build/repro_torch/`` at the
root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of the sources and flags, so an edited source rebuilds on its next
use and an unchanged one loads as it is.  :func:`build_all` starts one
``nvcc`` per source at once.

Nothing here runs at import time: this module is imported on hosts
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh (enum CoxDType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# C signatures, by library and entry point: every pointer and the stream
# as c_void_p (a bare int would be passed as 32 bits and cut the pointer)
_VP, _LL, _INT, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

# csrc/adamw.cu's table of a launch's leaves, passed to its kernels by
# value: leaf i's chunks are [chunk_start[i], chunk_start[i + 1]); ctypes
# needs its size before the library loads, and kernels/adamw.py layout()
# checks it against the library's
ADAMW_MAX_LEAVES = 80


class AdamWTable(ctypes.Structure):
    _fields_ = [
        ("chunk_start", _LL * (ADAMW_MAX_LEAVES + 1)),
        ("numel", _LL * ADAMW_MAX_LEAVES),
        ("p", _VP * ADAMW_MAX_LEAVES),
        ("g", _VP * ADAMW_MAX_LEAVES),
        ("m", _VP * ADAMW_MAX_LEAVES),
        ("v", _VP * ADAMW_MAX_LEAVES),
        ("n", _INT),
    ]


SIGNATURES = {
    "row_reduce": {"cox_row_reduce": [_VP, _VP, _LL, _LL, _INT, _INT, _VP]},
    "softmax": {
        # x, y, rows, cols, dtype, regime, two of its numbers (warps a row
        # and teams a block, or blocks a cluster and stages), blocks or
        # clusters, vectors a slice, stream
        "cox_softmax": [_VP, _VP, _LL, _LL] + [_INT] * 5 + [_LL, _VP],
        # dtype, regime, blocks a cluster, dynamic shared memory bytes
        "cox_softmax_clusters": [_INT, _INT, _INT, _LL],
    },
    "rmsnorm": {
        # x, w, y, rows, cols, eps, x dtype, w dtype, warps a row, teams a
        # block, blocks, stream
        "cox_rmsnorm": [_VP, _VP, _VP, _LL, _LL, _F32] + [_INT] * 5 + [_VP],
        # x, w, dy, dx, dw, partial dw scratch, rows, cols, eps, x dtype,
        # w dtype, warps a row, teams a block, blocks, rows a block, whether
        # rows are held, pass 2's warps a block, stream
        "cox_rmsnorm_bwd": [_VP] * 6 + [_LL, _LL, _F32] + [_INT] * 5 + [_LL, _INT, _INT, _VP],
    },
    "layernorm": {
        # x, w, b, y, rows, cols, eps, x dtype, w and b dtype, warps a row,
        # teams a block, blocks, stream
        "cox_layernorm": [_VP] * 4 + [_LL, _LL, _F32] + [_INT] * 5 + [_VP],
        # x, w, dy, dx, dw, db, partial dw/db scratch, then cox_rmsnorm_bwd's
        "cox_layernorm_bwd": [_VP] * 7 + [_LL, _LL, _F32] + [_INT] * 5 + [_LL, _INT, _INT, _VP],
    },
    # q, k, v, kv_len, out, lse (or null), split scratch, nsplit, head
    # group, B, H, Hkv, S, D, k strides (b, s, h), v strides (b, s, h),
    # dtype, stream
    "flash_decode": {
        "cox_flash_decode": [_VP] * 7 + [_INT] * 5 + [_LL, _INT] + [_LL] * 6 + [_INT, _VP],
    },
    "flash_attention": {
        # q, k, v, o, lse, B, H, Hkv, S, D, q/k/v strides (b, s, h),
        # causal, window, scale, dtype, stream
        "cox_flash_attention": [_VP] * 5
        + [_INT] * 3
        + [_LL, _INT]
        + [_LL] * 9
        + [_INT, _LL, _F32, _INT, _VP],
        # q, k, v, o, dout, lse, delta scratch, dq, dk, dv, split scratch,
        # nsplit, B, H, Hkv, S, D, q/k/v strides (b, s, h), causal, window,
        # scale, dtype, stream
        "cox_flash_attention_bwd": [_VP] * 11
        + [_INT] * 4
        + [_LL, _INT]
        + [_LL] * 9
        + [_INT, _LL, _F32, _INT, _VP],
    },
    "adamw": {
        # table, partial sums scratch, blocks, gradient dtype, stream
        "cox_adamw_sumsq": [AdamWTable, _VP, _INT, _INT, _VP],
        # partial sums, their count, out (norm, clip scale), clip norm, stream
        "cox_adamw_finalize": [_VP, _INT, _VP, _F32, _VP],
        # table, clip scale, lr, b1c, b2c (device scalars), b1, 1 - b1, b2,
        # 1 - b2, eps, weight decay, blocks, parameter dtype, gradient
        # dtype, stream
        "cox_adamw_apply": [AdamWTable] + [_VP] * 4 + [_F32] * 6 + [_INT] * 3 + [_VP],
        # out: chunk, blocks an SM of each kernel, table leaves and bytes
        "cox_adamw_layout": [_VP],
    },
    "ssd_scan": {
        # N, P -> the tile length (0: not built)
        "cox_ssd_scan_tile": [_INT, _INT],
        # x, a, b, c, y, states, sync words, B, S, H, P, N, x strides
        # (b, s, h), a strides (b, s, h), b and c strides (b, s), stream
        "cox_ssd_scan": [_VP] * 7 + [_INT] * 5 + [_LL] * 10 + [_VP],
        # x, a, b, c, dy, states, dx, da, db, dc, the dH exchange buffer,
        # sync words, B, S, H, P, N, strides as the forward's, stream
        "cox_ssd_scan_bwd": [_VP] * 12 + [_INT] * 5 + [_LL] * 10 + [_VP],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# per-source build record: seconds, and nvcc's -Xptxas -v report
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built on the "
        "machine with the card"
    )


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, out: pathlib.Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = CSRC / f"{name}.cu"
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    pipe = subprocess.PIPE
    return subprocess.Popen(cmd, stdout=pipe, stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Dict[str, object]]:
    """Compile every stale library, one ``nvcc`` per source, all started
    together; returns :data:`BUILD_LOG`."""
    names = list(SIGNATURES if names is None else names)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "cached": True, "ptxas": ""})
        else:
            procs[name] = (out, _start(name, out))
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out.with_suffix(f".{os.getpid()}.tmp").replace(out)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "cached": False,
            "ptxas": log,
        }
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
