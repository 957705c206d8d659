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

# C signatures: every pointer and the stream as c_void_p (a bare int would
# be passed as 32 bits and cut the pointer)
_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "row_reduce": ("cox_row_reduce", [_VP, _VP, _LL, _LL, _INT, _INT, _VP]),
    "softmax": ("cox_softmax", [_VP, _VP, _LL, _LL, _INT, _VP]),
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
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
