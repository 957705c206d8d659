#!/usr/bin/env python3
"""Smoke run of the repro_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the widths of qwen2.5-14b
(vocabulary 152,064; d_model 5,120; 40/8 heads of 128), then drives the
main paths, each with the launch counts set to 0 before it and read after
it:

- COX kernels launched on CUDA tensors on the serial ``scan`` backend
  against the port's numpy oracle, and on the block-parallel ``vmap``
  backend (batched warps, whole-grid waves, grid-stride and cooperative
  waves) bitwise against the scan launch (MatrixMulCUDA: on scan at
  n = 160, at the SDK's n = 320 against numpy, the oracle and its default
  vmap launch), one ``cox`` line a launch;
  the three-way check of ``examples/cox_kernels_in_models.py`` (a COX
  warp-collective kernel, the CUDA kernel and the plain version agree),
  and ``serve_requests`` on qwen2.5-14b at full width and depth in bf16
  (random weights from a seed), whose decode steps launch the rmsnorm and
  flash_decode kernels;
- ``launch.train.train`` on qwen2.5-14b at full width cut to 4 layers, in
  bf16, batch 2 of 4,096 tokens, 3 AdamW steps, whose steps launch the
  flash_attention and rmsnorm kernels and their backward kernels;
- ``serve_requests`` on mamba2-130m (the SSM family) at full width and
  depth in bf16, whose decode steps launch the rmsnorm kernel;
- ``train`` on mamba2-130m at full width and depth, bf16, batch 8 of
  4,096 tokens, 3 steps, whose steps launch the ssd_scan and rmsnorm
  kernels and their backward kernels;
- ``serve_requests`` on granite-20b (layer norms, MQA with 48 query heads
  over 1 kv head, the gelu MLP) at full width and depth in bf16, whose
  decode steps launch the layernorm and flash_decode kernels;
- ``train`` on granite-20b at full width cut to 4 layers, bf16, batch 2 of
  4,096 tokens, 3 steps, whose steps launch the flash_attention and
  layernorm kernels and their backward kernels;
- ``serve_requests`` on zamba2-1.2b (the hybrid family: 38 Mamba2 layers
  and 7 applications of one shared attention+MLP block) at full width and
  depth, whose decode steps launch rmsnorm 91 times and flash_decode 7
  times, and ``train`` on it at full width and depth, batch 4 of 4,096,
  whose steps launch all six: ssd_scan, flash_attention, rmsnorm and their
  backwards;
- ``serve_requests`` on deepseek-moe-16b (the MoE family, 64 experts, top
  6) at full width and depth, and ``train`` on it cut to 4 layers, batch 2
  of 4,096, at the published capacity factor 1.25 (tokens drop; each
  step's dropped share is printed): rmsnorm and flash_decode, and
  flash_attention and rmsnorm and their backwards;
- ``serve_requests`` on llava-next-34b (the VLM family, text only, as the
  reference serves it) at full width cut to 8 layers, and ``train`` on it
  cut to 4 layers, batch 2 of 4,096 = 2,880 frontend rows + 1,216 tokens;
- ``serve_requests`` on seamless-m4t-large-v2 (the encoder-decoder family,
  24 + 24 layers, layer norms) at full width and depth, whose decode
  steps cross-attend to the zero memory of 3,072 rows that the
  reference's server also reads: layernorm 73 times and flash_decode 48
  times a step; and ``train`` on it at full width and depth, batch 2 of
  4,096 frames and tokens: flash_attention non-causal in the encoder and
  the cross-attention and causal in the decoder, layernorm, and their
  backwards;
- the checkpoint drill: ``train`` on mamba2-130m at full width and depth
  with a checkpoint every 2 steps and a failure injected before step 4,
  against the same run uninterrupted: the parameters, the moments and
  the losses equal bit for bit.
- the COX runtime services: the graph chain on two cox streams with an
  event edge and vectorAdd on a third, bitwise the serial launches, the
  default stream's legacy barrier, one injected fault of each site and a
  degradation-ladder walk, and the serving token pipeline captured once as
  a ``torch.cuda.CUDAGraph`` and replayed 200 times, bitwise the eager
  pipeline; ``serve_requests(postproc=True, graph=True)`` on qwen2.5-14b
  at full width and depth (rmsnorm and flash_decode), and
  ``serve_requests(postproc=True, chaos=True)`` on mamba2-130m (rmsnorm).
- the measured autotuner, buffer donation and the counted cost model:
  voteBallot (64 x 256) and warpReduce (128 x 256) tuned from a cold
  cache (every cell's time, the winner, the tuned launch bitwise the scan
  launch, then a memory hit and a disk hit that measure nothing), and
  gridReduce keeping its cooperative chunk; vectorAdd on vmap over 2**22
  f32 elements with and without ``donate=True`` (the peak device memory
  falls by the donated bytes), a donating stream chain and the refusals;
  the counted cost record of the five COX kernels beside the static one;
  and ``launch.serve.main([... '--postproc', '--autotune'])`` on
  mamba2-130m (rmsnorm), then the same command in a child process on the
  same cache file, which measures nothing.
- COX on a pool of devices: vec_madd, the histogram atomics, the
  cooperative gridReduce and the grid-stride vec_madd sharded over a
  one-rank NCCL mesh (each bitwise the scan launch and the oracle; one
  launch captured and replayed as a CUDA graph), then over 8 and 4 gloo
  ranks spawned as processes that share the card (every rank bitwise the
  single-device launch, all ranks the same; a gloo capture refused), with
  MatrixMulCUDA at n = 320 over 4 gloo ranks beside one NCCL rank; and
  streams over a pool of 4 logical devices on the card (the round-robin
  spread, a cross-device event and data edge, health-aware routing after
  a sticky fault, a placed graph replayed as a CUDA graph).
- the model stack on a mesh: one NCCL rank on a 1 x 1 mesh (qwen2.5-14b
  served at full depth in bf16 through ``BatchedServer(mesh=)``, tokens
  bitwise the one-device server's; deepseek-moe-16b's train step at 2
  layers on the expert-parallel path, its loss bitwise), then 4 gloo
  ranks on the card spawned once, their collectives staged through
  pinned host memory: f32 decode steps on (1, 2) and on (1, 3) with
  padded q heads, f32 gradients of qwen and of deepseek on (1, 2), a
  ZeRO-1/2 step on (2, 2) with a checkpoint restored onto (1, 2) and one
  device bitwise, and qwen served in bf16 at full depth on (1, 2).

Then it times the kernel wrappers' host cost, profiles a few decode steps
and one train step of qwen2.5-14b and of mamba2-130m (device busy and
idle time, kernels by name), and holds each serving path (full width, 2 layers, f32) and one
train step of each (full width, 1 layer, f32) on the card against the
same on the CPU; the MoE checks compare the router's top-k first (a
choice may flip only on a near tie, counted and printed).  Last, with
TF32 still off, three more main paths, each counted alone:

- ``examples``: the port's seven examples (``examples/torch_*.py``) through their
  ``main`` on the card: quickstart, cuda_migration, the three-way softmax
  (the softmax kernel), graph_replay, streams_overlap, the serving example
  on mamba2-130m at full width and depth (rmsnorm) and the training
  example on it with a checkpoint every 2 steps (ssd_scan, rmsnorm and
  their backwards);
- ``arch_smoke``: tests/test_arch_smoke.py at published widths: every registered model
  (yi-34b and granite-34b among them) cut to 2 layers in bf16, one forward
  and one decode step each (rmsnorm, layernorm, flash_attention,
  ssd_scan, flash_decode), then decode against forward in f32 for
  qwen2.5-14b and mamba2-130m;
- ``granite_moe``: granite-moe-1b-a400m (32 experts, top 8, no shared expert) served at
  full width and depth in bf16, and its f32 decode and train
  cross-checks (rmsnorm, flash_decode, flash_attention and their
  backwards).

Each model's phases free its weights before the next model's start.
Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.

It needs a CUDA card and fails without one, and imports neither ``jax``
nor the JAX package.  The COX kernels are defined in this file because
the frontend parses kernel source with ``inspect.getsource``.
"""

import atexit
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import cox, execute, oracle, runtime  # noqa: E402
from repro_torch.core.streams import Dispatcher  # noqa: E402
from repro_torch.core.typeinfer import infer  # noqa: E402
from repro_torch.core.types import ArraySpec  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import norms  # noqa: E402
from repro_torch.kernels import softmax as sm  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import warp_reduce as wr  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.ft.watchdog import FailureInjector  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import specs as launch_specs  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import steps  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
VOCAB = 152064  # qwen2.5-14b vocabulary (src/repro/configs/qwen2_5_14b.py)
D_MODEL = 5120  # qwen2.5-14b d_model
MM_N = 320  # CUDA SDK matrixMul sample: default width of A
# the serial scan launch at half that width (60-85 s at 320, the item of
# the script that swings most between hosts), held bitwise to vmap there
MM_SCAN_N = 160
VEC_N = 50000  # CUDA SDK vectorAdd sample: default element count
DEVICE = "cuda"  # the COX, three-way, serve and cross-check phases also run on "cpu"
SOFTMAX_ROWS = 2  # three-way softmax: rows of the full vocabulary, one warp each
STATS_ROWS = 64  # three-way row reduction: rows of d_model width
ARCH = "qwen2.5-14b"
N_HEADS, N_KV, D_HEAD = 40, 8, 128  # qwen2.5-14b attention
# the serve phase: serve_requests at full width and depth
SERVE = dict(batch=4, ctx=512, n_requests=4, max_tokens=16, seed=0)
CROSS_LAYERS, CROSS_STEPS, CROSS_BATCH, CROSS_CTX = 2, 4, 4, 64  # card vs CPU
CROSS_RTOL = 1e-3  # logits, relative to their largest magnitude
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# the train phase: train() at full width, depth cut 48 -> 4 and batch
# 256 -> 2 from the reference's train_4k cell (seq 4,096 kept)
TRAIN = dict(
    n_layers=4,
    batch=2,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: layers 48 -> 4, batch 256 -> 2; seq 4,096 and widths kept",
)
# the train cross-check: full width, 1 layer, f32, batch 1, seq 256 (two
# 128-row q tiles of the reference's kernel)
CROSS_TRAIN = dict(n_layers=1, batch=1, seq=256)
CROSS_LOSS_RTOL = 1e-4  # the loss and the grad norm, relative
CROSS_GRAD_RTOL = 1e-3  # every gradient, relative to its largest magnitude
# A gradient beyond CROSS_GRAD_RTOL of the CPU's is held to its own rounding
# instead: no farther from the same step in f64 than this many times the
# CPU's f32 step.  On an H100 (700 W) granite-20b's 1-layer step, whose
# attention is one-hot in 96 % of its rows, lies 1.04e-3 from the CPU's
# with the plain versions in place of every kernel (cuBLAS against the
# CPU's GEMMs, nothing of the port's), up to 1.9x the CPU's distance from
# f64 on any leaf above 1e-5 of its scale; with the kernels, 2.0x
# (scripts/grad_rounding.py measures both).
CROSS_ROUNDING_K = 2.5
# the SSM family: 24 layers, d 768, 24 SSD heads of P = 64, N = 128; its
# serve phase takes SERVE's requests at full width and depth, and its
# train phase runs train() at full width and depth, cut from the
# reference's train_4k cell in batch only (256 -> 8)
SSM_ARCH = "mamba2-130m"
SSM_TRAIN = dict(
    batch=8,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: batch 256 -> 8; seq 4,096, widths and depth kept",
)
# granite-20b: 52 layers, d 6,144, 48 query heads over 1 kv head of 128,
# gelu MLP of 24,576, vocabulary 49,152, layer norms with biases; its serve
# phase takes SERVE's requests at full width and depth, and its train
# phase runs train() at full width cut as the qwen train phase is
GRANITE_ARCH = "granite-20b"
GRANITE_D_MODEL = 6144
GRANITE_HEADS, GRANITE_KV = 48, 1
GRANITE_TRAIN = dict(
    n_layers=4,
    batch=2,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: layers 52 -> 4, batch 256 -> 2; seq 4,096 and widths kept",
)
# the hybrid family, zamba2-1.2b: 38 Mamba2 layers (d 2,048, d_inner 4,096,
# 64 SSD heads of P 64, N 64) and one shared attention+MLP block (32/32
# heads of 64, window 4,096, gelu MLP of 8,192) after every 6 of them, 7
# applications; serve at full width and depth, train at full width and
# depth, cut from train_4k in batch only
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_TRAIN = dict(
    batch=4,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: batch 256 -> 4; seq 4,096, widths and depth kept",
)
# the decode cross-check's window, under CROSS_CTX, so the ring wraps
HYBRID_CROSS_WINDOW = 32
# the MoE family, deepseek-moe-16b: 28 layers, d 2,048, 16/16 heads of 128,
# 64 experts of 1,408 (top 6) and 2 shared, vocabulary 102,400; serve at
# full width and depth, train cut as qwen's, at the published capacity
# factor 1.25, which drops tokens
MOE_ARCH = "deepseek-moe-16b"
MOE_TRAIN = dict(
    n_layers=4,
    batch=2,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: layers 28 -> 4, batch 256 -> 2; seq 4,096, widths and "
    "capacity_factor 1.25 kept",
)
# the VLM family, llava-next-34b: 60 layers, d 7,168, 56/8 heads of 128,
# swiglu of 20,480, vocabulary 64,000, 2,880 frontend rows.  Its decode
# step is the dense family's, which qwen and granite run at full depth:
# serving is cut to 8 layers to keep the script within its time limit
VLM_ARCH = "llava-next-34b"
VLM_SERVE_LAYERS = 8
VLM_TRAIN = dict(
    n_layers=4,
    batch=2,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: layers 60 -> 4, batch 256 -> 2; seq 4,096 = 2,880 frontend "
    "rows + 1,216 tokens, widths kept",
)
VLM_CROSS_FRONTEND = 128  # the train cross-check's frontend rows (2,880 -> 128)
# the encoder-decoder family, seamless-m4t-large-v2: 24 encoder and 24
# decoder layers, d 1,024, 16/16 heads of 64, gelu MLP of 8,192, layer
# norms, vocabulary 256,206 (tied); serve at full width and depth over a
# cross memory of ENC_LEN rows, train at full width and depth, cut from
# train_4k in batch only
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_D_MODEL = 1024
ENC_LEN = launch_specs.ENC_LEN_DECODE  # the serving cache's cross memory rows
ENCDEC_TRAIN = dict(
    batch=2,
    seq=4096,
    steps=3,
    seed=0,
    cuts="from train_4k: batch 256 -> 2; seq 4,096 (frames and tokens), widths and "
    "depth (24 + 24 layers) kept",
)
# the checkpoint drill: train() with a checkpoint every 2 steps and a
# failure before step 4, against the same run uninterrupted
CKPT_DRILL = dict(batch=2, seq=256, steps=6, seed=0, ckpt_every=2, fail_at=4)
# the port's examples (examples/torch_*.py) on the card: the serving
# example on mamba2-130m at full width and depth, the training example on
# it with a checkpoint every 2 steps
EXAMPLE_SERVE = dict(arch=SSM_ARCH, batch=4, ctx=128, n_requests=4, max_tokens=24)
EXAMPLE_TRAIN = dict(arch=SSM_ARCH, steps=6, batch=8, seq=256, ckpt_every=2)
# tests/test_arch_smoke.py at published widths: every registered model cut
# to 2 layers (2 + 2), bf16, one forward of B 2 x S 32 and one decode step
# at B 2 over a cache of 64 rows; then decode against forward over 8
# tokens in f32 for the dense and SSM models
ARCH_SMOKE = dict(n_layers=2, batch=2, seq=32, ctx=64, enc_len=16, pos=[3, 7])
ARCH_SMOKE_DECODE = dict(archs=(ARCH, SSM_ARCH), tokens=8, rtol=2e-2)
# granite-moe-1b-a400m (24 layers, d 1,024, 16/8 heads of 64, 32 experts
# of 512, top 8, no shared expert, vocabulary 49,155 padded to 49,408):
# served at full width and depth in bf16, then the f32 cross-checks
GRANITE_MOE_ARCH = "granite-moe-1b-a400m"
GRANITE_MOE_SERVE = dict(batch=4, ctx=128, n_requests=4, max_tokens=16, seed=0)
# a phase's name: the model's prefix and the phase, e.g. granite_serve
PHASE_PREFIX = {
    ARCH: "",
    SSM_ARCH: "ssm_",
    GRANITE_ARCH: "granite_",
    HYBRID_ARCH: "hybrid_",
    MOE_ARCH: "moe_",
    VLM_ARCH: "vlm_",
    ENCDEC_ARCH: "encdec_",
    GRANITE_MOE_ARCH: "granite_moe_",
}


T_START = time.perf_counter()


def phase_name(cfg, base: str) -> str:
    """A phase's name in the output: ``base``, after its model's prefix
    (none for qwen2.5-14b, ``ssm_`` for mamba2-130m, ``granite_`` for
    granite-20b, ``hybrid_``, ``moe_``, ``vlm_`` and ``encdec_`` for
    zamba2-1.2b, deepseek-moe-16b, llava-next-34b and
    seamless-m4t-large-v2; a smoke twin takes its model's)."""
    return PHASE_PREFIX[cfg.name.removesuffix("-smoke")] + base


def norm_kernel(cfg) -> str:
    """The kernel of a model's norms: layernorm for ``norm="ln"``."""
    return "layernorm" if cfg.norm == "ln" else "rmsnorm"


def emit(record: dict) -> dict:
    print(json.dumps({**record, "at_s": round(time.perf_counter() - T_START, 1)}), flush=True)
    return record


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


def matrix_mul(width: int):
    """The SDK's MatrixMulCUDA for n = ``width``: its tile loop needs a
    static bound, so the width is a constant of the kernel."""

    @cox.kernel
    def MatrixMulCUDA(
        c,
        out: cox.Array(cox.f32),
        a: cox.Array(cox.f32),
        b: cox.Array(cox.f32),
        n: cox.i32,
    ):
        # the SDK's tiled 16x16 matmul, <<<dim3(n/16, n/16), dim3(16, 16)>>>
        tile_a = c.shared((16, 16), cox.f32)
        tile_b = c.shared((16, 16), cox.f32)
        ty = c.thread_idx("y")
        tx = c.thread_idx("x")
        row = c.block_idx("y") * 16 + ty
        col = c.block_idx("x") * 16 + tx
        acc = 0.0
        for t in range(0, width, 16):
            tile_a[ty, tx] = a[row * n + t + tx]
            tile_b[ty, tx] = b[(t + ty) * n + col]
            c.syncthreads()
            for kk in range(16):
                acc = acc + tile_a[ty, kk] * tile_b[kk, tx]
            c.syncthreads()
        out[row * n + col] = acc

    return MatrixMulCUDA


MatrixMulCUDA = matrix_mul(MM_N)
MatrixMulCUDA_scan = matrix_mul(MM_SCAN_N)


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


# the runtime services' chain (tests/test_graphs.py's saxpy -> scale ->
# tile_sum) and a kernel whose auto knobs resolve to the batched warp
# plane, so a fault walks the degradation ladder
@cox.kernel
def svc_saxpy(
    c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), y: cox.Array(cox.f32), n: cox.i32
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


@cox.kernel
def svc_scale(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] * 3.0 + 1.0


@cox.kernel
def svc_tile_sum(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), n: cox.i32):
    tile = c.shared((256,), cox.f32)
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    v = 0.0
    if i < n:
        v = x[i]
    tile[c.thread_idx()] = v
    c.syncthreads()
    s = 0.0
    for k in range(256):
        s += tile[k]
    out[c.block_idx()] = s


@cox.kernel
def svc_warpstage(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32)):
    tile = c.shared((4,), cox.f32)
    tid = c.thread_idx()
    v = a[c.block_idx() * c.block_dim() + tid]
    s = c.red_add(v)
    if c.lane_id() == 0:
        tile[c.warp_id()] = s
    c.syncthreads()
    t = tile[tid % 4]
    out[c.block_idx() * c.block_dim() + tid] = v + t


# the multi-device phase's kernels (tests/multidevice_kernels.py's bodies)
@cox.kernel
def vec_madd(
    c, out: cox.Array(cox.f32), a: cox.Array(cox.f32), b: cox.Array(cox.f32), n: cox.i32
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * 2.0 + b[i]


@cox.kernel
def histogram(c, hist: cox.Array(cox.f32), data: cox.Array(cox.i32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, data[i], 1.0)


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one call where a call's host work outlasts its
    device work (the serving shapes, whose median_ms reads the host): the
    calls captured in one CUDA graph, the graph replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, calls=1) / calls


def bound(bytes_moved: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
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


def tensor_core_ops(lib: pathlib.Path) -> dict:
    """Counts of the tensor-core instructions in a built library's SASS
    (``cuobjdump -sass``): HGMMA is Hopper's wgmma, HMMA mma.sync."""
    cuobjdump = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True
    ).stdout
    return {op: sass.count(op) for op in ("HGMMA", "HMMA")}


def ptxas_by_kernel(report: str) -> dict:
    """{kernel: "N registers, S bytes spilled"} from nvcc's ``-Xptxas -v``
    report, the names demangled by ``c++filt`` (from the host toolchain
    nvcc needs) without their namespaces and parameters."""
    usage, fn, spill = {}, None, "?"
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "bytes spill stores" in ln:
            spill = ln.split("bytes stack frame,")[-1].split("bytes spill stores")[0].strip()
        elif "Used" in ln and "registers" in ln and fn:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            usage[fn] = f"{regs} registers, {spill} bytes spilled"
    names = subprocess.run(
        ["c++filt"], input="\n".join(usage), capture_output=True, text=True, check=True
    ).stdout.splitlines()
    short = [
        n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
        for n in names
    ]
    return dict(zip(short, usage.values()))


def phase_build() -> None:
    t0 = time.perf_counter()
    log = build.build_all()
    for name in build.SIGNATURES:
        build.library(name)
    # the bf16 attention kernels must run on the tensor cores
    tc_ops = tensor_core_ops(build._library_path("flash_attention"))
    check(tc_ops["HGMMA"] + tc_ops["HMMA"] > 0, f"flash_attention: no tensor-core op in {tc_ops}")
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "cached": {n: r["cached"] for n, r in log.items()},
            "ptxas": {name: ptxas_by_kernel(str(rec["ptxas"])) for name, rec in log.items()},
            "flash_attention_sass": tc_ops,
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
    ((64, VOCAB + 3), torch.bfloat16),  # every other row off the 16-byte boundary
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
            "plan": sm.softmax_plan(shape[0], shape[1], dtype, x.device).summary(shape[0]),
            "ms": median_ms(lambda: sm.softmax_cuda(x)),
            # the device alone: the small cases' eager calls read the host
            "graph_ms": graph_ms(lambda: sm.softmax_cuda(x)),
            "plain_ms": median_ms(lambda: ref.softmax(x)),
            "library_ms": median_ms(lambda: torch.softmax(x, dim=-1)),
            "library_graph_ms": graph_ms(lambda: torch.softmax(x, dim=-1)),
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


SSM_TOKENS = SSM_TRAIN["batch"] * SSM_TRAIN["seq"]
SSM_D_MODEL, SSM_D_INNER = 768, 1536  # mamba2-130m
HYBRID_TOKENS = HYBRID_TRAIN["batch"] * HYBRID_TRAIN["seq"]
HYBRID_D_MODEL, HYBRID_D_INNER = 2048, 4096  # zamba2-1.2b (deepseek-moe-16b's d too)
VLM_D_MODEL = 7168  # llava-next-34b
# rmsnorm: (shape, x dtype, w dtype); the headline, the serving shape
# (the decode batch of the serve phase), f32, a ragged unaligned width,
# mamba2-130m's inner norm in training and its norm in serving; then
# zamba2-1.2b's and llava-next-34b's in serving and training (zamba2's
# d 2,048 is deepseek-moe-16b's too)
RMS_CASES = [
    ((8192, D_MODEL), torch.bfloat16, torch.float32),
    ((SERVE["batch"], D_MODEL), torch.bfloat16, torch.float32),
    ((8192, D_MODEL), torch.float32, torch.float32),
    ((3, 1001), torch.float32, torch.float32),
    ((SSM_TOKENS, SSM_D_INNER), torch.bfloat16, torch.float32),
    ((SERVE["batch"], SSM_D_MODEL), torch.bfloat16, torch.float32),
    ((SERVE["batch"], HYBRID_D_MODEL), torch.bfloat16, torch.float32),
    ((SERVE["batch"], HYBRID_D_INNER), torch.bfloat16, torch.float32),
    ((SERVE["batch"], VLM_D_MODEL), torch.bfloat16, torch.float32),
    ((HYBRID_TOKENS, HYBRID_D_INNER), torch.bfloat16, torch.float32),
    ((8192, VLM_D_MODEL), torch.bfloat16, torch.float32),
]
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# flash_decode: (B, S, kv_len per row, dtype, query heads, kv heads, head
# dim); the headline is one layer of decode_32k's context, then ragged
# lengths (1 and past S), the serve phase's shape, and f32, at
# qwen2.5-14b's 40/8 heads; then granite-20b's MQA (48 heads over 1, g =
# 48) at the serve phase's shape and in f32; then at the serve phase's
# shape zamba2-1.2b's shared block (32/32 heads of 64, G 1) and a full
# ring of its window, deepseek-moe-16b's 16/16 and llava-next-34b's 56/8
# (g = 7); then seamless-m4t-large-v2's self cache (16/16 of 64) and its
# cross memory of ENC_LEN rows, read whole
SERVE_LENS = [300, 400, 500, 512]
DECODE_CASES = [
    (8, 32768, [32768] * 8, torch.bfloat16, N_HEADS, N_KV, D_HEAD),
    (4, 4096, [1, 1000, 4096, 5000], torch.bfloat16, N_HEADS, N_KV, D_HEAD),
    (SERVE["batch"], SERVE["ctx"], SERVE_LENS, torch.bfloat16, N_HEADS, N_KV, D_HEAD),
    (2, 2048, [2048, 77], torch.float32, N_HEADS, N_KV, D_HEAD),
    (SERVE["batch"], SERVE["ctx"], SERVE_LENS, torch.bfloat16, 48, 1, D_HEAD),
    (2, 2048, [2048, 77], torch.float32, 48, 1, D_HEAD),
    (SERVE["batch"], SERVE["ctx"], SERVE_LENS, torch.bfloat16, 32, 32, 64),
    (SERVE["batch"], 4096, [4096] * 4, torch.bfloat16, 32, 32, 64),
    (SERVE["batch"], SERVE["ctx"], SERVE_LENS, torch.bfloat16, 16, 16, D_HEAD),
    (SERVE["batch"], SERVE["ctx"], SERVE_LENS, torch.bfloat16, 56, 8, D_HEAD),
    (SERVE["batch"], SERVE["ctx"], SERVE_LENS, torch.bfloat16, 16, 16, 64),
    (SERVE["batch"], ENC_LEN, [ENC_LEN] * 4, torch.bfloat16, 16, 16, 64),
]
DECODE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-7, 1e-6)}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def phase_serving_kernels(gen: torch.Generator) -> dict:
    """rmsnorm and flash_decode against their plain versions, with the
    library call beside each; the first case of each is its headline."""
    headline = {}
    for shape, dtype, wdtype in RMS_CASES:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        got = norms.rmsnorm_cuda(x, w)
        want = ref.rmsnorm(x, w)
        torch.cuda.synchronize()
        rtol, atol = RMS_TOL[dtype]
        err = max_err(got, want)
        check(close(got, want, rtol, atol), f"rmsnorm {shape} {dtype}: err {err}")
        w_lib = w.to(dtype)  # F.rms_norm takes the weight in x's dtype
        rec = {
            "phase": "kernel",
            "name": "rmsnorm",
            "shape": list(shape),
            "dtype": _dtype_name(dtype),
            "w_dtype": _dtype_name(wdtype),
            "rtol": rtol,
            "atol": atol,
            "max_abs_err": err,
            "ms": median_ms(lambda: norms.rmsnorm_cuda(x, w)),
            "plain_ms": median_ms(lambda: ref.rmsnorm(x, w)),
            "library_ms": median_ms(
                lambda: torch.nn.functional.rms_norm(x, (shape[-1],), w_lib, eps=1e-6)
            ),
        }
        if shape[0] == SERVE["batch"]:
            rec["graph_ms"] = graph_ms(lambda: norms.rmsnorm_cuda(x, w))
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * x.numel())
        emit(rec)
        headline.setdefault("rmsnorm", rec)
    for B, S, kv_len, dtype, H, Hkv, D in DECODE_CASES:
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        got = fa.flash_decode_cuda(q, k, v, lens)
        want = ref.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        rtol, atol = DECODE_TOL[dtype]
        err = max_err(got, want)
        what = f"flash_decode B={B} S={S} H={H}/{Hkv} {dtype}"
        check(close(got, want, rtol, atol), f"{what}: err {err}")
        # the splits and the warps are combined in a fixed order
        check(torch.equal(got, fa.flash_decode_cuda(q, k, v, lens)), f"{what}: not bitwise twice")
        # the log-sum-exp output (the mesh decode's slab combine): the
        # output stays bitwise, the lse against its plain twin
        got_l, lse = fa.flash_decode_cuda(q, k, v, lens, return_lse=True)
        _, want_lse = ref.decode_attention(q, k, v, lens, return_lse=True)
        check(torch.equal(got_l, got), f"{what}: the output with lse differs")
        fin = torch.isfinite(want_lse)
        check(torch.equal(torch.isinf(lse), ~fin), f"{what}: lse -inf rows differ")
        lse_err = float((lse[fin] - want_lse[fin]).abs().max()) if fin.any() else 0.0
        check(lse_err <= 1e-4 * max(1.0, float(want_lse[fin].abs().max())), f"{what}: lse err {lse_err}")
        # the library call: SDPA on a (B, H, 1, D) query, the caches as
        # (B, Hkv, S, D) views, a boolean mask where a row is ragged
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = None
        if min(kv_len) < S:
            mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True
            )

        rec = {
            "phase": "kernel",
            "name": "flash_decode",
            "shape": [B, S, H, Hkv, D],
            "kv_len": kv_len,
            "dtype": _dtype_name(dtype),
            "rtol": rtol,
            "atol": atol,
            "max_abs_err": err,
            "ms": median_ms(lambda: fa.flash_decode_cuda(q, k, v, lens), batches=5),
            "plain_ms": median_ms(lambda: ref.decode_attention(q, k, v, lens), batches=3),
            "library_ms": median_ms(library, batches=5),
            "lse_max_abs_err": lse_err,
            "lse_ms": median_ms(lambda: fa.flash_decode_cuda(q, k, v, lens, return_lse=True), batches=5),
        }
        if B == SERVE["batch"] and S in (SERVE["ctx"], ENC_LEN):  # the serving shapes
            rec["graph_ms"] = graph_ms(lambda: fa.flash_decode_cuda(q, k, v, lens))
            rec["library_graph_ms"] = graph_ms(library)
        # the bytes this run's data needs: the valid rows of K and V
        rows = sum(min(n, S) for n in kv_len)
        kv_bytes = 2 * rows * Hkv * D * k.element_size()
        nbytes = kv_bytes + 2 * q.numel() * q.element_size() + lens.numel() * 4
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * rows * H * D)
        emit(rec)
        headline.setdefault("flash_decode", rec)
        del q, k, v, q4, k4, v4, got, want
        torch.cuda.empty_cache()
    return headline


def host_us_per_call(fn, calls: int = 300) -> float:
    """Host time per call of back-to-back calls whose device work is
    shorter than their host work, so the host clock reads the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def serve_cache_bytes(cfg, run: dict = SERVE) -> int:
    """The cache bytes a decode step moves: every K/V row read (the
    attention layers' caches, the hybrid's rings, the encoder-decoder's
    cross memory), and the recurrent state read and written (SSM
    layers)."""
    shape = ShapeConfig("serve", run["ctx"], run["batch"], "decode")
    specs = launch_specs.cache_spec_tree(cfg, shape)
    nbytes = {k: math.prod(s.shape) * s.dtype.itemsize for k, s in specs.items()}
    return sum(n if k in ("k", "v", "xk", "xv") else 2 * n for k, n in nbytes.items())


def decode_weight_bytes(cfg) -> int:
    """The weight bytes a decode step reads: every parameter, counted as
    bf16; for an encoder-decoder model only those its decode step reads:
    the decoder's, the final norm's and the (tied) unembedding's, not the
    encoder's, nor the cross-attention's wk and wv, whose products sit in
    the cache."""
    if cfg.family != "encdec":
        return cfg.param_count() * 2
    specs = steps.model_specs(cfg)
    read = {k: v for k, v in specs.items() if k in ("embed", "final_norm", "final_norm_b")}
    read["dec_layers"] = dict(specs["dec_layers"])
    read["dec_layers"]["xattn"] = {k: specs["dec_layers"]["xattn"][k] for k in ("wq", "wo")}
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in tree_leaves(read))


def applications(cfg) -> int:
    """The hybrid family's applications of its shared block (0 for the
    other families): one after each group of Mamba2 layers."""
    return len(lm._groups(cfg)) if cfg.family == "hybrid" else 0


def decode_launches(cfg) -> tuple:
    """(norm, flash_decode) launches of one decode step: two norms a layer
    (an SSM layer's ln1 and inner norm, an attention layer's ln1 and ln2)
    and the final one, and one flash_decode an attention layer; the
    hybrid's shared block adds two norms and one flash_decode an
    application; an encoder-decoder layer has three norms (ln1, lnx,
    ln2) and two flash_decode (its self cache, its cross memory)."""
    apps = applications(cfg)
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + 1, 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return 2 * cfg.n_layers + 2 * apps + 1, apps
    return 2 * cfg.n_layers + 1, 0 if cfg.family == "ssm" else cfg.n_layers


def expert_params(cfg) -> int:
    """One routed expert's weights (gate, up and down) of a MoE layer."""
    return 3 * cfg.d_model * (cfg.d_expert or cfg.d_ff)


@contextlib.contextmanager
def served_tokens():
    """The next tokens of every decode step of every ``BatchedServer``
    inside the block (every slot's, active or not), as host arrays."""
    seen, plain = [], serve.BatchedServer._step_all

    def record(self):
        nxt = plain(self)
        seen.append(nxt.copy())
        return nxt

    serve.BatchedServer._step_all = record
    try:
        yield seen
    finally:
        serve.BatchedServer._step_all = plain


def phase_serve(cpu_tokens: int, arch=ARCH, cuts: str = "none", run: dict = SERVE) -> dict:
    """A main path's serving part: serve_requests through the port's
    BatchedServer at full width and depth in bf16 (``arch`` a registry
    name, or a config with its depth cut, as ``cuts`` says), with the
    requests of ``run``.  No served token may index a padded column of
    the vocabulary (``round_up(vocab, 256)``).  A MoE model's dropped
    share of its (token, choice) pairs is recorded."""
    cfg = registry.get(arch) if isinstance(arch, str) else arch
    name = phase_name(cfg, "serve")
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    moe = cfg.family == "moe"
    # device None: the entry point's default, the card
    with served_tokens() as seen, (moe_drops() if moe else contextlib.nullcontext([])) as drops:
        out = serve.serve_requests(cfg, device=None if DEVICE == "cuda" else DEVICE, **run)
    after = ops.launch_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    check(out["completed"] == run["n_requests"], f"served {out['completed']} requests")
    check(out["tokens"] == cpu_tokens, f"served {out['tokens']} tokens, CPU {cpu_tokens}")
    padded = int(sum((t >= cfg.vocab).sum() for t in seen))
    check(padded == 0, f"{name}: {padded} next tokens index the padded vocabulary columns")
    steps = out["steps"]
    norm = norm_kernel(cfg)
    per_step = {n: (after[n] - before[n]) / steps for n in (norm, "flash_decode")}
    want_norm, want_decode = decode_launches(cfg)
    check(per_step[norm] == want_norm, f"{norm} launches {per_step}, want {want_norm}")
    check(per_step["flash_decode"] == want_decode, f"flash_decode launches {per_step}")
    weight_bytes = decode_weight_bytes(cfg)
    cache_bytes = serve_cache_bytes(cfg, run)
    extra = {}
    if moe:
        # the capacity dispatch reads every expert (the bound below); the
        # step's routing can touch at most B x k experts a layer
        idle = max(cfg.n_experts - run["batch"] * cfg.top_k, 0)
        touched = weight_bytes - 2 * cfg.n_layers * idle * expert_params(cfg)
        dropped = torch.stack(drops).sum(0).cpu()
        extra = {
            "touched_weight_bytes": touched,
            "bound_touched_ms_per_step": (touched + cache_bytes) / HBM_BYTES_PER_S * 1e3,
            "dropped_share": float(dropped[0] / dropped[1]),
            "capacity_factor": cfg.capacity_factor,
        }
    rec = {
        "phase": name,
        "arch": cfg.name,
        "cuts": cuts,
        **{k: run[k] for k in ("batch", "ctx", "n_requests", "max_tokens")},
        "vocab": cfg.vocab,
        "padded_tokens": padded,
        "n_layers": cfg.n_layers,
        "dtype": "bfloat16",
        "completed": out["completed"],
        "tokens": out["tokens"],
        "steps": steps,
        "decode_steps": len(out["step_s"]),
        "step_ms_median": statistics.median(out["step_s"]) * 1e3,
        "step_ms_p90": sorted(out["step_s"])[int(0.9 * len(out["step_s"]))] * 1e3,
        "tok_per_s": out["tok_per_s"],
        "wall_s": out["wall_s"],
        "init_s": out["init_s"],
        "weight_bytes": weight_bytes,
        "cache_bytes": cache_bytes,
        "bound_ms_per_step": (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
        **extra,
        "launches_per_step": per_step,
        "peak_alloc_gb": peak / 1e9,
    }
    emit(rec)
    return rec


def phase_wrapper_host(gen: torch.Generator, serve_rec: dict) -> None:
    """The wrappers' host time per call at the serve phase's shapes (the
    softmax's at the three-way phase's, beside ``torch.softmax``'s),
    beside a plain PyTorch call's, and their share of a decode step."""
    B, S = SERVE["batch"], SERVE["ctx"]
    x = torch.randn(B, D_MODEL, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.ones(D_MODEL, device="cuda")
    xg = torch.randn(B, GRANITE_D_MODEL, generator=gen, device="cuda").to(torch.bfloat16)
    wg = torch.ones(GRANITE_D_MODEL, device="cuda")
    bg = torch.zeros(GRANITE_D_MODEL, device="cuda")
    q = torch.randn(B, N_HEADS, D_HEAD, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, S, N_KV, D_HEAD, generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    rms_us = host_us_per_call(lambda: norms.rmsnorm_cuda(x, w))
    ln_us = host_us_per_call(lambda: norms.layernorm_cuda(xg, wg, bg))
    fd_us = host_us_per_call(lambda: fa.flash_decode_cuda(q, k, k, lens))
    logits = torch.randn(SOFTMAX_ROWS, VOCAB, generator=gen, device="cuda")
    sm_us = host_us_per_call(lambda: sm.softmax_cuda(logits))
    torch_sm_us = host_us_per_call(lambda: torch.softmax(logits, dim=-1))
    add_us = host_us_per_call(lambda: torch.add(x, x))
    per = serve_rec["launches_per_step"]
    host_ms = (per["rmsnorm"] * rms_us + per["flash_decode"] * fd_us) / 1e3
    emit(
        {
            "phase": "wrapper_host",
            "rmsnorm_host_us": rms_us,
            "layernorm_host_us": ln_us,
            "flash_decode_host_us": fd_us,
            # the three-way phase's shape; recorded only
            "softmax_host_us": sm_us,
            "torch_softmax_host_us": torch_sm_us,
            "torch_add_host_us": add_us,
            "wrappers_host_ms_per_step": host_ms,
            "wrappers_host_share_of_step": host_ms / serve_rec["step_ms_median"],
        }
    )


PROFILE_STEPS = 3  # decode steps traced by phase_serve_profile


def phase_serve_profile(arch=ARCH) -> None:
    """Where a decode step's time goes: torch.profiler over a few steps of
    a BatchedServer at the serve phase's width, depth, batch and context,
    after its slots are prefilled.  Device busy time is the sum of the
    kernels' own times; the rest of the traced wall time the card idles.
    The profiler adds host time to every op, so the traced step is slower
    than the serve phase's."""
    from torch.profiler import ProfilerActivity, profile

    server = serve.BatchedServer(arch, batch=SERVE["batch"], ctx=SERVE["ctx"], seed=0)
    name = phase_name(server.cfg, "serve_profile")
    arch = server.cfg.name
    rng = np.random.default_rng(SERVE["seed"])
    for slot in range(SERVE["batch"]):
        server.prefill_prompt(slot, list(rng.integers(1, server.cfg.vocab, size=8)))
    server.decode(2)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.decode(PROFILE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_ops(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit(
        {
            "phase": name,
            "arch": arch,
            "steps": PROFILE_STEPS,
            "traced_step_ms": wall / PROFILE_STEPS * 1e3,
            "device_busy_ms_per_step": busy_us / PROFILE_STEPS / 1e3,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "device_ops_per_step": sum(e.count for e in kernels) / PROFILE_STEPS,
            "top_device_ms_per_step": {
                e.key[:60]: [
                    e.self_device_time_total / PROFILE_STEPS / 1e3,
                    e.count // PROFILE_STEPS,
                ]
                for e in top
            },
        }
    )
    del server
    torch.cuda.empty_cache()


def _randomise_zero_inits(params, gen) -> None:
    """Biases, A_log and dt_bias start at zero, norm weights and D at one:
    draw them so the cross-check runs their paths (A = -exp(A_log) stays
    negative).  The QKV biases and the norm biases are drawn where the
    model has them; an encoder-decoder model's every norm, in both
    stacks."""
    if "dec_layers" in params:
        draws = [(params, n, 0.0 if n.endswith("_b") else 1.0) for n in params if "norm" in n]
        for stack in (params["enc_layers"], params["dec_layers"]):
            names = [n for n in stack if n.startswith("ln")]
            draws += [(stack, n, 0.0 if n.endswith("_b") else 1.0) for n in names]
        for tree, name, mean in draws:
            tree[name].copy_(mean + 0.3 * torch.randn(tree[name].shape, generator=gen))
        return
    layers = params["layers"]
    draws = [(params, "final_norm", 1.0), (layers, "ln1", 1.0)]
    if "shared_attn" in params:  # the hybrid's shared block
        draws += [(params["shared_attn"], name, 1.0) for name in ("ln1", "ln2")]
    draws += [(t, n, 0.0) for t, n in ((params, "final_norm_b"), (layers, "ln1_b")) if n in t]
    if "attn" in layers:
        attn = layers["attn"]
        draws += [(attn, name, 0.0) for name in ("bq", "bk", "bv") if name in attn]
        draws.append((layers, "ln2", 1.0))
        draws += [(layers, "ln2_b", 0.0)] if "ln2_b" in layers else []
    else:
        m = layers["mamba"]
        draws += [(m, "A_log", 0.0), (m, "dt_bias", 0.0), (m, "D", 1.0), (m, "norm", 1.0)]
    for tree, name, mean in draws:
        tree[name].copy_(mean + 0.3 * torch.randn(tree[name].shape, generator=gen))


def _attention_blocks(tree):
    for sub in tree.values():
        if isinstance(sub, dict):
            yield from [sub] if "wq" in sub else _attention_blocks(sub)


def at_model_fan_in(params) -> None:
    """Scale every attention block's wq and wk, (..., d, H, Dh), in place
    from the reference's init, whose fan-in is the head count, to a
    fan-in of d_model.  The encoder-decoder model's phases start from
    these weights, as the CPU tests draw them: at the reference's own
    init its attention is nearly one-hot and the gradient grows layer
    after layer from the loss back, so at 24 + 24 layers its norm
    overflows f32 (``phase_reference_init``; the JAX package likewise,
    ROADMAP C.3), and f32 card-vs-CPU checks part by amplified rounding
    (C.4)."""
    for block in _attention_blocks(params):
        for name in ("wq", "wk"):
            w = block[name]
            w.mul_(math.sqrt(w.shape[-2] / w.shape[-3]))


def _cross_weights(cfg, seed: int) -> tuple:
    """``(cpu, card)``: the same weights on each side for a card-vs-CPU
    check, drawn from ``seed`` on DEVICE (at full width the CPU's generator
    takes ~10x longer), the zero and one initialisations randomised (an
    encoder-decoder model's attention at ``at_model_fan_in``).  Each
    side has its own copy: the train step updates its weights in place."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    drawn = init_params(steps.model_specs(cfg), gen, DEVICE)
    cpu = tree_map(lambda t: t.to("cpu", copy=True), drawn)
    del drawn
    _randomise_zero_inits(cpu, torch.Generator().manual_seed(seed))
    if cfg.family == "encdec":
        at_model_fan_in(cpu)
    return cpu, tree_map(lambda t: t.to(DEVICE, copy=True), cpu)


@contextlib.contextmanager
def router_logits():
    """The router logits of every ``topk_gate`` call made inside the block,
    copied to the host, in call order (one call a MoE layer)."""
    seen, plain = [], ops.topk_gate

    def record(logits, k):
        seen.append(logits.detach().to("cpu", copy=True))
        return plain(logits, k)

    ops.topk_gate = record
    try:
        yield seen
    finally:
        ops.topk_gate = plain


def routing_flips(card: torch.Tensor, cpu: torch.Tensor, k: int) -> torch.Tensor:
    """Per token (row) of one router call: 0 where the card's top k, in
    order, equal the CPU's; 1 where they differ by one swap of adjacent
    ranks r, r + 1 (r < k) whose CPU gap is below the two logits' own
    card-vs-CPU differences, a near tie that rounding can flip; 2
    otherwise (a fault)."""
    vals, idx = torch.sort(cpu, dim=-1, descending=True, stable=True)
    idx_d = torch.sort(card, dim=-1, descending=True, stable=True).indices
    out = torch.zeros(cpu.shape[0], dtype=torch.int64)
    for t in torch.nonzero((idx[:, :k] != idx_d[:, :k]).any(-1)).flatten().tolist():
        r = int(torch.nonzero(idx[t, :k] != idx_d[t, :k])[0])
        swapped = idx[t, : k + 1].clone()
        swapped[[r, r + 1]] = idx[t, [r + 1, r]]
        a, b = idx[t, r], idx[t, r + 1]
        gap = float(vals[t, r] - vals[t, r + 1])
        moved = float((card[t, a] - cpu[t, a]).abs() + (card[t, b] - cpu[t, b]).abs())
        out[t] = 1 if torch.equal(swapped[:k], idx_d[t, :k]) and gap < moved else 2
    return out


def phase_cross_check(arch: str = ARCH) -> None:
    """A serving path on the card (the CUDA kernels) against the same path
    on the CPU (their plain versions), same weights: the model at full
    width, 2 layers, f32 (TF32 off, PyTorch's default for matmul); the
    logits and every cache leaf (K/V, the SSM state h and conv, or both,
    the hybrid's K/V rings at a cut window so that they wrap).

    A MoE model's router top-k is compared first, layer by layer: a batch
    row whose choice flips on a near tie (``routing_flips``) is counted
    and left out of the comparisons from then on (its later hidden
    states, logits and cache rows follow another expert); any other flip
    fails."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    changes, cuts = dict(n_layers=CROSS_LAYERS, param_dtype=torch.float32), "none"
    base = registry.get(arch)
    if base.family == "encdec":
        changes["enc_layers"] = CROSS_LAYERS
    if base.family == "hybrid":
        changes["window"] = HYBRID_CROSS_WINDOW
        cuts = (
            f"window {base.window:,} -> {HYBRID_CROSS_WINDOW}: the ring wraps under "
            f"ctx {CROSS_CTX}"
        )
    cfg = dataclasses.replace(base, **changes)
    name = phase_name(cfg, "cross_check")
    t0 = time.perf_counter()
    cpu, card = _cross_weights(cfg, 1)
    init_s = time.perf_counter() - t0
    B = CROSS_BATCH
    extra = {}
    if cfg.family == "encdec":
        specs = encdec.cache_specs(cfg, B, CROSS_CTX, ENC_LEN)
        decode = encdec.decode_step
    else:
        specs = lm.cache_specs(cfg, B, CROSS_CTX)
        decode = lm.decode_step
    cache_cpu = init_params(specs, None, "cpu")
    cache_card = init_params(specs, None, DEVICE)
    if cfg.family == "encdec":
        xk, xv, extra = _cross_memory(cfg, cpu, card, B)
        cache_card["xk"].copy_(xk)
        cache_card["xv"].copy_(xv)
        cache_cpu["xk"].copy_(xk.cpu())
        cache_cpu["xv"].copy_(xv.cpu())
        del xk, xv
    rng = np.random.default_rng(2)
    worst, counts0 = 0.0, ops.launch_counts()
    kept = torch.ones(B, dtype=torch.bool)  # rows whose routing never flipped
    near_ties = 0
    for step in range(CROSS_STEPS):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=B).astype(np.int32))
        # one slot at, then past, the end of the cache: the write clamps
        pos = torch.tensor([step, 10 + step, 40 + step, CROSS_CTX - 1 + step], dtype=torch.int32)
        with router_logits() as seen_cpu:
            want, cache_cpu = decode(cfg, cpu, cache_cpu, toks, pos)
        with router_logits() as seen_card:
            got, cache_card = decode(cfg, card, cache_card, toks.to(DEVICE), pos.to(DEVICE))
        for got_l, want_l in zip(seen_card, seen_cpu):
            flips = routing_flips(got_l, want_l, cfg.top_k)
            check(not (flips[kept] == 2).any(), f"{name} step {step}: routing differs {flips}")
            near_ties += int((flips[kept] == 1).sum())
            kept &= flips == 0
        check(bool(kept.any()), f"{name} step {step}: every row's routing flipped")
        got, want = got.cpu()[kept], want[kept]
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        check(rel <= CROSS_RTOL, f"cross-check step {step}: logits rel err {rel}")
        check(torch.equal(got.argmax(-1), want.argmax(-1)), f"cross-check step {step}: tokens")
    counts = ops.launch_counts()
    norm = norm_kernel(cfg)
    launched = {n: counts[n] - counts0[n] for n in (norm, "flash_decode")}
    want_norm, want_decode = decode_launches(cfg)
    check(launched["flash_decode"] == CROSS_STEPS * want_decode, f"launches {launched}")
    check(launched[norm] == CROSS_STEPS * want_norm, f"launches {launched}")
    cache_rel = {}
    for leaf in cache_cpu:
        want = cache_cpu[leaf][:, kept]  # every leaf is (layers, B, ...)
        rel = float((cache_card[leaf].cpu()[:, kept] - want).abs().max() / want.abs().max())
        check(rel <= CROSS_RTOL, f"{name} {leaf} cache rel err {rel}")
        cache_rel[f"{leaf}_cache_max_rel_err"] = rel
    emit(
        {
            "phase": name,
            "arch": arch,
            "n_layers": CROSS_LAYERS,
            "cuts": cuts,
            "dtype": "float32",
            "steps": CROSS_STEPS,
            "batch": B,
            "ctx": CROSS_CTX,
            "rtol": CROSS_RTOL,
            "logits_max_rel_err": worst,
            **cache_rel,
            "tokens_equal": True,
            "routing_near_tie_flips": near_ties,
            "rows_left_out": int((~kept).sum()),
            "launches": launched,
            "init_s": init_s,
            **extra,
        }
    )


def _cross_memory(cfg, cpu, card, B: int) -> tuple:
    """An encoder-decoder model's cross K/V for the decode cross-check, so
    that both sides decode over the same memory that is not zero: the
    port's ``encode`` of random frames of ENC_LEN rows and each decoder
    layer's ``_mem_kv`` of it, on the card.  ``encode`` is held on the
    card against the CPU within CROSS_RTOL of the memory's largest
    magnitude.  Returns ``(xk, xv, record)``, xk and xv (layers, B,
    ENC_LEN, Hkv, Dh) on the card."""
    frames = torch.randn(B, ENC_LEN, cfg.d_model, generator=torch.Generator().manual_seed(5))
    counts0 = ops.launch_counts()
    with torch.no_grad():
        mem = encdec.encode(cfg, card, frames.to(DEVICE))
        sync()
        launched = {n: c - counts0[n] for n, c in ops.launch_counts().items() if c > counts0[n]}
        t0 = time.perf_counter()
        want = encdec.encode(cfg, cpu, frames)
        cpu_s = time.perf_counter() - t0
        rel = float((mem.cpu() - want).abs().max() / want.abs().max())
        check(rel <= CROSS_RTOL, f"encode rel err {rel}")
        kv = [encdec._mem_kv(lm._layer(card["dec_layers"]["xattn"], i), mem) for i in range(cfg.n_layers)]
    xk, xv = (torch.stack(t) for t in zip(*kv))
    record = {
        "enc_len": ENC_LEN,
        "encode_max_rel_err": rel,
        "encode_launches": launched,
        "encode_cpu_s": cpu_s,
    }
    return xk, xv, record


# ---------------------------------------------------------------------------
# training: its kernels, the train phase, its profile and the cross-check
# ---------------------------------------------------------------------------

# flash attention: (B, S, H, Hkv, D, causal, window, dtype).  The headline
# is one layer of the train phase in bf16; then one layer of the granite
# train phase (MQA: 48 query heads over 1 kv head) in bf16, timed next to
# it so the two compare on the card in one state; then both in f32, the
# reference sweeps (tests/test_kernels.py) causal and not and its
# windowed case, in f32 and bf16.
TRAIN_SHAPE = (TRAIN["batch"], TRAIN["seq"], N_HEADS, N_KV, D_HEAD)
GRANITE_TRAIN_SHAPE = (
    GRANITE_TRAIN["batch"], GRANITE_TRAIN["seq"], GRANITE_HEADS, GRANITE_KV, D_HEAD
)
TRAIN_ATTN_CASES = (
    [(*shape, True, 0, dtype) for dtype in (torch.bfloat16, torch.float32)
     for shape in (TRAIN_SHAPE, GRANITE_TRAIN_SHAPE)]
    # one layer of the new families' train phases, bf16: zamba2-1.2b's
    # shared block (32/32 heads of 64, window 4,096), deepseek-moe-16b's
    # 16/16 of 128, llava-next-34b's 56/8 (g = 7), seamless's
    + [
        (HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"], 32, 32, 64, True, 4096, torch.bfloat16),
        (MOE_TRAIN["batch"], MOE_TRAIN["seq"], 16, 16, D_HEAD, True, 0, torch.bfloat16),
        (VLM_TRAIN["batch"], VLM_TRAIN["seq"], 56, 8, D_HEAD, True, 0, torch.bfloat16),
        # seamless-m4t-large-v2's encoder and cross-attention (non-causal)
        # and its decoder's self-attention: 16/16 heads of 64
        (ENCDEC_TRAIN["batch"], ENCDEC_TRAIN["seq"], 16, 16, 64, False, 0, torch.bfloat16),
        (ENCDEC_TRAIN["batch"], ENCDEC_TRAIN["seq"], 16, 16, 64, True, 0, torch.bfloat16),
    ]
    + [
        (1, S, H, Hkv, D, causal, 0, dtype)
        for S, H, Hkv, D in ((256, 4, 4, 64), (256, 8, 2, 64), (128, 4, 1, 128))
        for causal in (True, False)
        for dtype in (torch.float32, torch.bfloat16)
    ]
    + [(1, 256, 2, 2, 64, True, 64, dtype) for dtype in (torch.float32, torch.bfloat16)]
)
# f32: the reference's 1e-4.  bf16: against the plain version in f32 on
# the same bf16 inputs; each output is an f32 value rounded once to bf16
# (rtol 2^-7, atol 1e-5 of the largest magnitude for entries near zero);
# the attention gradients also see the forward output rounded to bf16
# inside delta = rowsum(dO * O), which moves dS by up to a bf16 step of
# delta: 1e-2 of their largest magnitude.  (rtol, atol as a share of the
# largest magnitude)
TRAIN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-7, 1e-5)}
ATTN_GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-7, 1e-2)}
# rmsnorm backward: the train phase's (B x S, d_model) in bf16 with f32 w,
# then f32, a ragged width, mamba2-130m's two norms in training, then
# zamba2-1.2b's two and llava-next-34b's
RMS_BWD_CASES = [
    ((TRAIN["batch"] * TRAIN["seq"], D_MODEL), torch.bfloat16, torch.float32),
    ((TRAIN["batch"] * TRAIN["seq"], D_MODEL), torch.float32, torch.float32),
    ((3, 1001), torch.float32, torch.float32),
    ((SSM_TOKENS, SSM_D_INNER), torch.bfloat16, torch.float32),
    ((SSM_TOKENS, SSM_D_MODEL), torch.bfloat16, torch.float32),
    ((HYBRID_TOKENS, HYBRID_D_MODEL), torch.bfloat16, torch.float32),
    ((HYBRID_TOKENS, HYBRID_D_INNER), torch.bfloat16, torch.float32),
    ((8192, VLM_D_MODEL), torch.bfloat16, torch.float32),
]


def scaled_err(got: torch.Tensor, want: torch.Tensor, rtol: float, scale_atol: float) -> tuple:
    """(max abs error, whether |got - want| <= atol + rtol |want| with atol
    a share of want's largest magnitude)."""
    want = want.float()
    atol = scale_atol * float(want.abs().max())
    return max_err(got, want), close(got, want, rtol, atol)


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask lets through, per sequence and head."""
    if not causal:
        return S * S
    if not window:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _ops_per_s(dtype) -> float:
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S


def phase_train_kernels(gen: torch.Generator) -> dict:
    """flash_attention (forward), flash_attention_bwd and rmsnorm_bwd
    against their plain versions (autograd through them), with the
    library call beside each; the first case of each is its headline.
    The library calls: scaled_dot_product_attention with enable_gqa,
    forward, and for the backward kernel its backward alone (the graph
    kept) and forward+backward; F.rms_norm's backward alone.  The plain backward's time
    includes its forward (autograd recomputes nothing else)."""
    headline = {}
    F = torch.nn.functional
    for B, S, H, Hkv, D, causal, window, dtype in TRAIN_ATTN_CASES:
        big = S >= 4096
        q = (0.5 * torch.randn(B, S, H, D, generator=gen, device="cuda")).to(dtype)
        k = (0.5 * torch.randn(B, S, Hkv, D, generator=gen, device="cuda")).to(dtype)
        v = (0.5 * torch.randn(B, S, Hkv, D, generator=gen, device="cuda")).to(dtype)
        do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
        mask = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_cuda(q, k, v, **mask)
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
        if big:  # the backward is deterministic: the same bits twice
            again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
            bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
            check(bitwise, f"flash_attention_bwd B={B} S={S} H={H}/{Hkv} {dtype}: not repeatable")
            del again
        f32 = [t.float() for t in (q, k, v, do)]
        want_o = ref.attention(*f32[:3], **mask)
        want_g = ref.attention_bwd(*f32, **mask)
        torch.cuda.synchronize()
        what = f"B={B} S={S} H={H}/{Hkv} D={D} causal={causal} window={window} {dtype}"
        err_o, ok = scaled_err(o, want_o, *TRAIN_TOL[dtype])
        check(ok, f"flash_attention {what}: err {err_o}")
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, want_g):
            errs[name], ok = scaled_err(got, want, *ATTN_GRAD_TOL[dtype])
            check(ok, f"flash_attention_bwd {name} {what}: err {errs[name]}")
        del want_o, want_g, f32, grads
        lib_fwd = lib_bwd = lib_fwd_bwd = None
        if not window or window >= S:  # SDPA has no single call for a window under S
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_fwd = median_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True
                )
            )
            lib_bwd = median_ms(
                lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True), batches=5
            )
            lib_fwd_bwd = median_ms(
                lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True),
                    leaves,
                    dot,
                ),
                batches=5,
            )
            del out, leaves
        reps = dict(batches=5, calls=3) if big else {}
        pairs = visible_pairs(S, causal, window)
        esize = q.element_size()
        io = (2 * q.numel() + k.numel() + v.numel()) * esize  # q, k, v read; o written
        base = {
            "phase": "kernel",
            "shape": [B, S, H, Hkv, D],
            "causal": causal,
            "window": window,
            "dtype": _dtype_name(dtype),
            "rtol": TRAIN_TOL[dtype][0],
            "atol_of_max": TRAIN_TOL[dtype][1],
        }
        rec = {
            **base,
            "name": "flash_attention",
            "max_abs_err": err_o,
            "ms": median_ms(lambda: fa.flash_attention_cuda(q, k, v, **mask), **reps),
            "plain_ms": median_ms(lambda: ref.attention(q, k, v, **mask), batches=3, calls=2),
            "library_ms": lib_fwd,
        }
        ops_fwd = 4 * D * pairs * B * H
        rec["bound_ms"], rec["bound_by"] = bound(io + lse.numel() * 4, ops_fwd, _ops_per_s(dtype))
        emit(rec)
        headline.setdefault("flash_attention", rec)
        rec = {
            **base,
            "name": "flash_attention_bwd",
            "rtol": ATTN_GRAD_TOL[dtype][0],
            "atol_of_max": ATTN_GRAD_TOL[dtype][1],
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_grad": errs,
            "ms": median_ms(
                lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask), **reps
            ),
            "plain_ms": median_ms(
                lambda: ref.attention_bwd(q, k, v, do, **mask), batches=3, calls=1
            ),
            "library_ms": lib_bwd,
            "library": "scaled_dot_product_attention backward alone",
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "dkdv_splits": fa.dkdv_splits(B, S, Hkv, H // Hkv, q.device)
            if dtype == torch.bfloat16
            else 1,
        }
        # q, k, v, o, dO and lse read; dq, dk, dv written; five products
        nbytes = (3 * q.numel() + 2 * k.numel() + 2 * v.numel()) * esize + lse.numel() * 4
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 10 * D * pairs * B * H, _ops_per_s(dtype))
        emit(rec)
        headline.setdefault("flash_attention_bwd", rec)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    for shape, dtype, wdtype in RMS_BWD_CASES:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dx, dw = norms.rmsnorm_bwd_cuda(x, w, dy)
        want_dx, want_dw = ref.rmsnorm_bwd(x.float(), w.float(), dy.float())
        torch.cuda.synchronize()
        err_dx, ok_dx = scaled_err(dx, want_dx, *TRAIN_TOL[dtype])
        err_dw, ok_dw = scaled_err(dw, want_dw, *TRAIN_TOL[wdtype])
        check(ok_dx and ok_dw, f"rmsnorm_bwd {shape} {dtype}: dx err {err_dx}, dw err {err_dw}")
        xg = x.detach().requires_grad_(True)
        wg = w.to(dtype).detach().requires_grad_(True)  # F.rms_norm: w in x's dtype
        y = F.rms_norm(xg, (shape[-1],), wg, eps=1e-6)
        rec = {
            "phase": "kernel",
            "name": "rmsnorm_bwd",
            "shape": list(shape),
            "dtype": _dtype_name(dtype),
            "w_dtype": _dtype_name(wdtype),
            "rtol": TRAIN_TOL[dtype][0],
            "atol_of_max": TRAIN_TOL[dtype][1],
            "max_abs_err": max(err_dx, err_dw),
            "max_abs_err_dw": err_dw,
            "ms": median_ms(lambda: norms.rmsnorm_bwd_cuda(x, w, dy)),
            "plain_ms": median_ms(lambda: ref.rmsnorm_bwd(x, w, dy)),
            "library_ms": median_ms(
                lambda: torch.autograd.grad(y, (xg, wg), dy, retain_graph=True)
            ),
            "library": "F.rms_norm backward alone",
        }
        # x and dy read, dx written; w read, dw written
        nbytes = 3 * x.numel() * x.element_size() + 2 * w.numel() * w.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 12 * x.numel())
        emit(rec)
        headline.setdefault("rmsnorm_bwd", rec)
        del x, dy, dx, want_dx, xg, y
        torch.cuda.empty_cache()
    return headline


# layernorm: (shape, x dtype, w and b dtype).  The headline is the granite
# train phase's (B x S, d_model) in bf16 with f32 w and b; then the
# serving shape (the serve phase's decode batch), f32, a bf16 case at four
# times the rows, a ragged unaligned width, and seamless's train and
# serving shapes.  The backward: the train shapes in bf16 and f32, the
# larger bf16 case, the ragged width.
LN_TOKENS = GRANITE_TRAIN["batch"] * GRANITE_TRAIN["seq"]
ENCDEC_TOKENS = ENCDEC_TRAIN["batch"] * ENCDEC_TRAIN["seq"]
LN_CASES = [
    ((LN_TOKENS, GRANITE_D_MODEL), torch.bfloat16, torch.float32),
    ((SERVE["batch"], GRANITE_D_MODEL), torch.bfloat16, torch.float32),
    ((LN_TOKENS, GRANITE_D_MODEL), torch.float32, torch.float32),
    ((4 * LN_TOKENS, GRANITE_D_MODEL), torch.bfloat16, torch.float32),
    ((3, 1001), torch.float32, torch.float32),
    # seamless-m4t-large-v2's norms in training and in serving
    ((ENCDEC_TOKENS, ENCDEC_D_MODEL), torch.bfloat16, torch.float32),
    ((SERVE["batch"], ENCDEC_D_MODEL), torch.bfloat16, torch.float32),
]
LN_BWD_CASES = [c for c in LN_CASES if c[0][0] != SERVE["batch"]]


def phase_ln_kernels(gen: torch.Generator) -> dict:
    """layernorm and layernorm_bwd against their plain versions (autograd
    through it for the backward), with F.layer_norm's forward and its
    backward alone beside them; the first case of each is its headline.
    Tolerances: rmsnorm's (RMS_TOL) forward, rmsnorm_bwd's (TRAIN_TOL)
    backward: the sums run in other orders."""
    headline = {}
    F = torch.nn.functional
    for shape, dtype, wdtype in LN_CASES:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        b = (0.3 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        got = norms.layernorm_cuda(x, w, b)
        want = ref.layernorm(x, w, b)
        torch.cuda.synchronize()
        rtol, atol = RMS_TOL[dtype]
        err = max_err(got, want)
        check(close(got, want, rtol, atol), f"layernorm {shape} {dtype}: err {err}")
        w_lib, b_lib = w.to(dtype), b.to(dtype)  # F.layer_norm: w and b in x's dtype
        rec = {
            "phase": "kernel",
            "name": "layernorm",
            "shape": list(shape),
            "dtype": _dtype_name(dtype),
            "w_dtype": _dtype_name(wdtype),
            "rtol": rtol,
            "atol": atol,
            "max_abs_err": err,
            "ms": median_ms(lambda: norms.layernorm_cuda(x, w, b)),
            "plain_ms": median_ms(lambda: ref.layernorm(x, w, b)),
            "library_ms": median_ms(
                lambda: F.layer_norm(x, (shape[-1],), w_lib, b_lib, eps=1e-6)
            ),
        }
        if shape[0] == SERVE["batch"]:
            rec["graph_ms"] = graph_ms(lambda: norms.layernorm_cuda(x, w, b))
        # x read, y written; w and b read
        nbytes = 2 * x.numel() * x.element_size() + 2 * w.numel() * w.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 8 * x.numel())
        emit(rec)
        headline.setdefault("layernorm", rec)
        del x, got, want
        torch.cuda.empty_cache()
    for shape, dtype, wdtype in LN_BWD_CASES:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        b = (0.3 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        grads = norms.layernorm_bwd_cuda(x, w, dy)
        want = ref.layernorm_bwd(x.float(), w.float(), b.float(), dy.float())
        torch.cuda.synchronize()
        errs, ok = {}, True
        for name, got, wt, tdtype in zip(("dx", "dw", "db"), grads, want, (dtype, wdtype, wdtype)):
            errs[name], ok_one = scaled_err(got, wt, *TRAIN_TOL[tdtype])
            ok = ok and ok_one
        check(ok, f"layernorm_bwd {shape} {dtype}: errs {errs}")
        del grads, want
        leaves = [t.detach().requires_grad_(True) for t in (x, w.to(dtype), b.to(dtype))]
        y = F.layer_norm(leaves[0], (shape[-1],), leaves[1], leaves[2], eps=1e-6)
        rec = {
            "phase": "kernel",
            "name": "layernorm_bwd",
            "shape": list(shape),
            "dtype": _dtype_name(dtype),
            "w_dtype": _dtype_name(wdtype),
            "rtol": TRAIN_TOL[dtype][0],
            "atol_of_max": TRAIN_TOL[dtype][1],
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_grad": errs,
            "ms": median_ms(lambda: norms.layernorm_bwd_cuda(x, w, dy)),
            "plain_ms": median_ms(lambda: ref.layernorm_bwd(x, w, b, dy)),
            "library_ms": median_ms(
                lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)
            ),
            "library": "F.layer_norm backward alone",
        }
        # x and dy read, dx written; w read, dw and db written
        nbytes = 3 * x.numel() * x.element_size() + 3 * w.numel() * w.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 16 * x.numel())
        emit(rec)
        headline.setdefault("layernorm_bwd", rec)
        del x, dy, leaves, y
        torch.cuda.empty_cache()
    return headline


# the SSD scan: (B, S, H, P, N), f32.  The headline is one layer of the SSM
# train phase; then a reference sweep (tests/test_kernels.py) and one
# layer of the hybrid train phase (zamba2-1.2b: 64 heads, P 64, N 64).
SSD_CASES = [
    (SSM_TRAIN["batch"], SSM_TRAIN["seq"], 24, 64, 128),
    (1, 256, 2, 64, 32),
    (HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"], 64, 64, 64),
]
# f32 against the plain chunked form, whose chunk is not the kernels'
# tile: sums in another order, 1e-4 of the largest magnitude (rtol, atol
# as a share of it), as the attention kernels
SSD_TOL = (1e-4, 1e-4)
SSD_CHUNK = 128  # the reference's chunk (configs/base.py ssd_chunk)


def _ssd_tiles(S: int) -> list:
    """The tile lengths the least-work counts range over: powers of two
    dividing S up to the reference's chunk (T = 1 is the plain recurrence)."""
    return [T for T in (1 << k for k in range(8)) if T <= min(SSD_CHUNK, S) and S % T == 0]


def _ssd_parts(H: int, P: int, N: int, T: int) -> tuple:
    """Per head and token at tile length T: (forward products, forward
    rest, backward products, backward rest).  The forward's products are
    (C B^T .* L) X, C h and the state update (2TP + 4NP) and C B^T once per
    batch row and tile, shared by the heads (2TN/H); its rest h's decay once
    a tile (NP/T).  The backward's products are two T x T products with P
    (dX's intra part, dY X^T) and two with N (dB's and dC's intra parts)
    (4TP + 4TN), four T x N x P products (dX's, dB's and dC's inter parts,
    dH: 8NP) and C B^T (2TN/H); its rest dH's decay and <dH, h_in> once a
    tile (3NP/T)."""
    shared = 2 * T * N / H
    return (
        2 * T * P + 4 * N * P + shared,
        N * P / T,
        4 * T * P + 4 * T * N + 8 * N * P + shared,
        3 * N * P / T,
    )


def ssd_ops(B: int, S: int, H: int, P: int, N: int) -> tuple:
    """(forward, backward) operations the SSD scan needs at least: the dual
    form at the tile length T that needs fewest (``_ssd_parts``).  The
    backward reads the saved tile states: no forward is recomputed."""
    parts = [_ssd_parts(H, P, N, T) for T in _ssd_tiles(S)]
    fwd = min(p[0] + p[1] for p in parts)
    bwd = min(p[2] + p[3] for p in parts)
    return B * S * H * fwd, B * S * H * bwd


def ssd_tc_bound(B: int, S: int, H: int, P: int, N: int, fwd_bytes: int, bwd_bytes: int) -> tuple:
    """The least times of the same f32-accurate work with the products on
    the tensor cores as 3xTF32 (three TF32 products each, at 495 TFLOP/s)
    and the rest at 67 TFLOP/s, each against its bytes at 3.35 TB/s, the
    longer; the tile length the one that gives the least time.
    ((forward ms, by), (backward ms, by))."""
    parts = [_ssd_parts(H, P, N, T) for T in _ssd_tiles(S)]
    fwd = min(3 * p[0] / TF32_OPS_PER_S + p[1] / F32_OPS_PER_S for p in parts)
    bwd = min(3 * p[2] / TF32_OPS_PER_S + p[3] / F32_OPS_PER_S for p in parts)
    out = []
    for t_ops, nbytes in ((fwd * B * S * H, fwd_bytes), (bwd * B * S * H, bwd_bytes)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        out.append((t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations"))
    return tuple(out)


def phase_ssd_kernels(gen: torch.Generator) -> dict:
    """ssd_scan (forward) and ssd_scan_bwd against the plain chunked form
    and autograd through it; the first case of each is its headline.  Each
    wrapper call launches one kernel (after a zero fill of its sync words).
    No single PyTorch call computes the scan: library_ms is null.  The
    plain backward's time includes its forward.  Two bounds: ``bound_ms``
    with every operation at the f32 CUDA-core rate (as in PR 14-17), and
    ``bound_3xtf32_ms`` with the products on the tensor cores as three TF32
    products each (``ssd_tc_bound``)."""
    headline = {}
    for B, S, H, P, N in SSD_CASES:
        x = 0.5 * torch.randn(B, S, H, P, generator=gen, device="cuda")
        # the model's a = -exp(A_log) softplus(dt): A_log 0, dt ~ softplus(N(0, 1) - 1)
        a = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda") - 1)
        b = 0.3 * torch.randn(B, S, N, generator=gen, device="cuda")
        c = 0.3 * torch.randn(B, S, N, generator=gen, device="cuda")
        dy = torch.randn(B, S, H, P, generator=gen, device="cuda")
        y, states = ssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
        grads = ssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)
        want_y = ref.ssd_scan_chunked(x, a, b, c, chunk=SSD_CHUNK)
        want_g = ref.ssd_scan_bwd(x, a, b, c, dy, chunk=SSD_CHUNK)
        torch.cuda.synchronize()
        what = f"B={B} S={S} H={H} P={P} N={N}"
        err_y, ok = scaled_err(y, want_y, *SSD_TOL)
        check(ok, f"ssd_scan {what}: err {err_y}")
        errs = {}
        for name, got, want in zip(("dx", "da", "db", "dc"), grads, want_g):
            errs[name], ok = scaled_err(got, want, *SSD_TOL)
            check(ok, f"ssd_scan_bwd {name} {what}: err {errs[name]}")
        del want_y, want_g, grads
        fwd_ops, bwd_ops = ssd_ops(B, S, H, P, N)
        xb, ab, bb = x.numel() * 4, a.numel() * 4, b.numel() * 4  # f32
        base = {
            "phase": "kernel",
            "shape": [B, S, H, P, N],
            "dtype": "float32",
            "rtol": SSD_TOL[0],
            "atol_of_max": SSD_TOL[1],
            "tile": ssd.tile_rows(N, P),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan",
        }
        rec = {
            **base,
            "name": "ssd_scan",
            "max_abs_err": err_y,
            "ms": median_ms(lambda: ssd.ssd_scan_cuda(x, a, b, c, keep_states=True), batches=5),
            "plain_ms": median_ms(
                lambda: ref.ssd_scan_chunked(x, a, b, c, chunk=SSD_CHUNK), batches=3, calls=2
            ),
        }
        # x, a, b, c read; y written.  The backward: x, a, b, c, dy read;
        # dx, da, db, dc written.  The saved tile states are left out: a
        # backward could recompute them instead
        fwd_bytes, bwd_bytes = 2 * xb + ab + 2 * bb, 3 * xb + 2 * ab + 4 * bb
        tc_fwd, tc_bwd = ssd_tc_bound(B, S, H, P, N, fwd_bytes, bwd_bytes)
        rec["bound_ms"], rec["bound_by"] = bound(fwd_bytes, fwd_ops)
        rec["bound_3xtf32_ms"], rec["bound_3xtf32_by"] = tc_fwd
        emit(rec)
        headline.setdefault("ssd_scan", rec)
        rec = {
            **base,
            "name": "ssd_scan_bwd",
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_grad": errs,
            "ms": median_ms(lambda: ssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy), batches=5),
            "plain_ms": median_ms(
                lambda: ref.ssd_scan_bwd(x, a, b, c, dy, chunk=SSD_CHUNK), batches=3, calls=1
            ),
        }
        rec["bound_ms"], rec["bound_by"] = bound(bwd_bytes, bwd_ops)
        rec["bound_3xtf32_ms"], rec["bound_3xtf32_by"] = tc_bwd
        emit(rec)
        headline.setdefault("ssd_scan_bwd", rec)
        del x, a, b, c, dy, y, states
        torch.cuda.empty_cache()
    return headline


def _train_cfg(arch: str = ARCH, run: dict = TRAIN):
    """A model at full width, depth cut to the run's layers; bf16 and full
    remat, the config's own."""
    return dataclasses.replace(registry.get(arch), n_layers=run["n_layers"])


def train_model_flops(cfg, run: dict = TRAIN) -> float:
    """6 per token for each weight a token meets, plus each attention's
    forward (two products) and backward (five) over the causal pairs, and
    each SSD scan's forward and backward (ssd_ops).  A token meets the
    body's weights at every position, the frontend rows too, and the
    (tied) unembedding at the text positions; a MoE layer's router, its
    shared experts and top_k routed experts; the hybrid's shared block at
    each of its applications; an encoder-decoder model's encoder at every
    frame (as many as the tokens) and its decoder at every token."""
    B, S = run["batch"], run["seq"]
    S_text = S - cfg.n_frontend_tokens
    unembed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body = cfg.param_count() - unembed
    if cfg.family == "moe":
        body -= cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert_params(cfg)
    attn_apps = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        attn_apps = applications(cfg)
        mamba = cfg.param_count() - unembed - cfg.d_model  # one final norm
        if attn_apps:
            h, kv, dh, d = cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_model
            shared = d * (h + 2 * kv) * dh + h * dh * d + 2 * d * cfg.d_ff + 2 * d
            mamba -= shared
            body = mamba + attn_apps * shared + cfg.d_model
    flops = 6 * (body * B * S + unembed * B * S_text)
    if cfg.family in ("ssm", "hybrid"):
        fwd, bwd = ssd_ops(B, S, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        flops += cfg.n_layers * (fwd + bwd)
    if cfg.family == "encdec":
        # the encoder's attention over all S^2 pairs, the decoder's over the
        # causal ones, the cross-attention over all S x S_enc (frames = S)
        pairs = cfg.enc_layers * S * S + cfg.n_layers * (visible_pairs(S, True, 0) + S * S)
        return flops + 14 * cfg.d_head * pairs * B * cfg.n_heads
    pairs = visible_pairs(S, True, cfg.window)
    return flops + 14 * cfg.d_head * pairs * B * cfg.n_heads * attn_apps


@contextlib.contextmanager
def moe_drops():
    """Per MoE block call inside the block, on the device: (dropped, all)
    (token, choice) pairs, read from the routing's kept masks."""
    seen, plain = [], L._gshard_slots

    def record(idx, **kw):
        slots, keeps = plain(idx, **kw)
        kept = torch.stack(keeps).sum()
        seen.append(torch.stack([idx.numel() - kept, kept.new_tensor(idx.numel())]))
        return slots, keeps

    L._gshard_slots = record
    try:
        yield seen
    finally:
        L._gshard_slots = plain


def phase_reference_init(cfg, run: dict) -> None:
    """One forward and backward of a train phase's model at the
    reference's own init (the seed's weights, no ``at_model_fan_in``) on
    a batch of the run's shape: the loss, the gradient's global norm in
    f32 (as AdamW's clipping computes it) and its largest entry.  For
    seamless-m4t-large-v2 at 24 + 24 layers the norm overflows: every
    step's update is then clipped to nothing but weight decay, in the
    JAX package too (ROADMAP C.3)."""
    gen = torch.Generator(device=DEVICE).manual_seed(run["seed"])
    params = init_params(steps.model_specs(cfg), gen, DEVICE)
    batch = frontend_batch(cfg, run["batch"], run["seq"], gen, DEVICE)
    loss, grads = steps.loss_and_grads(cfg, params, batch)
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    emit(
        {
            "phase": phase_name(cfg, "reference_init"),
            "arch": cfg.name,
            "n_layers": cfg.n_layers,
            "enc_layers": cfg.enc_layers,
            **{k: run[k] for k in ("batch", "seq", "seed")},
            "loss": float(loss),
            "grad_norm_f32": float(norm),
            "largest_grad": max(float(g.float().abs().max()) for g in leaves),
            "grads_finite": all(bool(torch.isfinite(g).all()) for g in leaves),
        }
    )
    del params, grads, batch
    torch.cuda.empty_cache()


def encdec_train_launches(cfg) -> dict:
    """An encoder-decoder train step's launches: each layer's forward once,
    and again in the backward under full remat (an encoder layer's two
    norms and attention, a decoder layer's three norms, self- and
    cross-attention), the two final norms once, and each of their
    backwards once."""
    runs = 2 if cfg.remat == "full" else 1
    norms_in_layers = 2 * cfg.enc_layers + 3 * cfg.n_layers
    attentions = cfg.enc_layers + 2 * cfg.n_layers
    return {
        "layernorm": runs * norms_in_layers + 2,
        "layernorm_bwd": norms_in_layers + 2,
        "flash_attention": runs * attentions,
        "flash_attention_bwd": attentions,
    }


def phase_train(cfg=None, run: dict = TRAIN) -> dict:
    """A main path's training part: train() through the port's entry
    point, bf16, from the run's seed; qwen2.5-14b at full width and 4
    layers unless ``cfg`` says otherwise.  An encoder-decoder model starts
    from the seed's weights with its attention at ``at_model_fan_in``
    (passed as ``params``), and its launches a step are held to
    ``encdec_train_launches``."""
    cfg = cfg or _train_cfg()
    name = phase_name(cfg, "train")
    torch.cuda.empty_cache()
    params = None  # None: train() draws the weights from the seed
    if cfg.family == "encdec":
        gen = torch.Generator(device=DEVICE).manual_seed(run["seed"])
        params = init_params(steps.model_specs(cfg), gen, DEVICE)
        at_model_fan_in(params)
    torch.cuda.reset_peak_memory_stats()
    counts0 = ops.launch_counts()
    with moe_drops() as drops:
        out = train.train(
            cfg,
            steps=run["steps"],
            batch=run["batch"],
            seq=run["seq"],
            seed=run["seed"],
            log_every=1,
            params=params,
            device=None if DEVICE == "cuda" else DEVICE,  # None: the entry point's default
        )
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    per_step = {n: (c - counts0[n]) / run["steps"] for n, c in counts.items() if c > counts0[n]}
    if cfg.family == "encdec":
        want = encdec_train_launches(cfg)
        check(per_step == want, f"{name}: launches a step {per_step}, want {want}")
    losses, gnorms = out["losses"], out["grad_norms"]
    check(all(math.isfinite(x) for x in losses + gnorms), f"losses {losses}, norms {gnorms}")
    init = params
    if init is None:
        gen = torch.Generator(device=DEVICE).manual_seed(run["seed"])
        init = init_params(steps.model_specs(cfg), gen, DEVICE)
    same = sum(torch.equal(a, b) for a, b in zip(tree_leaves(init), tree_leaves(out["params"])))
    check(same == 0, f"{same} parameter tensors did not change")
    del init, params, out["params"], out["opt"]
    torch.cuda.empty_cache()
    step_s = statistics.median(out["step_s"][1:])
    tokens = run["batch"] * run["seq"]
    flops = train_model_flops(cfg, run)
    rec = {
        "phase": name,
        "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "enc_layers": cfg.enc_layers,
        "dtype": "bfloat16",
        "remat": cfg.remat,
        "cuts": run["cuts"],
        **{k: run[k] for k in ("batch", "seq", "steps", "seed")},
        "params": cfg.param_count(),
        "losses": losses,
        "grad_norms": gnorms,
        "step_s": out["step_s"],
        "step_ms_median_2_3": step_s * 1e3,
        "tok_per_s": tokens / step_s,
        "model_tflop_per_step": flops / 1e12,
        "bound_ms_per_step": flops / BF16_OPS_PER_S * 1e3,
        "model_flop_share_of_989": flops / step_s / BF16_OPS_PER_S,
        "init_s": out["init_s"],
        "peak_alloc_gb": peak / 1e9,
        "launches_per_step": per_step,
    }
    if drops:  # a MoE model: the dropped share of each step's (token, choice) pairs
        per_step = torch.stack(drops).cpu().view(run["steps"], -1, 2).sum(1)
        rec["dropped_share_by_step"] = (per_step[:, 0] / per_step[:, 1]).tolist()
        rec["capacity_factor"] = cfg.capacity_factor
    emit(rec)
    return rec


def frontend_batch(cfg, B: int, S: int, gen, device) -> dict:
    """Random tokens and labels, and for a model with frontend rows their
    embeddings (f32, as the data pipeline makes them), for S positions; an
    encoder-decoder model's S frames beside its S tokens."""
    S_text = S - cfg.n_frontend_tokens
    toks = torch.randint(0, cfg.vocab, (B, S_text + 1), generator=gen, device=device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_frontend_tokens or cfg.family == "encdec":
        rows = S if cfg.family == "encdec" else cfg.n_frontend_tokens
        batch["frontend"] = torch.randn((B, rows, cfg.d_model), generator=gen, device=device)
    return batch


def _kernel_kind(name: str) -> str:
    # flash_attention.cu: flash_*_kernel (f32), flash_tc::* (bf16), delta_kernel
    if "flash_" in name or "delta_kernel" in name:
        return "attention kernels"
    if "ssd_" in name:
        return "ssd kernels"
    if any(s in name for s in ("norm_kernel", "norm_bwd_kernel", "partial_reduce_kernel")):
        return "norm kernels"
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "GEMMs"
    return "other (elementwise, reductions, copies, cross_entropy)"


def _device_ops(prof) -> list:
    """The device operations of a profile, summed by name: kernels, copies
    and fills, without the device copies of host spans (a
    ``record_function``, the program's ``repro_torch.*`` spans among
    them, leaves one on the device timeline that covers its gaps)."""
    from torch.autograd import DeviceType

    return [
        e
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith(obs.PREFIX)
    ]


def _device_summary(prof, wall: float, top: int = 12) -> dict:
    kernels = _device_ops(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    kinds: dict = {}
    for e in kernels:
        ms, n = kinds.get(_kernel_kind(e.key), (0.0, 0))
        kinds[_kernel_kind(e.key)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return {
        "traced_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "device_ops": sum(e.count for e in kernels),
        "ms_and_launches_by_kind": kinds,
        "top_device_ms": {
            e.key[:70]: [e.self_device_time_total / 1e3, e.count]
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
        },
    }


def phase_train_profile(cfg=None, run: dict = TRAIN) -> None:
    """Where a train step's time goes: torch.profiler over one step of the
    train phase's model, width, depth and batch, after a warm step; the
    forward and backward (``steps.loss_and_grads``) and the AdamW update
    are traced apart, so AdamW's elementwise work has its own line.
    Device busy time is the sum of the kernels' own times; the rest of
    the traced wall time the card idles."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg or _train_cfg()
    name = phase_name(cfg, "train_profile")
    opt_cfg = adamw.AdamWConfig(total_steps=run["steps"])
    step_fn, specs = steps.make_train_step(cfg, opt_cfg)
    gen = torch.Generator(device="cuda").manual_seed(run["seed"] + 1)
    params = init_params(specs, gen, "cuda")
    if cfg.family == "encdec":
        at_model_fan_in(params)
    opt = adamw.init_state(params, opt_cfg)
    batch = frontend_batch(cfg, run["batch"], run["seq"], gen, "cuda")
    params, opt, _ = step_fn(params, opt, batch)  # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_fb:
        t0 = time.perf_counter()
        _, grads = steps.loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
        wall_fb = time.perf_counter() - t0
    with profile(activities=acts) as prof_opt:
        t0 = time.perf_counter()
        adamw.update(grads, opt, params, opt_cfg)
        torch.cuda.synchronize()
        wall_opt = time.perf_counter() - t0
    fb = _device_summary(prof_fb, wall_fb)
    upd = _device_summary(prof_opt, wall_opt, top=4)
    wall = wall_fb + wall_opt
    busy = fb["device_busy_ms"] + upd["device_busy_ms"]
    emit(
        {
            "phase": name,
            "arch": cfg.name,
            "traced_step_ms": wall * 1e3,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / 1e3 / wall,
            "forward_backward": fb,
            "adamw": upd,
        }
    )
    del params, opt, grads, batch
    torch.cuda.empty_cache()


def _leaf_errors(got_tree, want_tree, prefix: str = "") -> dict:
    """Each leaf's largest gap, over the largest magnitude of want's leaf,
    by its dotted path."""
    if not isinstance(want_tree, dict):
        gap = (got_tree.cpu() - want_tree).abs().max() / want_tree.abs().max()
        return {prefix: float(gap)}
    out = {}
    for k in sorted(want_tree):
        out.update(_leaf_errors(got_tree[k], want_tree[k], f"{prefix}.{k}" if prefix else k))
    return out


def phase_train_cross_check(arch: str = ARCH, kernels=None) -> None:
    """One train step on the card (the CUDA kernels) against the same step
    on the CPU (their plain versions), same weights and batch: the model
    at full width, 1 layer, f32, batch 1 of 256 tokens, TF32 off.  The
    step is the train step's two parts, ``steps.loss_and_grads`` then
    ``adamw.update``, so the gradients can be held too: each gradient and
    each updated parameter within CROSS_GRAD_RTOL of its largest
    magnitude, or a gradient beyond that within CROSS_ROUNDING_K times
    the CPU's own distance from the same step in f64.  A VLM model takes
    VLM_CROSS_FRONTEND frontend rows of its 256 positions; an
    encoder-decoder model 1 + 1 layers and 256 frames.  A MoE model's
    router top-k is compared first, call by call: a choice may flip only
    on a near tie (``routing_flips``), and the flips are counted.  The
    step must launch ``kernels``, by default those of the model's train
    phase in PATH_KERNELS."""
    check(
        not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
        "TF32 is on",
    )
    changes, cuts = dict(n_layers=CROSS_TRAIN["n_layers"], param_dtype=torch.float32), "none"
    base = registry.get(arch)
    if base.family == "encdec":
        changes["enc_layers"] = CROSS_TRAIN["n_layers"]
    if base.n_frontend_tokens:
        changes["n_frontend_tokens"] = VLM_CROSS_FRONTEND
        cuts = (
            f"frontend rows {base.n_frontend_tokens:,} -> {VLM_CROSS_FRONTEND}, "
            f"with {CROSS_TRAIN['seq'] - VLM_CROSS_FRONTEND} text tokens"
        )
    cfg = dataclasses.replace(base, **changes)
    name = phase_name(cfg, "train_cross_check")
    cpu, card = _cross_weights(cfg, 3)
    B, S = CROSS_TRAIN["batch"], CROSS_TRAIN["seq"]
    rng = np.random.default_rng(4)
    S_text = S - cfg.n_frontend_tokens
    toks = rng.integers(0, cfg.vocab, size=(B, S_text + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.n_frontend_tokens or cfg.family == "encdec":
        rows = S if cfg.family == "encdec" else cfg.n_frontend_tokens
        fe = rng.normal(size=(B, rows, cfg.d_model)).astype(np.float32)
        batch["frontend"] = torch.from_numpy(fe)
    opt_cfg = adamw.AdamWConfig(total_steps=1)
    counts0 = ops.launch_counts()
    t0 = time.perf_counter()
    with router_logits() as seen_card:
        loss_d, grads_d = steps.loss_and_grads(
            cfg, card, {k: t.to(DEVICE) for k, t in batch.items()}
        )
    counts = ops.launch_counts()
    card, _, met_d = adamw.update(grads_d, adamw.init_state(card, opt_cfg), card, opt_cfg)
    sync()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with router_logits() as seen_cpu:
        loss_c, grads_c = steps.loss_and_grads(cfg, cpu, batch)
    cpu_s = time.perf_counter() - t0
    near_ties = 0
    for got_l, want_l in zip(seen_card, seen_cpu, strict=True):
        flips = routing_flips(got_l, want_l, cfg.top_k)
        check(not (flips == 2).any(), f"{name}: routing differs beyond a near tie")
        near_ties += int((flips == 1).sum())
    grad_err = _leaf_errors(grads_d, grads_c)
    rounding = {}  # leaf -> (the card's, the CPU's distance from f64)
    over = [leaf for leaf, err in grad_err.items() if err > CROSS_GRAD_RTOL]
    if over:
        cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64)
        _, grads_64 = steps.loss_and_grads(cfg64, tree_map(lambda t: t.double(), cpu), batch)
        card64, cpu64 = _leaf_errors(grads_d, grads_64), _leaf_errors(grads_c, grads_64)
        rounding = {leaf: (card64[leaf], cpu64[leaf]) for leaf in over}
        del grads_64
    t0 = time.perf_counter()
    cpu, _, met_c = adamw.update(grads_c, adamw.init_state(cpu, opt_cfg), cpu, opt_cfg)
    cpu_s += time.perf_counter() - t0
    launched = {n: counts[n] - counts0[n] for n in counts}
    for kernel in kernels or PATH_KERNELS[phase_name(cfg, "train")]:
        check(launched[kernel] > 0, f"{name}: {kernel} not launched ({launched})")
    loss_rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    check(loss_rel <= CROSS_LOSS_RTOL, f"{name}: loss rel err {loss_rel}")
    gn_d, gn_c = float(met_d["grad_norm"]), float(met_c["grad_norm"])
    gn_rel = abs(gn_d - gn_c) / gn_c
    check(gn_rel <= CROSS_LOSS_RTOL, f"{name}: grad norm rel err {gn_rel}")
    for leaf, (card_gap, cpu_gap) in rounding.items():
        check(
            card_gap <= CROSS_ROUNDING_K * cpu_gap,
            f"{name}: {leaf} gradient rel err {grad_err[leaf]}; from f64 card {card_gap}, "
            f"cpu {cpu_gap}",
        )
    param_err = _leaf_errors(card, cpu)
    worst_grad, worst_param = max(grad_err.values()), max(param_err.values())
    check(worst_param <= CROSS_GRAD_RTOL, f"{name}: parameter rel errs {param_err}")
    emit(
        {
            "phase": name,
            "arch": arch,
            **CROSS_TRAIN,
            "cuts": cuts,
            "dtype": "float32",
            "tf32": False,
            "loss_rtol": CROSS_LOSS_RTOL,
            "grad_rtol_of_max": CROSS_GRAD_RTOL,
            "loss_card": float(loss_d),
            "loss_cpu": float(loss_c),
            "loss_rel_err": loss_rel,
            "grad_norm_rel_err": gn_rel,
            "grad_max_rel_err": worst_grad,
            "grad_worst_leaf": max(grad_err, key=grad_err.get),
            "grad_held_to_rounding": {
                leaf: {"card_from_f64": c, "cpu_from_f64": p, "k": CROSS_ROUNDING_K}
                for leaf, (c, p) in rounding.items()
            },
            "param_max_rel_err": worst_param,
            "routing_near_tie_flips": near_ties,
            "launches": launched,
            "card_s": card_s,
            "cpu_s": cpu_s,
        }
    )


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (-0.0 and 0.0 differ, a NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = _INT_OF_SIZE[a.element_size()]
    return torch.equal(a.view(as_int), b.view(as_int))


def phase_ckpt_drill(arch: str = SSM_ARCH, run: dict = CKPT_DRILL) -> None:
    """Checkpoint and restart on the card: ``train`` with a checkpoint
    every ``ckpt_every`` steps and a failure injected before step
    ``fail_at`` (``retry_loop`` restores the latest checkpoint and runs
    on), then the same run uninterrupted, without checkpoints, from the
    same seed.  The final parameters and moments, and every step's loss,
    must be equal bit for bit: the kernels are deterministic, the data
    source is indexed by the step, and a restore is exact.  The
    checkpoints go to a temporary directory, removed at the end."""
    cfg = registry.get(arch)
    name = "ckpt_drill"
    kw = dict(
        steps=run["steps"],
        batch=run["batch"],
        seq=run["seq"],
        seed=run["seed"],
        log_every=run["steps"],
        device=None if DEVICE == "cuda" else DEVICE,  # None: the entry point's default
    )
    tmp = tempfile.mkdtemp(prefix="ckpt_drill_")
    try:
        inj = FailureInjector({run["fail_at"]: RuntimeError("ckpt_drill: injected failure")})
        t0 = time.perf_counter()
        resumed = train.train(
            cfg, ckpt_dir=tmp, ckpt_every=run["ckpt_every"], injector=inj, **kw
        )
        resumed_s = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in pathlib.Path(tmp).rglob("*") if f.is_file())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    plain = train.train(cfg, **kw)
    plain_s = time.perf_counter() - t0
    log = resumed["ckpt_log"]
    restores = [r for r in log if r["op"] == "restore"]
    check(len(restores) == 1, f"{name}: restores {restores}")
    check(resumed["losses"] == plain["losses"], f"{name}: losses {resumed['losses']}, {plain['losses']}")
    differ = {}
    for part in ("params", "opt"):
        pairs = zip(tree_leaves(resumed[part]), tree_leaves(plain[part]), strict=True)
        differ[part] = sum(not same_bits(a, b) for a, b in pairs)
    check(differ == {"params": 0, "opt": 0}, f"{name}: leaves that differ {differ}")
    saves = [r for r in log if r["op"] == "save"]
    emit(
        {
            "phase": name,
            "arch": cfg.name,
            **run,
            "losses": resumed["losses"],
            "losses_equal": True,
            "leaves_equal_bitwise": len(tree_leaves(plain["params"])) + len(tree_leaves(plain["opt"])),
            "restored_step": restores[0]["step"],
            "saves": [
                {k: r[k] for k in ("step", "bytes", "snapshot_s", "write_s")} for r in saves
            ],
            "restore": {k: restores[0][k] for k in ("step", "bytes", "s")},
            "bytes_written": sum(r["bytes"] for r in saves),
            "bytes_on_disk_at_end": on_disk,
            "resumed_run_s": resumed_s,
            "plain_run_s": plain_s,
        }
    )
    del resumed, plain
    torch.cuda.empty_cache()


SVC_N = 2048  # the services chain: tests/test_graphs.py's size, grid 8 x 256
SVC_REPLAYS = 200  # token-pipeline replays with rebound tokens
SVC_DEADLINE_S = 0.05


def _services_chain(stream_a, stream_b, x, y):
    """saxpy on ``stream_a``, then, after an event edge, scale and
    tile_sum on ``stream_b``: the handles."""
    n = SVC_N
    zeros = np.zeros(n, np.float32)
    h1 = stream_a.launch(svc_saxpy, grid=8, block=256, args=(zeros, x, y, n))
    stream_b.wait_event(stream_a.record_event())
    h2 = stream_b.launch(svc_scale, grid=8, block=256, args=(zeros, h1.outputs["out"], n))
    h3 = stream_b.launch(
        svc_tile_sum, grid=8, block=256, args=(np.zeros(8, np.float32), h2.outputs["out"], n)
    )
    return h1, h2, h3


def _fault_drills() -> dict:
    """One injected fault of each site on a private dispatcher (the
    default one stays clean for the serve phases), each surfaced with its
    type, and one ladder walk batched -> serial, bitwise the serial
    launch."""
    from repro_torch.core.streams import Dispatcher

    x = np.arange(SVC_N, dtype=np.float32) / SVC_N
    args = (np.zeros(SVC_N, np.float32), x, x, SVC_N)
    out = {}
    for site, err in (
        ("dispatch", cox.CoxLaunchError),
        ("stage", cox.CoxCompileError),
        ("timeout", cox.CoxTimeoutError),
        ("sticky-device", cox.CoxDeviceError),
    ):
        d = Dispatcher(devices=[DEVICE], launch_deadline_s=SVC_DEADLINE_S)
        s = cox.Stream(f"drill-{site}", d)
        # explicit knobs: no ladder rung may absorb the fault
        with cox.faults.inject("svc_saxpy", site=site) as spec:
            h = s.launch(svc_saxpy, grid=8, block=256, args=args, **SCAN)
        try:
            h.result()
            got = None
        except cox.CoxError as e:
            got = e
        check(spec.fired == 1 and isinstance(got, err), f"fault {site}: fired {spec.fired}, {got!r}")
        rec = {"error": type(got).__name__, "failures": d.failures}
        if site == "timeout":
            check(d.timeouts == 1, f"fault timeout: {d.timeouts} timeouts")
        if site == "sticky-device":
            try:
                s.launch(svc_scale, grid=8, block=256, args=args[:2] + (SVC_N,), **SCAN)
                blocked = False
            except cox.CoxDeviceError:
                blocked = True
            check(blocked, "a sticky error did not block the next launch")
            d.device_reset()
            ok = s.launch(svc_saxpy, grid=8, block=256, args=args, **SCAN).result()["out"]
            check(bool(torch.isfinite(ok).all()), "no launch after device_reset")
            rec["blocked_until_reset"] = True
        out[site] = rec
    d = Dispatcher(devices=[DEVICE])
    s = cox.Stream("drill-ladder", d)
    a = np.random.default_rng(3).integers(-8, 9, 256).astype(np.float32)
    largs = (np.zeros(256, np.float32), a)
    want = s.launch(svc_warpstage, grid=2, block=128, args=largs, warp_exec="serial").result()["out"]
    with cox.faults.inject("svc_warpstage", site="dispatch", times=1):
        h = s.launch(svc_warpstage, grid=2, block=128, args=largs)
        got = h.result()["out"]
    walk = [e["to"] for e in d.degradation_log]
    check(h.request.rl.warp_exec == "serial" and walk == ["warp_exec=serial"], f"ladder {walk}")
    check(torch.equal(got, want), "ladder batched -> serial is not bitwise the serial launch")
    out["ladder"] = {"walk": walk, "degradations": d.degradations, "bitwise": True}
    return out


def phase_services(rng: np.random.Generator) -> dict:
    """The COX runtime services on the card, no model: the chain of
    tests/test_graphs.py on two streams with an event edge and vectorAdd
    on a third, bitwise the serial launches; a default-stream launch after
    them sees their writes (the legacy barrier); Event.elapsed beside the
    host clock; the overlap of two streams' launches; one injected fault
    of each site and one ladder walk; the token pipeline captured once and
    replayed SVC_REPLAYS times, bitwise the eager pipeline, as a
    torch.cuda.CUDAGraph, with the host time of a step and the device
    time of a replay."""
    d = cox.get_dispatcher()
    x = rng.standard_normal(SVC_N).astype(np.float32)
    y = rng.standard_normal(SVC_N).astype(np.float32)
    va = rng.standard_normal(VEC_N).astype(np.float32)
    vb = rng.standard_normal(VEC_N).astype(np.float32)
    vargs = (np.zeros(VEC_N, np.float32), va, vb, VEC_N)
    vgrid = -(-VEC_N // 256)
    dev = {"device": None if DEVICE == "cuda" else DEVICE}

    def serial_chain():
        w1 = svc_saxpy.launch(grid=8, block=256, args=(np.zeros(SVC_N, np.float32), x, y, SVC_N), **dev)
        w2 = svc_scale.launch(grid=8, block=256, args=(np.zeros(SVC_N, np.float32), w1["out"], SVC_N), **dev)
        w3 = svc_tile_sum.launch(grid=8, block=256, args=(np.zeros(8, np.float32), w2["out"], SVC_N), **dev)
        wd = svc_scale.launch(grid=1, block=256, args=(np.zeros(8, np.float32), w3["out"], 8), **dev)
        return w1, w2, w3, wd

    # serial issue on the default stream, once to stage every launch
    # shape (the stage cache the streams share), then timed
    serial_chain()
    vectorAdd.launch(grid=vgrid, block=256, args=vargs, **dev)
    sync()
    t0 = time.perf_counter()
    w1, w2, w3, wd = serial_chain()
    sync()
    chain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wv = vectorAdd.launch(grid=vgrid, block=256, args=vargs, **dev)
    sync()
    vec_s = time.perf_counter() - t0

    # the same launches on three streams, an event edge between two
    s_a = cox.Stream("svc-a", device=DEVICE)
    s_b = cox.Stream("svc-b", device=DEVICE)
    s_c = cox.Stream("svc-c", device=DEVICE)
    sync()
    syncs0 = execute.host_syncs
    t0 = time.perf_counter()
    start = cox.Event().record(s_a)
    h1, h2, h3 = _services_chain(s_a, s_b, x, y)
    hv = s_c.launch(vectorAdd, grid=vgrid, block=256, args=vargs)
    stop = s_b.record_event()
    # a default-stream launch reads tile_sum's output through a view (no
    # data edge): only the legacy barrier orders it after stream b
    hd = d.default.launch(
        svc_scale, grid=1, block=256, args=(np.zeros(8, np.float32), h3.outputs["out"].view(-1), 8), **dev
    )
    sync()
    both_s = time.perf_counter() - t0
    host_syncs = execute.host_syncs - syncs0
    got = {"saxpy": h1.result()["out"], "scale": h2.result()["out"], "tile_sum": h3.result()["out"]}
    got["vectorAdd"] = hv.result()["out"]
    got["default_after"] = hd.result()["out"]
    want = {
        "saxpy": w1["out"],
        "scale": w2["out"],
        "tile_sum": w3["out"],
        "vectorAdd": wv["out"],
        "default_after": wd["out"],
    }
    for k in want:
        check(torch.equal(got[k], want[k]), f"services: {k} on streams != serial")
    elapsed_ms = start.elapsed(stop)
    overlap = (chain_s + vec_s - both_s) / min(chain_s, vec_s)
    check(d.degradations == 0 and d.health()["sticky"] is None, f"services: {d.health()}")

    drills = _fault_drills()

    # the token pipeline: eager against one capture replayed
    g_pipe = serve.TokenPipeline(SERVE["batch"], graph=True, device=DEVICE)
    e_pipe = serve.TokenPipeline(SERVE["batch"], graph=False, device=DEVICE)
    vocab = registry.get(ARCH).vocab
    steps = [
        (rng.integers(0, vocab, size=SERVE["batch"]).astype(np.int32), rng.random(SERVE["batch"]) < 0.9)
        for _ in range(SVC_REPLAYS)
    ]
    g_pipe.step(*steps[0])  # capture + first replay
    e_pipe.step(*steps[0])
    sync()
    t0 = time.perf_counter()
    for toks, active in steps[1:]:
        e_pipe.step(toks, active)
    eager_host_us = (time.perf_counter() - t0) / (SVC_REPLAYS - 1) * 1e6
    sync()
    t0 = time.perf_counter()
    for toks, active in steps[1:]:
        g_pipe.step(toks, active)
    replay_host_us = (time.perf_counter() - t0) / (SVC_REPLAYS - 1) * 1e6
    sync()
    g_stats, e_stats = g_pipe.collect(), e_pipe.collect()
    for k in e_stats:
        check(np.array_equal(g_stats[k], e_stats[k]), f"token pipeline: replay {k} != eager")
    check(int(g_stats["hist"].sum()) == int(sum(a.sum() for _, a in steps)), "token pipeline: tokens lost")
    exe = g_pipe.graph_exec
    is_graph = exe is not None and isinstance(exe.cuda_graph, torch.cuda.CUDAGraph)
    check(is_graph or DEVICE != "cuda", "token pipeline: the replay is not a torch.cuda.CUDAGraph")
    replay_ms = median_ms(exe.cuda_graph.replay) if is_graph else None
    check(d.degradations == 0, f"token pipeline: {d.degradations} degradations")
    rec = {
        "phase": "services",
        "chain": {"n": SVC_N, "grid": 8, "block": 256, "streams": 2, "check": "bitwise == serial"},
        "vectorAdd": {"n": VEC_N, "stream": "svc-c", "check": "bitwise == serial"},
        "legacy_barrier": "default-stream launch after them read tile_sum through a view: bitwise",
        "serial_chain_s": chain_s,
        "serial_vectorAdd_s": vec_s,
        "streams_both_s": both_s,
        "overlap_share": overlap,
        "host_syncs_on_streams": host_syncs,
        "event_elapsed_ms": elapsed_ms,
        "event_elapsed_is": "device" if DEVICE == "cuda" else "host clock",
        "faults": drills,
        "pipeline": {
            "batch": SERVE["batch"],
            "replays": SVC_REPLAYS,
            "cuda_graph": is_graph,
            "eager_host_us_per_step": eager_host_us,
            "replay_host_us_per_step": replay_host_us,
            "replay_device_ms": replay_ms,
            "check": "bitwise == eager",
        },
        "dispatch_health": {k: d.health()[k] for k in ("failures", "retries", "degradations", "sticky")},
    }
    emit(rec)
    return rec


def phase_services_serve(cpu_tokens: int, serve_rec: dict) -> dict:
    """serve_requests on qwen2.5-14b at full width and depth in bf16 with
    the per-slot postprocess kernels on cox streams and the token
    pipeline captured and replayed every decode step (beside its eager
    shadow); the reference's asserts hold inside; the decode step beside
    phase_serve's, so the pipelines' cost to the step is on record."""
    cfg = registry.get(ARCH)
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    out = serve.serve_requests(
        ARCH, postproc=True, graph=True, device=None if DEVICE == "cuda" else DEVICE, **SERVE
    )
    after = ops.launch_counts()
    sync()
    torch.cuda.empty_cache()
    check(out["completed"] == SERVE["n_requests"], f"services_serve: {out['completed']} requests")
    check(out["tokens"] == cpu_tokens, f"services_serve: {out['tokens']} tokens, CPU {cpu_tokens}")
    per_step = {n: (after[n] - before[n]) / out["steps"] for n in ("rmsnorm", "flash_decode")}
    want_norm, want_decode = decode_launches(cfg)
    check(per_step == {"rmsnorm": want_norm, "flash_decode": want_decode}, f"services_serve launches {per_step}")
    check(out["graph"]["cuda_graph"] or DEVICE != "cuda", f"services_serve: graph {out['graph']}")
    dh = out["dispatch_health"]
    check(dh["degradations"] == 0 and dh["sticky"] is None, f"services_serve: {dh}")
    rec = {
        "phase": "services_serve",
        "arch": cfg.name,
        **{k: SERVE[k] for k in ("batch", "ctx", "n_requests", "max_tokens")},
        "n_layers": cfg.n_layers,
        "dtype": "bfloat16",
        "tokens": out["tokens"],
        "steps": out["steps"],
        "step_ms_median": statistics.median(out["step_s"]) * 1e3,
        "serve_step_ms_median": serve_rec["step_ms_median"],
        "tok_per_s": out["tok_per_s"],
        "wall_s": out["wall_s"],
        "launches_per_step": per_step,
        "postproc": {k: out["postproc"][k] for k in ("requests", "hist_tokens", "failed")},
        "graph": out["graph"],
        "dispatch_health": {k: dh[k] for k in ("failures", "retries", "degradations", "sticky", "devices")},
    }
    emit(rec)
    return rec


def phase_services_chaos(cpu_tokens: int) -> dict:
    """serve_requests on mamba2-130m at full width and depth with the
    per-slot postprocess kernels and the fault drill: the first
    postprocess launch fails, slot 0 is isolated, every other slot
    completes (the reference's asserts, inside serve_requests)."""
    cfg = registry.get(SSM_ARCH)
    out = serve.serve_requests(
        SSM_ARCH, postproc=True, chaos=True, device=None if DEVICE == "cuda" else DEVICE, **SERVE
    )
    sync()
    torch.cuda.empty_cache()
    check(out["tokens"] == cpu_tokens, f"services_chaos: {out['tokens']} tokens, CPU {cpu_tokens}")
    h = out["postproc"]["health"]
    check(set(h["failed_slots"]) == {0} and h["completed"] == h["submitted"] - h["failed"], f"services_chaos: {h}")
    rec = {
        "phase": "services_chaos",
        "arch": cfg.name,
        **{k: SERVE[k] for k in ("batch", "ctx", "n_requests", "max_tokens")},
        "tokens": out["tokens"],
        "steps": out["steps"],
        "step_ms_median": statistics.median(out["step_s"]) * 1e3,
        "postproc": {k: h[k] for k in ("submitted", "completed", "failed", "failed_slots")},
        "root_errors": [e for e in h["errors"] if not e.startswith("CoxDependencyError")],
        "dispatch_failures": out["dispatch_health"]["failures"],
    }
    emit(rec)
    # drain the default dispatcher's last-error register
    cox.get_last_error()
    return rec


# the tuner, donation and the counted cost model
DONATE_N = 1 << 22  # f32 elements an array of the donate phase (16 MiB)
AUTOTUNE_SERVE_ARGV = [
    "--arch", SSM_ARCH, "--batch", "4", "--ctx", "512", "--requests", "4", "--postproc", "--autotune",
]


@contextlib.contextmanager
def autotune_cache(path: str):
    """``COX_AUTOTUNE_CACHE`` pointed at ``path`` (and ``COX_AUTOTUNE``
    unset) for the block, the tuner's state cleared on both sides; the
    environment as it was afterwards."""
    from repro_torch.core import autotune

    saved = {k: os.environ.get(k) for k in (autotune.ENV_CACHE, autotune.ENV_ENABLE)}
    os.environ[autotune.ENV_CACHE] = path
    os.environ.pop(autotune.ENV_ENABLE, None)
    autotune.reset()
    try:
        yield autotune
    finally:
        autotune.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_outputs(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


AUTOTUNE_GRIDS = {"voteBallot": 64, "warpReduce": 128}  # phase_cox's grids


def phase_autotune(rng: np.random.Generator) -> dict:
    """The measured autotuner on the card, from a cold cache: voteBallot
    at 64 x 256 and warpReduce at 128 x 256 (every candidate cell's time
    and the winner), the tuned launch bitwise phase_cox's scan launch, a
    warm memory hit and, after ``reset(memory_only=True)``, a disk hit,
    neither measuring; gridReduce tuned keeps its cooperative chunk."""
    tmp = tempfile.mkdtemp(prefix="cox-autotune-")
    rec = {"phase": "autotune", "kernels": {}}
    try:
        with autotune_cache(os.path.join(tmp, "autotune.json")) as at:
            for name, kern in (("voteBallot", voteBallot), ("warpReduce", warpReduce)):
                grid = AUTOTUNE_GRIDS[name]
                args, scan_out = COX_SCAN[name]
                before = dict(at.stats())
                t0 = time.perf_counter()
                req = kern.make_request(grid=grid, block=256, args=args, autotune=True, device=DEVICE)
                cold_s = time.perf_counter() - t0
                cold = at.stats()
                check(cold["misses"] == before["misses"] + 1, f"autotune {name}: {cold}")
                check(cold["measurements"] > before["measurements"], f"autotune {name}: nothing measured")
                (entry,) = [v for k, v in at.entries().items() if k.startswith(name + "|")]
                out, wall, _ = timed_launch(kern, grid=grid, block=256, args=args, autotune=True)
                check(same_outputs(out, scan_out), f"autotune {name}: tuned launch != scan launch")
                warm = at.stats()
                check(warm["hits"] == cold["hits"] + 1, f"autotune {name}: no memory hit {warm}")
                check(warm["measurements"] == cold["measurements"], f"autotune {name}: warm run measured")
                at.reset(memory_only=True)
                kern.make_request(grid=grid, block=256, args=args, autotune=True, device=DEVICE)
                disk = at.stats()
                check(disk["disk_hits"] == warm["disk_hits"] + 1, f"autotune {name}: no disk hit {disk}")
                check(disk["measurements"] == warm["measurements"], f"autotune {name}: disk hit measured")
                rec["kernels"][name] = {
                    "grid": grid,
                    "block": 256,
                    "cold_tune_s": cold_s,
                    "measurement_launches": cold["measurements"] - before["measurements"],
                    "cells_us": entry["times_us"],
                    "winner": {k: entry[k] for k in ("backend", "warp_exec", "chunk", "schedule", "n_resident")},
                    "chunk_source": req.rl.chunk_source,
                    "tuned_wall_s": wall,
                    "op_estimate": entry["op_estimate"],
                    "mem_estimate": entry["mem_estimate"],
                    "check": "tuned == scan bitwise; warm: memory hit, 0 measured; disk hit, 0 measured",
                }
            nb, n = 64, 8000
            data = rng.integers(-8, 9, size=n).astype(np.float32)
            args = (np.zeros(1, np.float32), np.zeros(nb, np.float32), data, n)
            t0 = time.perf_counter()
            req = gridReduce.make_request(grid=nb, block=128, args=args, autotune=True, device=DEVICE)
            check(req.rl.chunk_source == "cooperative", f"autotune gridReduce: {req.rl}")
            out, wall, _ = timed_launch(gridReduce, grid=nb, block=128, args=args, autotune=True)
            check(float(out["total"][0]) == float(data.sum()), "autotune gridReduce total")
            rec["gridReduce"] = {
                "chunk_source": req.rl.chunk_source,
                "chunk": req.rl.chunk,
                "backend": req.rl.backend,
                "tune_s": time.perf_counter() - t0 - wall,
                "tuned_wall_s": wall,
            }
            rec["stats"] = at.stats()
            rec["fingerprint"] = at.cpu_fingerprint(torch.device(DEVICE))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(rec)
    return rec


def phase_donate() -> dict:
    """Buffer donation on the card: vectorAdd on vmap over 2**22 f32
    elements (16 MiB an array) with and without donate=True, the peak
    device memory of each launch; the consumed input refused by a second
    launch; a stream relaunching over its own outputs with donation
    (tests/test_streams.py's chain), bitwise the plain chain; and
    donation refused in a graph capture."""
    n = DONATE_N
    block = 1024
    a_host = torch.randn(n, generator=torch.Generator().manual_seed(1))
    b_host = torch.randn(n, generator=torch.Generator().manual_seed(2))
    want = a_host + b_host

    def launch(donate):
        a, b = a_host.to(DEVICE), b_host.to(DEVICE)
        out = torch.zeros(n, device=DEVICE)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = vectorAdd.launch(
            grid=n // block, block=block, args=(out, a, b, n), backend="vmap", donate=donate, device=DEVICE
        )
        sync()
        wall = time.perf_counter() - t0
        return got["out"], torch.cuda.max_memory_allocated() - base, wall, (out, a, b)

    plain, plain_peak, plain_s, _ = launch(False)
    got, donate_peak, donate_s, held = launch(True)
    check(torch.equal(plain.cpu(), want) and torch.equal(got, plain), "donate: vectorAdd outputs")
    donated = 3 * 4 * n
    saved = plain_peak - donate_peak
    check(all(t.numel() == 0 for t in held), "donate: the inputs were not consumed")
    check(saved >= donated - (1 << 20), f"donate: peak fell by {saved} bytes, donated {donated}")
    try:
        vectorAdd.launch(
            grid=n // block, block=block, args=(torch.zeros(n, device=DEVICE), held[1], held[2], n), device=DEVICE
        )
        refused = None
    except cox.CoxUnsupported as e:
        refused = str(e)
    check(refused is not None and "donated" in refused, "donate: a consumed input was accepted")
    del plain, got, held
    torch.cuda.empty_cache()

    # the chain: saxpy, then scale three times over its own output
    m = 1024
    x = torch.arange(m, dtype=torch.float32, device=DEVICE) / m

    def chain(donate):
        d = cox.get_dispatcher()
        s = cox.Stream("donate-chain", d, device=DEVICE)
        h = s.launch(svc_saxpy, grid=4, block=256, args=(torch.zeros(m, device=DEVICE), x, torch.zeros(m, device=DEVICE), m))
        for _ in range(3):
            h = s.launch(svc_scale, grid=4, block=256, args=(h.outputs["out"], h.outputs["out"], m), donate=donate)
        return h.result()["out"]

    chained, chained_plain = chain(True), chain(False)
    ref_chain = 2.5 * (torch.arange(m, dtype=torch.float64) / m)
    for _ in range(3):
        ref_chain = ref_chain * 3.0 + 1.0
    check(torch.equal(chained, chained_plain), "donate: the donating chain != the plain chain")
    check(torch.allclose(chained.double().cpu(), ref_chain, rtol=1e-5), "donate: chain values")
    g = cox.Graph()
    s = cox.Stream("donate-capture", cox.get_dispatcher(), device=DEVICE)
    with g.capture(s):
        h1 = s.launch(svc_saxpy, grid=4, block=256, args=(np.zeros(m, np.float32), x.cpu().numpy(), np.zeros(m, np.float32), m))
        try:
            s.launch(svc_scale, grid=4, block=256, args=(np.zeros(m, np.float32), h1.outputs["out"], m), donate=True)
            capture_refused = None
        except cox.CoxUnsupported as e:
            capture_refused = str(e)
    check(capture_refused is not None and "not capturable" in capture_refused, "donate: a capture took donate=True")
    rec = {
        "phase": "donate",
        "kernel": "vectorAdd",
        "n": n,
        "grid": n // block,
        "block": block,
        "backend": "vmap",
        "donated_bytes": donated,
        "peak_bytes_plain": plain_peak,
        "peak_bytes_donate": donate_peak,
        "peak_saved_bytes": saved,
        "wall_s_plain": plain_s,
        "wall_s_donate": donate_s,
        "refused_reuse": refused,
        "chain": {"n": m, "relaunches": 3, "check": "bitwise == plain chain; rtol 1e-5 vs float64"},
        "capture_refused": capture_refused,
    }
    emit(rec)
    return rec


def phase_costmodel(rng: np.random.Generator) -> dict:
    """The counted cost record (``costmodel.estimate(mode='xla')``: one
    launch counted op by op) of the five COX kernels at the cox phase's
    sizes, beside the static IR walk's, with the counted pass's seconds.
    MatrixMulCUDA is counted on its whole-grid batched-plane cell (the
    cox phase's fastest), the others on their auto knobs."""
    from repro_torch.core import costmodel

    n, v = MM_N, VEC_N
    cases = [
        ("vectorAdd", vectorAdd, dict(grid=-(-v // 256), block=256), (np.zeros(v, np.float32), rng.normal(size=v).astype(np.float32), rng.normal(size=v).astype(np.float32), v), {}),
        (
            "MatrixMulCUDA",
            MatrixMulCUDA,
            dict(grid=(n // 16, n // 16), block=(16, 16)),
            (np.zeros((n, n), np.float32), rng.normal(size=(n, n)).astype(np.float32), rng.normal(size=(n, n)).astype(np.float32), n),
            dict(collapse="hier", warp_exec="batched", chunk=(n // 16) ** 2),
        ),
        ("warpReduce", warpReduce, dict(grid=AUTOTUNE_GRIDS["warpReduce"], block=256), COX_SCAN["warpReduce"][0], {}),
        ("voteBallot", voteBallot, dict(grid=AUTOTUNE_GRIDS["voteBallot"], block=256), COX_SCAN["voteBallot"][0], {}),
        ("gridReduce", gridReduce, dict(grid=64, block=128), (np.zeros(1, np.float32), np.zeros(64, np.float32), rng.integers(-8, 9, size=8000).astype(np.float32), 8000), {}),
    ]
    rec = {"phase": "costmodel", "kernels": {}}
    costmodel.clear_cache()
    for name, kern, geo, args, kw in cases:
        req = kern.make_request(args=args, device=DEVICE, **geo, **kw)
        st = costmodel.estimate_request(req, mode="static")
        sync()
        t0 = time.perf_counter()
        est = costmodel.estimate_request(req, mode="xla")
        sync()
        secs = time.perf_counter() - t0
        check(est.source == "xla" and est.op_estimate > 0 and est.mem_estimate > 0, f"costmodel {name}: {est}")
        rec["kernels"][name] = {
            "backend": req.rl.backend,
            "warp_exec": req.rl.warp_exec,
            "chunk": req.rl.chunk,
            "schedule": req.rl.schedule,
            "counted_s": secs,
            "ops_counted": est.op_estimate,
            "ops_static": st.op_estimate,
            "ops_ratio": est.op_estimate / st.op_estimate,
            "bytes_counted": est.mem_estimate,
            "bytes_static": st.mem_estimate,
            "bytes_ratio": est.mem_estimate / st.mem_estimate,
        }
    emit(rec)
    return rec


AUTOTUNE_CELL = re.compile(r"\[autotune: (\d+)h/(\d+)dh/(\d+)m, (\d+) measured\]")


def phase_autotune_serve(cpu_tokens: int) -> dict:
    """``launch.serve.main([... '--postproc', '--autotune'])`` on
    mamba2-130m at full width and depth on a fresh cache file: the
    postprocess histograms tune (misses, measurements); then the same
    command in a child process on the same file: disk hits and no
    measurement.  Both serve the tokens of phase ssm_serve."""
    tmp = tempfile.mkdtemp(prefix="cox-autotune-serve-")
    path = os.path.join(tmp, "autotune.json")
    try:
        with autotune_cache(path):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                out = serve.main(AUTOTUNE_SERVE_ARGV)
            first_s = time.perf_counter() - t0
            os.environ.pop("COX_AUTOTUNE", None)
        sync()
        torch.cuda.empty_cache()
        at1 = out["dispatch_health"]["autotune"]
        check(out["tokens"] == cpu_tokens, f"autotune_serve: {out['tokens']} tokens, CPU {cpu_tokens}")
        check(at1["misses"] > 0 and at1["measurements"] > 0, f"autotune_serve: cold run {at1}")
        check(out["postproc"]["failed"] == 0, f"autotune_serve: {out['postproc']}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), COX_AUTOTUNE_CACHE=path)
        env.pop("COX_AUTOTUNE", None)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *AUTOTUNE_SERVE_ARGV],
            capture_output=True,
            text=True,
            env=env,
            timeout=600,
        )
        second_s = time.perf_counter() - t0
        check(child.returncode == 0, f"autotune_serve child: {child.returncode} {child.stderr[-2000:]}")
        line = child.stdout.strip().splitlines()[-1]
        cell = AUTOTUNE_CELL.search(line)
        toks = re.search(r"served \d+ requests, (\d+) tokens", line)
        check(cell is not None and toks is not None, f"autotune_serve child printed {line!r}")
        hits, disk_hits, misses, measured = (int(x) for x in cell.groups())
        check(disk_hits >= 1 and misses == 0 and measured == 0, f"autotune_serve warm child: {cell.group(0)}")
        check(int(toks.group(1)) == cpu_tokens, f"autotune_serve child: {toks.group(1)} tokens")
        with open(path) as f:
            entries = json.load(f)["entries"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {
        "phase": "autotune_serve",
        "arch": SSM_ARCH,
        "argv": AUTOTUNE_SERVE_ARGV,
        "tokens": out["tokens"],
        "cold": {k: at1[k] for k in ("hits", "disk_hits", "misses", "measurements", "tuned", "disk_writes")},
        "cold_wall_s": first_s,
        "warm_child": {"hits": hits, "disk_hits": disk_hits, "misses": misses, "measurements": measured},
        "warm_child_wall_s": second_s,
        "warm_child_line": line,
        "winners": {" ".join(k.split("|")[i] for i in (0, 3, 7)): {f: v[f] for f in ("backend", "warp_exec", "chunk", "schedule", "best_us")} for k, v in entries.items()},
    }
    emit(rec)
    return rec


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


SCAN = dict(backend="scan", warp_exec="serial")  # the serial loop, as before PR 21
# phase_cox's arguments and scan outputs, which phase_autotune holds its
# tuned launches against: kernel -> (args, outputs)
COX_SCAN = {}


def launch_knobs(kern, *, grid, block, args, collapse="hybrid", **kw) -> dict:
    """The knobs a launch resolves to (collapse, warps, backend, warp
    plane, wave, schedule)."""
    ck = kern.compiled(block=block, collapse=collapse)
    rl = runtime.resolve_launch(ck, grid=grid, block=block, **kw)
    shapes = {
        spec.name: tuple(np.shape(a))
        for spec, a in zip(ck.kernel.params, args)
        if isinstance(spec, ArraySpec)
    }
    rl = runtime.resolve_schedule(ck, rl, shapes)
    return {
        "collapse": "flat" if ck.warp_size == rl.block.total else "hier",
        "n_warps": rl.n_warps,
        "backend": rl.backend,
        "warp_exec": rl.warp_exec,
        "chunk": rl.chunk,
        "schedule": rl.schedule,
        "n_resident": rl.n_resident,
    }


def phase_cox(rng: np.random.Generator) -> None:
    """COX launches on CUDA tensors: the serial ``scan`` path against the
    numpy oracle, and the block-parallel ``vmap`` path (batched warps
    where ``auto`` picks them) bitwise against the scan launch."""

    def run(name, kern, *, grid, block, args, **kw):
        out, wall, syncs = timed_launch(kern, grid=grid, block=block, args=args, **kw)
        knobs = launch_knobs(kern, grid=grid, block=block, args=args, **kw)
        return out, {"phase": "cox", "kernel": name, "wall_s": wall, "host_syncs": syncs, **knobs}

    def same(a, b):
        return all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)

    def vmap_against_scan(name, kern, scan_out, *, grid, block, args, **kw):
        """One block-parallel launch, bitwise against the scan launch."""
        kw = {"backend": "vmap", **kw}
        out, rec = run(name, kern, grid=grid, block=block, args=args, **kw)
        check(same(out, scan_out), f"{name} {kw} != scan")
        emit({**rec, "check": "bitwise == scan"})
        return rec

    # vectorAdd: the SDK default size, whole grid against the oracle (one
    # f32 add per element on both sides: bitwise)
    a = rng.normal(size=VEC_N).astype(np.float32)
    b = rng.normal(size=VEC_N).astype(np.float32)
    args = (np.zeros(VEC_N, np.float32), a, b, VEC_N)
    grid = -(-VEC_N // 256)
    out, rec = run("vectorAdd", vectorAdd, grid=grid, block=256, args=args, **SCAN)
    want = oracle.run_grid(vectorAdd.ir, grid=grid, block=256, args=args)
    check(np.array_equal(out["out"].cpu().numpy(), want["out"]), "vectorAdd != oracle")
    emit({**rec, "n": VEC_N, "grid": grid, "block": 256, "check": "bitwise"})
    vmap_against_scan("vectorAdd", vectorAdd, out, grid=grid, block=256, args=args)

    def matmul_case(n):
        ma = rng.normal(size=(n, n)).astype(np.float32)
        mb = rng.normal(size=(n, n)).astype(np.float32)
        return (np.zeros((n, n), np.float32), ma, mb, n), (n // 16, n // 16), (16, 16)

    def matmul_against_numpy(kern, out, rec, args, grid, block):
        """The whole product against numpy, two blocks against the oracle
        (the per-thread oracle of every block is slow)."""
        _, ma, mb, n = args
        got = out["out"].cpu().numpy()
        full = ma.astype(np.float64) @ mb.astype(np.float64)
        check(np.allclose(got, full, rtol=1e-4, atol=1e-4), f"MatrixMulCUDA n={n} != a @ b")
        bids = [0, (n // 16) ** 2 - 1]
        want = _oracle_blocks(kern, bids, grid=grid, block=block, args=args)["out"].reshape(n, n)
        tiles = [(slice(0, 16), slice(0, 16)), (slice(n - 16, n), slice(n - 16, n))]
        tile_err = max(float(np.abs(got[t] - want[t]).max()) for t in tiles)
        check(tile_err <= 1e-5, f"MatrixMulCUDA n={n} oracle blocks: max err {tile_err}")
        emit(
            {
                **rec,
                "n": n,
                "grid": list(grid),
                "block": list(block),
                "check": "a@b rtol 1e-4 atol 1e-4; oracle blocks 0 and last atol 1e-5",
                "oracle_max_err": tile_err,
            }
        )

    # MatrixMulCUDA on scan at n = MM_SCAN_N, and the default vmap launch
    # bitwise against it
    args, grid, block = matmul_case(MM_SCAN_N)
    scan_out, rec = run("MatrixMulCUDA", MatrixMulCUDA_scan, grid=grid, block=block, args=args, **SCAN)
    matmul_against_numpy(MatrixMulCUDA_scan, scan_out, rec, args, grid, block)
    vmap_against_scan("MatrixMulCUDA", MatrixMulCUDA_scan, scan_out, grid=grid, block=block, args=args)
    # at the SDK's n = MM_N: the default (auto knobs) vmap launch against
    # numpy and the oracle, then the block-parallel variants bitwise
    # against it.  The default (hybrid) collapse compiles this warp-free
    # kernel flat, one 256-lane warp a block; the warp-plane variants
    # collapse it hierarchically into 8 warps: serial warps with the whole
    # grid in one wave (50 waves of 8 took 70-85 s of the script), the
    # batched warp plane, the batched plane with the whole grid in one
    # wave; then grid-stride waves of 64 blocks.  The multidevice phase
    # times its sharded launches beside the default launch
    args, grid, block = matmul_case(MM_N)
    n = MM_N
    vmap_out, vmap_rec = run("MatrixMulCUDA", MatrixMulCUDA, grid=grid, block=block, args=args, backend="vmap")
    matmul_against_numpy(MatrixMulCUDA, vmap_out, vmap_rec, args, grid, block)
    for kw in (
        dict(collapse="hier", warp_exec="serial", chunk=(n // 16) ** 2),
        dict(collapse="hier", warp_exec="batched"),
        dict(collapse="hier", warp_exec="batched", chunk=(n // 16) ** 2),
        dict(schedule="grid_stride", n_resident=64),
    ):
        kw = {"backend": "vmap", **kw}
        out, rec = run("MatrixMulCUDA", MatrixMulCUDA, grid=grid, block=block, args=args, **kw)
        check(same(out, vmap_out), f"MatrixMulCUDA {kw} != the default vmap launch")
        emit({**rec, "n": n, "check": "bitwise == the default vmap launch"})
    MM_REF.update(args=args, out=vmap_out, vmap_s=vmap_rec["wall_s"])

    # warp shuffle reduction: small integers, so every sum is exact
    nb = 128
    val = rng.integers(-8, 9, size=nb * 256).astype(np.float32)
    args = (np.zeros(nb, np.float32), val)
    out, rec = run("warpReduce", warpReduce, grid=nb, block=256, args=args, **SCAN)
    COX_SCAN["warpReduce"] = (args, out)
    want = oracle.run_grid(warpReduce.ir, grid=nb, block=256, args=args)
    got = out["out"].cpu().numpy()
    check(np.array_equal(got, want["out"]), "warpReduce != oracle")
    check(np.array_equal(got, val.reshape(nb, 256).sum(1)), "warpReduce != sums")
    emit({**rec, "grid": nb, "block": 256, "check": "bitwise"})
    vmap_against_scan("warpReduce", warpReduce, out, grid=nb, block=256, args=args)

    # vote / ballot: lane 31 sets bit 31 of the u32 ballot
    nb = 64
    inp = rng.integers(-1, 2, size=nb * 256).astype(np.int32)
    inp[31::32] = 1
    zeros = np.zeros(nb * 256, np.int32)
    args = (zeros, zeros, zeros.astype(np.uint32), inp)
    out, rec = run("voteBallot", voteBallot, grid=nb, block=256, args=args, **SCAN)
    COX_SCAN["voteBallot"] = (args, out)
    want = oracle.run_grid(voteBallot.ir, grid=nb, block=256, args=args)
    for k in ("any_out", "all_out", "bits"):
        got = out[k].cpu().numpy()
        same_k = got.dtype == want[k].dtype and np.array_equal(got, want[k])
        check(same_k, f"voteBallot {k} != oracle")
    check(bool((out["bits"].cpu().numpy() >> 31).all()), "ballot lost bit 31")
    emit({**rec, "grid": nb, "block": 256, "check": "bitwise"})
    vmap_against_scan("voteBallot", voteBallot, out, grid=nb, block=256, args=args)

    # gridReduce: grid sync; phased scan, then vmap as one all-resident
    # wave and as grid-stride phase waves of 16 blocks, each against the
    # oracle
    nb, n = 64, 8000
    data = rng.integers(-8, 9, size=n).astype(np.float32)
    args = (np.zeros(1, np.float32), np.zeros(nb, np.float32), data, n)
    want = oracle.run_grid(gridReduce.ir, grid=nb, block=128, args=args)
    for kw in (SCAN, dict(backend="vmap"), dict(backend="vmap", n_resident=16)):
        out, rec = run("gridReduce", gridReduce, grid=nb, block=128, args=args, **kw)
        for k in ("total", "partial"):
            same_k = np.array_equal(out[k].cpu().numpy(), want[k])
            check(same_k, f"gridReduce {kw} {k} != oracle")
        check(float(out["total"][0]) == float(data.sum()), "gridReduce total")
        check(all(t.device.type == DEVICE for t in out.values()), "outputs left the card")
        emit({**rec, "grid": nb, "block": 128, "n": n, "check": "bitwise == oracle"})


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


# ---------------------------------------------------------------------------
# COX on a pool of devices: sharded launches over torch.distributed ranks,
# and stream placement over a pool of logical devices
# ---------------------------------------------------------------------------

MD_RANKS = 8  # gloo ranks sharing the card: tests/test_multidevice.py's 8 devices
MD_STRIDE_RANKS = 4  # tests/test_grid_stride.py's 4 devices (grid 10: 3/3/3/1)
MD_TIMEOUT_S = 150  # a spawned world, and every collective
MD_POOL = 4  # logical devices on the card
MD_WORLDS = {MD_RANKS: ("vec_madd", "histogram", "gridReduce"), MD_STRIDE_RANKS: ("stride",)}
# the cox phase's MatrixMulCUDA at n = MM_N: its args, the output and the
# wall seconds of its single-device launch on the default knobs, which the
# multidevice phase holds its sharded launches to and times them beside
MM_REF = {}


def md_case(name: str):
    """``(kernel, grid, block, args, knobs)`` of a multi-device case, made
    from fixed seeds so that every rank holds the same inputs."""
    if name == "vec_madd":
        a = np.arange(2048, dtype=np.float32)
        return vec_madd, 8, 256, (np.zeros(2048, np.float32), a, np.ones(2048, np.float32), 2000), {}
    if name == "histogram":
        d = np.random.default_rng(0).integers(0, 16, 1024).astype(np.int32)
        return histogram, 8, 128, (np.zeros(16, np.float32), d, 1024), {}
    if name == "gridReduce":
        d = np.random.default_rng(7).integers(-8, 9, size=1000).astype(np.float32)
        return gridReduce, 8, 128, (np.zeros(1, np.float32), np.zeros(8, np.float32), d, 1000), {}
    if name == "stride":
        rng = np.random.default_rng(0)
        x = rng.normal(size=1280).astype(np.float32)
        y = rng.normal(size=1280).astype(np.float32)
        knobs = dict(schedule="grid_stride", n_resident=2)
        return vec_madd, 10, 128, (np.zeros(1280, np.float32), x, y, 1280), knobs
    raise KeyError(name)


@contextlib.contextmanager
def collective_clock():
    """Time every cross-device gather of the sharded backend (synchronised
    on both sides): ``{"s": seconds, "calls": n}``."""
    from repro_torch.core.backends import sharded

    gather = sharded.AxisGroup.gather
    acc = {"s": 0.0, "calls": 0}

    def timed(self, tensors):
        sync()
        t0 = time.perf_counter()
        out = gather(self, tensors)
        sync()
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out

    sharded.AxisGroup.gather = timed
    try:
        yield acc
    finally:
        sharded.AxisGroup.gather = gather


def _digest(out: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode())
        h.update(out[k].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def md_sharded(mesh, kern, grid, block, args, knobs) -> tuple:
    """One sharded launch on ``mesh``, the ranks started together:
    ``(outputs, record)`` with its wall seconds, the gathers' share of
    them, the resolved knobs and a digest of the outputs."""
    torch.distributed.barrier()
    with collective_clock() as coll:
        sync()
        t0 = time.perf_counter()
        out = kern.launch(grid=grid, block=block, args=args, mesh=mesh, **knobs)
        sync()
        wall = time.perf_counter() - t0
    check(all(t.device.type == DEVICE for t in out.values()), f"{kern.name}: outputs left the card")
    resolved = launch_knobs(kern, grid=grid, block=block, args=args, mesh=mesh, **knobs)
    rec = {
        "kernel": kern.name,
        "grid": list(grid) if isinstance(grid, tuple) else [grid],
        "block": list(block) if isinstance(block, tuple) else [block],
        **{k: resolved[k] for k in ("backend", "warp_exec", "chunk", "schedule", "n_resident")},
        "wall_s": wall,
        "collective_s": coll["s"],
        "collective_share": coll["s"] / wall,
        "gathers": coll["calls"],
        "digest": _digest(out),
    }
    return out, rec


def md_run(mesh, names) -> list:
    """Each case on ``mesh`` (every rank makes the same launches): the
    sharded launch bitwise the single-device scan and ``vmap`` launches,
    timed beside the ``vmap`` launch."""
    recs = []
    for name in names:
        kern, grid, block, args, knobs = md_case(name)
        kern.launch(grid=grid, block=block, args=args, mesh=mesh, **knobs)  # compile, stage
        scan, _, _ = timed_launch(kern, grid=grid, block=block, args=args, **SCAN)
        vmap, vmap_s, _ = timed_launch(kern, grid=grid, block=block, args=args, backend="vmap", **knobs)
        out, rec = md_sharded(mesh, kern, grid, block, args, knobs)
        for want in (scan, vmap):
            same = all(out[k].dtype == want[k].dtype and torch.equal(out[k], want[k]) for k in want)
            check(same, f"{name}: the sharded launch over {mesh.size()} rank(s) != the single-device launch")
        recs.append({**rec, "case": name, "vmap_wall_s": vmap_s, "check": "bitwise == scan and vmap"})
    return recs


def md_matmul(mesh, args) -> dict:
    """MatrixMulCUDA at the cox phase's n on its default knobs sharded over
    ``mesh``: compiled on one block first (every rank), then one timed
    launch."""
    n = args[3]
    tile = (np.zeros((16, 16), np.float32), args[1][:16, :16].copy(), args[2][:16, :16].copy(), 16)
    MatrixMulCUDA.launch(grid=(1, 1), block=(16, 16), args=tile, mesh=mesh)
    return md_sharded(mesh, MatrixMulCUDA, (n // 16, n // 16), (16, 16), args, {})[1]


def md_matmul_reference() -> dict:
    """The cox phase's MatrixMulCUDA (``MM_REF``), or, where that phase did
    not run, the same launch (the cox phase holds it to numpy and the
    oracle)."""
    if not MM_REF:
        rng = np.random.default_rng(0)
        ma = rng.normal(size=(MM_N, MM_N)).astype(np.float32)
        mb = rng.normal(size=(MM_N, MM_N)).astype(np.float32)
        args = (np.zeros((MM_N, MM_N), np.float32), ma, mb, MM_N)
        grid = (MM_N // 16, MM_N // 16)
        out, wall, _ = timed_launch(MatrixMulCUDA, grid=grid, block=(16, 16), args=args, backend="vmap")
        MM_REF.update(args=args, out=out, vmap_s=wall)
    return MM_REF


def md_rank_main(rank: int, world: int, root: str) -> int:
    """One gloo rank on the card (``chip_smoke.py --md-rank R --md-world
    N --md-dir D [--md-device cpu]``): the cases of its world on a
    ``DeviceMesh`` over the world, and MatrixMulCUDA where the parent
    left its matrices (``D/mm.npz``), written to ``D/rank{R}.json``."""
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    out = pathlib.Path(root) / f"rank{rank}.json"
    rec = {"rank": rank, "world": world, "ok": False}
    try:
        dist.init_process_group(
            "gloo",
            init_method=f"file://{root}/store",
            rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=MD_TIMEOUT_S),
        )
        try:
            mesh = init_device_mesh(DEVICE, (world,), mesh_dim_names=("data",))
            rec["launches"] = md_run(mesh, MD_WORLDS[world])
            mm = pathlib.Path(root) / "mm.npz"
            if mm.exists():
                z = np.load(mm)
                n = int(z["n"])
                rec["matmul"] = md_matmul(mesh, (np.zeros((n, n), np.float32), z["a"], z["b"], n))
            if rank == 0:
                # a sharded launch on a gloo group is not capturable
                s = cox.Stream("md_gloo_graph", dispatcher=Dispatcher(devices=[DEVICE]))
                g = cox.Graph()
                kern, grid, block, args, _ = md_case("vec_madd")
                with g.capture(s):
                    s.launch(kern, grid=grid, block=block, args=args, mesh=mesh)
                try:
                    g.instantiate()
                    rec["gloo_capture"] = "captured"
                except cox.CoxUnsupported as e:
                    rec["gloo_capture"] = f"refused: {e}"[:160]
            dist.barrier()
            rec["ok"] = True
        finally:
            dist.destroy_process_group()
    except Exception:
        rec["error"] = traceback.format_exc()[-3000:]
    out.write_text(json.dumps(rec))
    return 0 if rec["ok"] else 1


def md_spawn(world: int, matmul_args=None) -> list:
    """Run ``world`` gloo ranks on the card as processes (with
    MatrixMulCUDA's matrices, when given); every rank must exit 0 within
    ``MD_TIMEOUT_S`` and all must agree on every output."""
    with tempfile.TemporaryDirectory() as root:
        if matmul_args is not None:
            np.savez(pathlib.Path(root) / "mm.npz", a=matmul_args[1], b=matmul_args[2], n=matmul_args[3])
        procs = []
        for r in range(world):
            with open(pathlib.Path(root) / f"rank{r}.log", "w") as log:
                cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--md-rank", str(r)]
                cmd += ["--md-world", str(world), "--md-dir", root, "--md-device", DEVICE]
                procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + MD_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        recs = []
        for r, p in enumerate(procs):
            path = pathlib.Path(root) / f"rank{r}.json"
            rec = json.loads(path.read_text()) if path.exists() else {"ok": False}
            if p.returncode != 0 or not rec["ok"]:
                log = (pathlib.Path(root) / f"rank{r}.log").read_text()[-2000:]
                check(False, f"gloo rank {r}/{world} failed ({p.returncode}): {rec.get('error')} {log}")
            recs.append(rec)
    for i, case in enumerate(recs[0]["launches"]):
        digests = {rec["launches"][i]["digest"] for rec in recs}
        check(len(digests) == 1, f"{case['case']}: the {world} ranks disagree")
    if matmul_args is not None:
        check(len({rec["matmul"]["digest"] for rec in recs}) == 1, f"MatrixMulCUDA: the {world} ranks disagree")
    return recs


def md_pool() -> dict:
    """Streams over ``device_pool(MD_POOL, logical=True)`` on the card: the
    round-robin spread with every (backend, warp_exec) cell bitwise the
    unplaced launch, a cross-device event and data edge, health-aware
    routing after an injected sticky fault with ``device_reset(device=)``,
    and a graph on a placed stream replayed as a CUDA graph."""
    from repro_torch.launch.mesh import device_pool

    grid, block = 8, 256
    n = grid * block
    rng = np.random.default_rng(0)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    o = np.zeros(n, np.float32)
    args = (o, x, y, n)
    want = vec_madd.launch(grid=grid, block=block, args=args, device=DEVICE)["out"]
    want2 = vec_madd.launch(grid=grid, block=block, args=(o, want, y, n), device=DEVICE)["out"]
    rec = {}
    d = Dispatcher(devices=device_pool(MD_POOL, logical=True, device_type=DEVICE))
    streams = [cox.Stream(f"md_s{i}", dispatcher=d) for i in range(MD_POOL)]
    for backend, we in [("scan", "serial"), ("scan", "batched"), ("vmap", "serial"), ("vmap", "batched")]:
        hs = [s.launch(vec_madd, grid=grid, block=block, args=args, backend=backend, warp_exec=we) for s in streams]
        check(all(torch.equal(h.result()["out"], want) for h in hs), f"pool spread {backend}/{we} != unplaced")
    devs = [s.device for s in streams]
    check(len(set(devs)) == MD_POOL, f"round-robin placed {MD_POOL} streams on {devs}")
    if DEVICE == "cuda":
        tstreams = {id(s.torch_stream(dv)) for s, dv in zip(streams, devs)}
        check(len(tstreams) == MD_POOL, "logical devices share a CUDA stream")
    rec["dispatches"] = {k: v["dispatches"] for k, v in d.device_health().items()}
    # a cross-device event and data edge
    s0 = cox.Stream("md_prod", dispatcher=d, device=d.devices[0])
    s1 = cox.Stream("md_cons", dispatcher=d, device=d.devices[1])
    h0 = s0.launch(vec_madd, grid=grid, block=block, args=args)
    s1.wait_event(s0.record_event())
    h1 = s1.launch(vec_madd, grid=grid, block=block, args=(o, h0.outputs["out"], y, n))
    check(torch.equal(h1.result()["out"], want2), "cross-device chain != the unplaced chain")
    check(h0.request.seq in h1.request.deps, "the event edge is missing")
    rec["edge"] = {"producer": str(h0.request.device), "consumer": str(h1.request.device), "data_edge": bool(h1.request.data_deps), "transfers": d.transfers}
    # health-aware routing around a sticky fault, then the scoped reset
    hd = Dispatcher(devices=device_pool(MD_POOL, logical=True, device_type=DEVICE), placement=cox.HealthAwarePlacement())
    victim = cox.Stream("md_victim", dispatcher=hd)
    with cox.faults.inject("vec_madd", site="sticky-device", times=1):
        h = victim.launch(vec_madd, grid=grid, block=block, args=args)
        try:
            h.result()
            check(False, "the injected sticky fault did not surface")
        except cox.CoxDeviceError:
            pass
    bad = victim.device
    check(list(hd.health()["sticky_devices"]) == [str(bad)], "the sticky fault is not scoped to its device")
    others = [cox.Stream(f"md_n{i}", dispatcher=hd) for i in range(6)]
    for h2 in [st.launch(vec_madd, grid=grid, block=block, args=args) for st in others]:
        check(torch.equal(h2.result()["out"], want), "a re-routed launch != unplaced")
    check(all(st.device != bad for st in others), "placement used the poisoned device")
    victim.launch(vec_madd, grid=grid, block=block, args=args).result()
    check(victim.device != bad, "the poisoned stream did not re-place")
    hd.device_reset(device=bad)
    check(hd.health()["sticky_devices"] == {}, "device_reset(device=) left the fault")
    rec["health"] = {"poisoned": str(bad), "failures": hd.device_health()[str(bad)]["failures"]}
    # a graph captured on a placed stream, replayed as a CUDA graph
    gs = cox.Stream("md_gcap", dispatcher=d, device=d.devices[2])
    g = cox.Graph(name="md-placed-chain")
    with g.capture(gs):
        h = gs.launch(vec_madd, grid=grid, block=block, args=args)
        gs.launch(vec_madd, grid=grid, block=block, args=(o, h.outputs["out"], y, n))
    exe = g.instantiate()
    check(exe.device is d.devices[2], "the placed graph left its device")
    check(DEVICE != "cuda" or exe.cuda_graph is not None, "the placed graph is not a CUDA graph")
    check(torch.equal(exe.replay()["out"], want2), "placed graph replay != the eager chain")
    rec["graph"] = {"device": str(exe.device), "cuda_graph": exe.cuda_graph is not None}
    return rec


def phase_multidevice() -> dict:
    """COX on a pool of devices, on the card: (1) one NCCL rank, every case
    on a one-rank mesh bitwise the scan launch, the vmap launch and the
    oracle, one sharded launch captured and replayed as a CUDA graph,
    and MatrixMulCUDA at n = MM_N on the one-rank mesh bitwise the cox
    phase's default launch; (2) gloo ranks sharing the card, spawned as processes
    (8 for vec_madd, histogram and gridReduce; 4 for the grid-stride
    vec_madd and MatrixMulCUDA), every rank bitwise the single-device
    launches and all ranks the same; (3) a pool of logical devices."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    ref = md_matmul_reference()
    ref_digest = _digest(ref["out"])
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, no network
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",
            init_method=f"file://{root}/store",
            rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=MD_TIMEOUT_S),
        )
        try:
            mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("data",))
            one = md_run(mesh, ("vec_madd", "histogram", "gridReduce", "stride"))
            for r in one:
                kern, grid, block, args, knobs = md_case(r["case"])
                want = oracle.run_grid(kern.ir, grid=grid, block=block, args=args)
                got = kern.launch(grid=grid, block=block, args=args, mesh=mesh, **knobs)
                check(all(np.array_equal(got[k].cpu().numpy(), want[k]) for k in want), f"{r['case']} != oracle")
                r["check"] += " and the oracle"
            # one sharded launch captured as a CUDA graph (NCCL, one rank)
            kern, grid, block, args, _ = md_case("vec_madd")
            s = cox.Stream("md_nccl_graph", dispatcher=Dispatcher(devices=[DEVICE]))
            eager = s.launch(kern, grid=grid, block=block, args=args, mesh=mesh).result()
            g = cox.Graph()
            with g.capture(s):
                s.launch(kern, grid=grid, block=block, args=args, mesh=mesh)
            exe = g.instantiate()
            check(DEVICE != "cuda" or exe.cuda_graph is not None, "the NCCL sharded launch is not a CUDA graph")
            replayed = exe.replay()
            check(all(torch.equal(replayed[k], eager[k]) for k in replayed), "sharded graph replay != eager")
            mm1 = md_matmul(mesh, ref["args"])
            check(mm1["digest"] == ref_digest, "MatrixMulCUDA on one rank != the single-device launch")
        finally:
            dist.destroy_process_group()
    for r in one:
        emit({"phase": "multidevice", "part": "nccl_1_rank", "ranks": 1, **r})
    emit({"phase": "multidevice", "part": "nccl_1_rank", "ranks": 1, "kernel": "vec_madd", "graph": "cuda_graph replay bitwise == eager"})
    worlds = {MD_RANKS: md_spawn(MD_RANKS), MD_STRIDE_RANKS: md_spawn(MD_STRIDE_RANKS, ref["args"])}
    for w, recs in worlds.items():
        for i, r in enumerate(recs[0]["launches"]):
            walls = [rec["launches"][i]["wall_s"] for rec in recs]
            emit({"phase": "multidevice", "part": f"gloo_{w}_ranks", "ranks": w, **r, "wall_s_max_rank": max(walls), "check": r["check"] + " on every rank; the ranks agree"})
    emit({"phase": "multidevice", "part": "gloo_capture", "ranks": MD_RANKS, "result": worlds[MD_RANKS][0]["gloo_capture"]})
    if DEVICE == "cuda":
        check(worlds[MD_RANKS][0]["gloo_capture"].startswith("refused"), "a gloo sharded launch was captured")
    mm4 = worlds[MD_STRIDE_RANKS][0]["matmul"]
    check(mm4["digest"] == ref_digest, "MatrixMulCUDA over 4 gloo ranks != the single-device launch")
    emit(
        {
            "phase": "multidevice",
            "part": "matmul",
            "kernel": "MatrixMulCUDA",
            "n": ref["args"][3],
            "ranks_4_gloo_wall_s": mm4["wall_s"],
            "wall_s_max_rank_4": max(rec["matmul"]["wall_s"] for rec in worlds[MD_STRIDE_RANKS]),
            "rank_1_nccl_wall_s": mm1["wall_s"],
            "single_device_vmap_wall_s": ref["vmap_s"],
            "collective_share_4": mm4["collective_share"],
            "collective_share_1": mm1["collective_share"],
            "knobs": {k: mm4[k] for k in ("backend", "warp_exec", "chunk", "schedule")},
            "check": "bitwise == the cox phase's default vmap launch on 1 and 4 ranks; the ranks agree",
        }
    )
    pool = md_pool()
    emit({"phase": "multidevice", "part": "pool", "devices": MD_POOL, **pool})
    rec = {"phase": "multidevice", "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the model stack on a mesh
# ---------------------------------------------------------------------------

MESH_RANKS = 4  # gloo ranks sharing the card, one spawn for every case
MESH_TIMEOUT_S = 420  # the spawned world, and every collective
MESH_SERVE = dict(batch=4, ctx=512, n_requests=4, prompt=8, max_tokens=16)
MESH_GLOO_SERVE = dict(n_requests=1, max_tokens=4)  # the gloo ranks' full-depth bf16 serve
MESH_DECODE = dict(n_layers=2, batch=4, ctx=512, pos=[137, 255, 256, 511])
MESH_PAD_CTX = 510  # (1, 3): slabs of 170 rows
MESH_TRAIN = dict(n_layers=1, batch=1, seq=256)
MESH_ZERO = dict(n_layers=1, batch=2, seq=256)
MESH_MOE = dict(n_layers=2, batch=1, seq=256)
MESH_RTOL = 1e-3  # logits, caches and gradients, relative to their largest magnitude
MESH_LOSS_RTOL = 1e-4
# a gloo gradient case farther than this from the one-device gradient also
# measures both against the step in f64 (``grads_from_f64``)
MESH_GRAD_ANCHOR = 1e-4
# a MoE gradient sums each token's routed experts, split 32 and 32 over two
# ranks and summed over "model" after, in another order: twice MESH_RTOL
MESH_MOE_RTOL = 2e-3
# tensor parallelism for the SSM, hybrid and encoder-decoder families: the
# gloo ranks' f32 decode steps and gradients at 1 layer (seamless 1 + 1;
# zamba2's one layer is followed by its shared block), full width
TP_DECODE = [(SSM_ARCH, (1, 2)), (SSM_ARCH, (1, 4)), (HYBRID_ARCH, (1, 2)), (ENCDEC_ARCH, (1, 2))]
TP_GRADS = (SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH)  # on (1, 2)
TP_TRAIN = dict(n_layers=1, batch=1, seq=256)
TP_NCCL_TRAIN = dict(n_layers=2, batch=1, seq=256)  # zamba2 and seamless (2 + 2) on 1 x 1, bf16
DRYRUN_CELL = (SSM_ARCH, "train_4k")  # on a fake 16 x 16 world, in a child process
DRYRUN_TIMEOUT_S = 240


def mesh_prompts(cfg) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab, size=MESH_SERVE["prompt"]).tolist() for _ in range(MESH_SERVE["n_requests"])]


def mesh_serve(server, prompts, max_tokens=MESH_SERVE["max_tokens"]) -> tuple:
    """The requests fill the slots (one each), prefill, then decode; the
    tokens (copied: ``decode`` returns the server's own lists) and the
    decode steps' ms."""
    for slot, prompt in enumerate(prompts):
        server.prefill_prompt(slot, prompt)
    outs = server.decode(max_tokens)
    return [list(o) for o in outs], [s * 1e3 for s in server.step_s]


def first_step_logits(cfg, server) -> torch.Tensor:
    """The logits of one decode step of a server's model on a fresh cache
    (the first prompt tokens at position 0), full on the host."""
    B, ctx = MESH_SERVE["batch"], MESH_SERVE["ctx"]
    cache = init_params(lm.cache_specs(server.cfg, B, ctx), None, server.device, rules=server.rules)
    toks = torch.tensor([p[0] for p in mesh_prompts(cfg)], dtype=torch.int32, device=server.device)
    pos = torch.zeros(B, dtype=torch.int32, device=server.device)
    if server.rules is not None:
        bpl = server.rules.placements_for((B,), ("batch",))
        from repro_torch.models.params import shard_full

        toks, pos = shard_full(toks, server.mesh, bpl), shard_full(pos, server.mesh, bpl)
    logits, _ = lm.decode_step(server.cfg, server.params, cache, toks, pos, rules=server.rules)
    return (logits.full_tensor() if server.rules is not None else logits).cpu()


def comm_counts(fn):
    """``fn()`` and the collectives it issued, by op."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm:
        out = fn()
    return out, {str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _f32(arch, **cuts):
    return dataclasses.replace(registry.get(arch), param_dtype=torch.float32, **cuts)


def _depth(arch: str, n: int) -> dict:
    """The cut to ``n`` layers (an encoder-decoder model's both stacks)."""
    cut = dict(n_layers=n)
    if registry.get(arch).family == "encdec":
        cut["enc_layers"] = n
    return cut


def _decode_fn(cfg):
    return encdec.decode_step if cfg.family == "encdec" else lm.decode_step


def _batch(cfg, run: dict, seed: int = 0) -> dict:
    from repro_torch.data.pipeline import DataConfig, TokenSource

    shape = ShapeConfig("mesh", run["seq"], run["batch"], "train")
    return TokenSource(cfg, shape, DataConfig(seed=seed)).batch_at(0)


def mesh_case_decode(mesh, rank, root, shape=(1, 2), ctx=MESH_DECODE["ctx"], arch=ARCH, n_layers=MESH_DECODE["n_layers"]):
    """An f32 decode step on a mesh against the step without one, on a
    stale random cache: logits and caches (the SSM state and conv tail, a
    hybrid's K/V ring, an encoder-decoder model's self cache and cross
    memory).  On (1, 3) qwen's 40 q heads pad to 48 and the 8 kv heads
    take the row-parallel path; the unpadded weights are carried into the
    padded layout (zero padded heads)."""
    from repro_torch.models import carry
    from repro_torch.models.params import shard_full

    m = mesh(shape)
    if m is None:
        return None
    cfg = _f32(arch, **_depth(arch, n_layers))
    step_fn, bundle = steps.make_serve_step(cfg, mesh=m)
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = init_params(steps.model_specs(cfg), gen, "cuda")
    pcfg = bundle["cfg"]
    Hp, gp, g = pcfg.head_padding()
    if Hp != cfg.n_heads:  # the true heads into the padded layout
        attn = w["layers"]["attn"]
        Lc, d, Dh, Hkv = cfg.n_layers, cfg.d_model, cfg.d_head, cfg.n_kv
        for name, view in (("wq", (Lc, d, Hkv, g, Dh)), ("wo", (Lc, Hkv, g, Dh, d)), ("bq", (Lc, Hkv, g, Dh))):
            if name not in attn:
                continue
            t = attn[name].reshape(view)
            axis = 3 if name == "wq" else 2
            pad = list(t.shape)
            pad[axis] = gp - g
            t = torch.cat([t, t.new_zeros(pad)], dim=axis)
            attn[name] = t.reshape(bundle["specs"]["layers"]["attn"][name].shape)
    params = carry.shard_params(w, bundle)
    B = MESH_DECODE["batch"]
    cache_tree = launch_specs.cache_spec_tree(pcfg, ShapeConfig("mesh", ctx, B, "decode"))
    cgen = torch.Generator(device="cuda").manual_seed(1)
    full_cache = {k: 0.5 * torch.randn(s.shape, generator=cgen, device="cuda") for k, s in cache_tree.items()}
    cache = {k: shard_full(v.clone(), m, bundle["rules"].placements(cache_tree[k])) for k, v in full_cache.items()}
    toks = torch.tensor([5, 17, 911, min(151000, cfg.vocab - 1)], dtype=torch.int32, device="cuda")
    pos = torch.tensor([min(p, ctx - 1) for p in MESH_DECODE["pos"]], dtype=torch.int32, device="cuda")
    rules = bundle["rules"]
    bpl = rules.placements_for((B,), ("batch",))
    t_d, p_d = shard_full(toks, m, bpl), shard_full(pos, m, bpl)

    def run():
        return _decode_fn(pcfg)(pcfg, params, cache, t_d, p_d, rules=rules)

    (logits, cache), counts = comm_counts(run)
    logits = logits.full_tensor()
    got_cache = {k: v.full_tensor() for k, v in cache.items()}
    # the same step again, timed (a K/V write lands on the same rows; an
    # SSM state steps once more, after its copy above)
    t0 = time.perf_counter()
    run()[0].full_tensor()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rec = {"ms": ms, "collectives": counts, "launches": mesh_launches()}
    if rank == 0:
        cfg_plain = cfg  # the unpadded model
        w0 = init_params(steps.model_specs(cfg_plain), torch.Generator(device="cuda").manual_seed(0), "cuda")
        want, want_cache = _decode_fn(cfg_plain)(cfg_plain, w0, {k: v.clone() for k, v in full_cache.items()}, toks, pos)
        rec["logits_rel_err"] = rel_err(logits, want)
        rec["cache_rel_err_by_leaf"] = {k: rel_err(got_cache[k], want_cache[k]) for k in want_cache}
        rec["cache_rel_err"] = max(rec["cache_rel_err_by_leaf"].values())
        rec["same_next_tokens"] = bool(torch.equal(logits.argmax(-1), want.argmax(-1)))
        check(rec["logits_rel_err"] <= MESH_RTOL, f"mesh decode {arch} {shape}: logits err {rec['logits_rel_err']}")
        check(rec["cache_rel_err"] <= MESH_RTOL, f"mesh decode {arch} {shape}: cache err {rec['cache_rel_err_by_leaf']}")
    rec.update(shape=list(shape), ctx=ctx, arch=cfg.name, layers=n_layers)
    if "attn" in bundle["specs"].get("layers", {}):
        rec.update(heads=[cfg.n_heads, Hp], kv=repr(bundle["rules"].placements(bundle["specs"]["layers"]["attn"]["wk"])))
    return rec


def mesh_case_grads(mesh, rank, root, arch=ARCH, run=MESH_TRAIN, shape=(1, 2)):
    """An f32 loss and gradient on a mesh against the same without one:
    the loss, and each gradient leaf within MESH_RTOL of its largest
    magnitude; for a MoE model the routing flips (the router logits of
    rank 0 against the unsharded run)."""
    from repro_torch.launch.train import place_batch
    from repro_torch.models import carry

    m = mesh(shape)
    if m is None:
        return None
    cfg = _f32(arch, **_depth(arch, run["n_layers"]))
    _, bundle, _ = steps.jit_train_step(cfg, m, ShapeConfig("mesh", run["seq"], run["batch"], "train"))
    b = _batch(bundle["cfg"], run)
    params = init_params(bundle["specs"], torch.Generator(device="cuda").manual_seed(0), "cuda", rules=bundle["rules"])
    if cfg.family == "encdec":  # its phases' attention init (at_model_fan_in)
        with torch.no_grad():
            at_model_fan_in(params)
    free_cuda()  # the full leaves drawn: the ranks share the card
    moe = cfg.family == "moe"
    batch = place_batch(b, bundle["batch_sh"], "cuda")

    def call():
        return steps.loss_and_grads(bundle["cfg"], params, batch, bundle["rules"])

    with router_logits() as seen:
        (loss, grads), counts = comm_counts(call)
    t0 = time.perf_counter()  # again, timed
    call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rec = {"ms": ms, "collectives": counts, "loss": float(loss), "launches": mesh_launches()}
    grads = carry.gather_params(grads)
    del params
    if rank == 0:
        w0 = init_params(bundle["specs"], torch.Generator(device="cuda").manual_seed(0), "cuda")
        if cfg.family == "encdec":
            at_model_fan_in(w0)
        with router_logits() as seen0:
            loss0, g0 = steps.loss_and_grads(bundle["cfg"], w0, place_batch(b, None, "cuda"))
        rec["loss_rel_err"] = abs(float(loss) - float(loss0)) / abs(float(loss0))
        errs = {"/".join(p): rel_err(a, c) for (p, a), (_, c) in zip(_paths(grads), _paths(g0))}
        rec["grad_rel_err_max"] = max(errs.values())
        rec["grad_rel_err_leaf"] = max(errs, key=errs.get)
        if not moe and rec["grad_rel_err_max"] > MESH_GRAD_ANCHOR:
            rec["grad_from_f64"] = grads_from_f64(bundle["cfg"], w0, b, grads, g0, errs)
        check(rec["loss_rel_err"] <= MESH_LOSS_RTOL, f"mesh {arch} loss err {rec['loss_rel_err']}")
        if moe:
            flips = [routing_flips(a, c, cfg.top_k) for a, c in zip(seen, seen0)]
            rec["routing_flips"] = int(sum(int((f == 1).sum()) for f in flips))
            rec["routing_faults"] = int(sum(int((f == 2).sum()) for f in flips))
            check(rec["routing_faults"] == 0, f"mesh {arch}: routing differs beyond near ties")
        if not moe or rec["routing_flips"] == 0:
            tol = MESH_MOE_RTOL if moe else MESH_RTOL
            check(rec["grad_rel_err_max"] <= tol, f"mesh {arch} grad err {errs}")
    rec.update(shape=list(shape), arch=cfg.name, layers=run["n_layers"], tokens=[run["batch"], run["seq"]])
    return rec


def grads_from_f64(cfg, w0, b, grads, g0, errs, n: int = 3) -> dict:
    """The ``n`` leaves farthest from the one-device gradient, each with
    the mesh's and the one-device step's distance from the same step in
    f64 on the host's CPU (the plain versions; the f32 weights widened):
    ``{leaf: [mesh, one_device]}``, each over the f64 leaf's largest
    magnitude.  Two distances alike say the gap is f32 rounding of a leaf
    whose terms cancel, not the mesh's split."""
    from repro_torch.launch.train import place_batch

    cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64)
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in place_batch(b, None, "cpu").items()}
    _, g64 = steps.loss_and_grads(cfg64, tree_map(lambda t: t.to("cpu", torch.float64), w0), b64)
    mesh_d, one_d, want = (dict(("/".join(p), t) for p, t in _paths(tree)) for tree in (grads, g0, g64))
    worst = sorted(errs, key=errs.get, reverse=True)[:n]
    return {leaf: [rel_err(mesh_d[leaf].cpu(), want[leaf]), rel_err(one_d[leaf].cpu(), want[leaf])] for leaf in worst}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _paths(tree[k], path + (k,))]
    return [(path, tree)]


def mesh_case_serve(mesh, rank, root):
    """bf16 qwen at full depth served on (1, 2): the tokens against the
    one-device server's (the parent's, same seed and prompts) up to the
    first divergence, and the decode step's ms."""
    m = mesh((1, 2))
    if m is None:
        return None
    cfg = registry.get(ARCH)
    server = serve.BatchedServer(cfg, batch=MESH_SERVE["batch"], ctx=MESH_SERVE["ctx"], seed=0, mesh=m)
    logits = first_step_logits(cfg, server)
    want_logits = torch.load(pathlib.Path(root) / "plain_first_logits.pt")
    prompts = mesh_prompts(cfg)[: MESH_GLOO_SERVE["n_requests"]]
    outs, step_ms = mesh_serve(server, prompts, MESH_GLOO_SERVE["max_tokens"])
    want = json.loads((pathlib.Path(root) / "plain_tokens_short.json").read_text())
    rec = {"shape": [1, 2], "dtype": "bfloat16", "n_layers": cfg.n_layers, **MESH_GLOO_SERVE,
           "tokens": len(sum(outs, [])), "agree_by_request": [first_divergence([a], [b]) for a, b in zip(outs, want)],
           "first_step_logits_rel_err": rel_err(logits, want_logits),
           "same_first_step_argmax": bool(torch.equal(logits.argmax(-1), want_logits.argmax(-1))),
           "step_ms_median": statistics.median(step_ms), "init_s": server.init_s, "launches": mesh_launches()}
    # bf16 over 48 layers, the partial sums reduced in another order
    check(rec["first_step_logits_rel_err"] <= 5e-2, f"bf16 mesh logits err {rec['first_step_logits_rel_err']}")
    return rec


def mesh_case_zero(mesh, rank, root):
    """An f32 AdamW step on (2, 2) with ZeRO-1/2 against the step without a
    mesh, its moments at their ZeRO-1 placements; then the parameters
    saved on (2, 2) (a checkpoint of the moments too would treble the
    bytes that cross the host), restored onto (1, 2) and onto one device,
    bitwise the saved logical arrays."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.train import place_batch
    from repro_torch.models import carry

    m22, m12 = mesh((2, 2)), mesh((1, 2))
    cfg = _f32(ARCH, n_layers=MESH_ZERO["n_layers"])
    sh = ShapeConfig("mesh", MESH_ZERO["seq"], MESH_ZERO["batch"], "train")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, eps=1e-2)
    step, bundle, _ = steps.jit_train_step(cfg, m22, sh, opt_cfg)
    b = _batch(bundle["cfg"], MESH_ZERO)
    params = init_params(bundle["specs"], torch.Generator(device="cuda").manual_seed(0), "cuda", rules=bundle["rules"])
    free_cuda()  # the full leaves drawn: four ranks share the card
    opt = adamw.init_state(params, opt_cfg, bundle["opt_sh"]["m"])
    t0 = time.perf_counter()
    (params, opt, metrics), counts = comm_counts(lambda: step(params, opt, place_batch(b, bundle["batch_sh"], "cuda")))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = mesh_launches()
    # the moments at their ZeRO-1 placements, which add "data" to the
    # parameters' wherever it finds a free divisible dim
    placed = [
        (tuple(t.placements), tuple(s.placements), tuple(w.placements))
        for k in ("m", "v")
        for (_, t), (_, s), (_, w) in zip(_paths(opt[k]), _paths(bundle["opt_sh"][k]), _paths(params))
    ]
    check(all(got == want for got, want, _ in placed), "ZeRO-1 moments off their placements")
    check(any(got != w for got, _, w in placed), "ZeRO-1 moments all at the parameters' placements")
    moment_local_gb = sum(t.to_local().numel() * 4 for _, t in _paths(opt["m"])) * 2 / 1e9
    ckdir = pathlib.Path(root) / "ckpt"
    mgr = CheckpointManager(str(ckdir))
    t1 = time.perf_counter()
    mgr.save(0, {"params": params})
    save_s = time.perf_counter() - t1
    full = carry.gather_params(params)  # every rank joins the gathers
    saved = {k: v.cpu() for k, v in _paths(full)} if m12 is not None else None  # ranks 0 and 1 compare
    del params, opt, full
    free_cuda()
    like = {"params": bundle["specs"]}
    rec = {"ms_with_comm_debug": ms, "collectives": counts, "loss": float(metrics["loss"]), "save_s": save_s,
           "moments_local_gb": moment_local_gb, "moment_leaves_apart_from_params": sum(g != w for g, _, w in placed),
           "launches": launches}
    if m12 is not None:
        _, b12, _ = steps.jit_train_step(cfg, m12, sh, opt_cfg)
        got = mgr.restore(0, like, shardings={"params": b12["param_sh"]})
        got = {k: v.cpu() for k, v in _paths(carry.gather_params(got["params"]))}
        rec["restore_12_bitwise"] = all(same_bits(got[k], saved[k]) for k in saved)
        check(rec["restore_12_bitwise"], "checkpoint restored onto (1, 2) differs")
        del got
    free_cuda()  # rank 0's one-device references next
    dist_barrier()
    if rank == 0:
        plain = mgr.restore(0, like, "cuda")
        rec["restore_1_bitwise"] = all(same_bits(v.cpu(), saved[k]) for k, v in _paths(plain["params"]))
        check(rec["restore_1_bitwise"], "checkpoint restored onto one device differs")
        del plain
        free_cuda()
        w0 = init_params(bundle["specs"], torch.Generator(device="cuda").manual_seed(0), "cuda")
        step0, _ = steps.make_train_step(bundle["cfg"], opt_cfg)
        w_init = {k: v.cpu() for k, v in _paths(w0)}
        w0, _, m0 = step0(w0, adamw.init_state(w0, opt_cfg), place_batch(b, None, "cuda"))
        rec["loss_rel_err"] = abs(rec["loss"] - float(m0["loss"])) / abs(float(m0["loss"]))
        errs = {"/".join(k): rel_err(saved[k] - w_init[k], v.cpu() - w_init[k]) for k, v in _paths(w0)}
        rec["update_rel_err_max"] = max(errs.values())
        check(rec["loss_rel_err"] <= MESH_LOSS_RTOL, f"ZeRO step loss err {rec['loss_rel_err']}")
        check(rec["update_rel_err_max"] <= MESH_RTOL, f"ZeRO step update err {errs}")
    rec["shape"] = [2, 2]
    return rec


def free_cuda() -> float:
    """Collect the garbage (autograd graphs and DTensor closures can hold
    tensors in cycles) and empty the allocator's cache, so that the
    processes sharing the card get the memory; the device's free GB."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0] / 1e9


def mesh_launches() -> dict:
    """The kernel launches since the case began (the counts are set to 0
    just before it), read right after its mesh calls and before any
    one-device reference run."""
    return {k: v for k, v in ops.launch_counts().items() if v}


def dist_barrier():
    import torch.distributed as dist

    dist.barrier()


MESH_CASES = [
    ("gloo_decode_1x2", lambda mesh, rank, root: mesh_case_decode(mesh, rank, root)),
    ("gloo_train_1x2", lambda mesh, rank, root: mesh_case_grads(mesh, rank, root)),
    ("gloo_decode_1x3_padded", lambda mesh, rank, root: mesh_case_decode(mesh, rank, root, (1, 3), MESH_PAD_CTX)),
    ("gloo_moe_train_1x2", lambda mesh, rank, root: mesh_case_grads(mesh, rank, root, MOE_ARCH, MESH_MOE)),
    ("gloo_zero_2x2", mesh_case_zero),
    ("gloo_serve_1x2_bf16", mesh_case_serve),
    *(
        (f"gloo_tp_decode_{PHASE_PREFIX[a] or 'qwen_'}{s[0]}x{s[1]}",
         lambda mesh, rank, root, a=a, s=s: mesh_case_decode(mesh, rank, root, s, MESH_DECODE["ctx"], a, TP_TRAIN["n_layers"]))
        for a, s in TP_DECODE
    ),
    *(
        (f"gloo_tp_train_{PHASE_PREFIX[a]}1x2", lambda mesh, rank, root, a=a: mesh_case_grads(mesh, rank, root, a, TP_TRAIN))
        for a in TP_GRADS
    ),
]


def mesh_rank_main(rank: int, world: int, root: str) -> int:
    """One gloo rank of the mesh_models phase (``chip_smoke.py --mesh-rank
    R --mesh-world N --mesh-dir D``): every case, each rank's record to
    ``D/rank{R}.json``; collectives on CUDA tensors are staged through the
    host (``parallel/host_staged.py``)."""
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import host_staged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = pathlib.Path(root) / f"rank{rank}.json"
    rec = {"rank": rank, "ok": False, "cases": {}}
    try:
        dist.init_process_group(host_staged.register(), init_method=f"file://{root}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            def mesh(shape):
                n = shape[0] * shape[1]
                m = DeviceMesh("cuda", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))
                return m if rank < n else None

            for name, fn in MESH_CASES:
                free_gb = free_cuda()
                torch.cuda.reset_peak_memory_stats()
                staged = host_staged.staged
                t0 = time.perf_counter()
                ops.reset_launch_counts()
                r = fn(mesh, rank, root) or {}
                r["wall_s"] = time.perf_counter() - t0
                r["staged_collectives"] = host_staged.staged - staged
                r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                r["device_free_gb_at_start"] = free_gb
                rec["cases"][name] = r
                free_cuda()
                dist.barrier()
            rec["ok"] = True
        finally:
            dist.destroy_process_group()
    except Exception:
        rec["error"] = traceback.format_exc()[-3000:]
    out.write_text(json.dumps(rec))
    return 0 if rec["ok"] else 1


def mesh_nccl_serve(mesh, root: str, parts: dict) -> tuple:
    """qwen2.5-14b served at full depth in bf16 through ``BatchedServer``
    on the 1 x 1 NCCL mesh against the one-device server on the same
    weights; the one-device references of the gloo ranks' serve go to
    ``root``.  The mesh runs' launches, and whether the tokens are
    bitwise."""
    cfg = registry.get(ARCH)
    prompts = mesh_prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    plain = serve.BatchedServer(cfg, batch=MESH_SERVE["batch"], ctx=MESH_SERVE["ctx"], seed=0)
    torch.save(first_step_logits(cfg, plain), pathlib.Path(root) / "plain_first_logits.pt")
    short, _ = mesh_serve(plain, prompts[: MESH_GLOO_SERVE["n_requests"]], MESH_GLOO_SERVE["max_tokens"])
    (pathlib.Path(root) / "plain_tokens_short.json").write_text(json.dumps(short))
    plain.reset()
    plain.step_s.clear()
    want, plain_ms = mesh_serve(plain, prompts)
    meshed = serve.BatchedServer(cfg, batch=MESH_SERVE["batch"], ctx=MESH_SERVE["ctx"], params=plain.params, mesh=mesh)
    del plain
    # the launches of the mesh runs alone, the references outside
    ops.reset_launch_counts()
    got, mesh_ms = mesh_serve(meshed, prompts)
    _, counts = comm_counts(lambda: meshed.decode(1))  # one more step, its collectives
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    same_tokens = got == want  # checked after the gloo cases
    parts["nccl_serve_1x1"] = emit(
        {"phase": "mesh_models", "part": "nccl_serve_1x1", "arch": cfg.name, "backend": "nccl", "ranks": 1,
         "dtype": "bfloat16", "n_layers": cfg.n_layers, **MESH_SERVE, "tokens": len(sum(got, [])),
         "bitwise": same_tokens, "agree_to_first_divergence": first_divergence(got, want),
         "step_ms_median": statistics.median(mesh_ms), "plain_step_ms_median": statistics.median(plain_ms),
         "collectives_per_step": counts, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, same_tokens


def mesh_nccl_moe(mesh, parts: dict, launches: dict) -> None:
    """deepseek-moe-16b's train step at 2 layers in bf16 on the 1 x 1 NCCL
    mesh, on the expert-parallel path, against the one-device step (see
    :func:`mesh_nccl_train`)."""
    mesh_nccl_train(mesh, parts, launches, MOE_ARCH, MESH_MOE, "nccl_moe_train_1x1")


def mesh_nccl_train(mesh, parts: dict, launches: dict, arch: str, run: dict, part: str) -> None:
    """``arch``'s train step at ``run``'s depth in bf16 on the 1 x 1 NCCL
    mesh under "tp" against the one-device step: the loss, every gradient
    and every updated parameter bitwise.  The mesh runs' launches are
    added to ``launches``."""
    from repro_torch.launch.train import place_batch
    from repro_torch.models import carry

    torch.cuda.reset_peak_memory_stats()
    mcfg = dataclasses.replace(registry.get(arch), **_depth(arch, run["n_layers"]))
    sh = ShapeConfig("mesh", run["seq"], run["batch"], "train")
    opt_cfg = adamw.AdamWConfig()
    step, bundle, _ = steps.jit_train_step(mcfg, mesh, sh, opt_cfg)
    b = _batch(mcfg, run)
    w = init_params(bundle["specs"], torch.Generator(device="cuda").manual_seed(0), "cuda")
    w0 = tree_map(lambda t: t.clone(), w)
    params = carry.shard_params(w, bundle)
    opt = adamw.init_state(params, opt_cfg, bundle["opt_sh"]["m"])
    # the mesh runs first, counted: the forward and backward alone (the
    # loss and each gradient), then the step
    g_mesh = place_batch(b, bundle["batch_sh"], "cuda")
    ops.reset_launch_counts()
    loss_m, grads_m = steps.loss_and_grads(bundle["cfg"], params, g_mesh, bundle["rules"])
    t1 = time.perf_counter()
    params, opt, metrics = step(params, opt, g_mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    for k, n in ops.launch_counts().items():
        launches[k] += n
    # the one-device references
    loss_0, grads_0 = steps.loss_and_grads(mcfg, w0, place_batch(b, None, "cuda"))
    grad_diff = {
        "/".join(k): rel_err(x.to_local(), y)
        for (k, x), (_, y) in zip(_paths(grads_m), _paths(grads_0))
        if not same_bits(x.to_local(), y)
    }
    del grads_m, grads_0
    step0, _ = steps.make_train_step(mcfg, opt_cfg)
    w0, _, m0 = step0(w0, adamw.init_state(w0, opt_cfg), place_batch(b, None, "cuda"))
    same = all(same_bits(a.to_local(), c) for (_, a), (_, c) in zip(_paths(params), _paths(w0)))
    same_loss = same_bits(metrics["loss"], m0["loss"]) and same_bits(loss_m, loss_0)
    parts[part] = emit(
        {"phase": "mesh_models", "part": part, "arch": mcfg.name, "backend": "nccl", "ranks": 1,
         "n_layers": mcfg.n_layers, "dtype": "bfloat16", "tokens": [run["batch"], run["seq"]],
         "loss": float(metrics["loss"]), "bitwise_loss": same_loss, "bitwise_params": same,
         "grad_leaves_not_bitwise": len(grad_diff), "grad_leaves": len(_paths(w0)),
         "grad_rel_err_by_leaf": grad_diff, "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(same_loss, f"{mcfg.name}'s 1 x 1 loss is not bitwise the one-device loss")
    check(not grad_diff, f"{mcfg.name}'s 1 x 1 gradients are not bitwise the one-device ones: {grad_diff}")
    check(same, f"{mcfg.name}'s 1 x 1 updated parameters are not bitwise the one-device ones")


def mesh_nccl_tp_serve(mesh, parts: dict, launches: dict) -> bool:
    """mamba2-130m served at full depth in bf16 through
    ``BatchedServer(mesh=)`` on the 1 x 1 NCCL mesh under "tp" (the
    Mamba2 block on its head layout: the projection gathered, the state
    on its heads, the conv tail on its channels) against the one-device
    server on the same weights; the mesh run's launches are added to
    ``launches``.  Whether the tokens are bitwise."""
    cfg = registry.get(SSM_ARCH)
    prompts = mesh_prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    plain = serve.BatchedServer(cfg, batch=MESH_SERVE["batch"], ctx=MESH_SERVE["ctx"], seed=0)
    want, plain_ms = mesh_serve(plain, prompts)
    meshed = serve.BatchedServer(cfg, batch=MESH_SERVE["batch"], ctx=MESH_SERVE["ctx"], params=plain.params, mesh=mesh)
    del plain
    ops.reset_launch_counts()
    got, mesh_ms = mesh_serve(meshed, prompts)
    for k, n in ops.launch_counts().items():
        launches[k] += n
    torch.cuda.synchronize()
    same = got == want
    parts["nccl_tp_serve_1x1"] = emit(
        {"phase": "mesh_models", "part": "nccl_tp_serve_1x1", "arch": cfg.name, "backend": "nccl", "ranks": 1,
         "dtype": "bfloat16", "n_layers": cfg.n_layers, **MESH_SERVE, "tokens": len(sum(got, [])),
         "bitwise": same, "agree_to_first_divergence": first_divergence(got, want),
         "step_ms_median": statistics.median(mesh_ms), "plain_step_ms_median": statistics.median(plain_ms),
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    return same


def dryrun_start(root: str) -> subprocess.Popen:
    """One dry-run cell (DRYRUN_CELL at full size on a fake 16 x 16 world,
    ``python -m repro_torch.launch.dryrun``) in a child process on the
    host's CPU, the card hidden from it; it runs while the card works."""
    arch, shape = DRYRUN_CELL
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", str(pathlib.Path(root) / "dryrun.json")]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    log = open(pathlib.Path(root) / "dryrun.log", "w")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)


def phase_dryrun(proc: subprocess.Popen, root: str, t_start: float) -> dict:
    """The dry-run cell's record: the child must exit 0 within
    DRYRUN_TIMEOUT_S of its start with the cell ``ok``.  The counts are
    rank 0's of 256 fake ranks, counted on the host, not device times."""
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    out = pathlib.Path(root) / "dryrun.json"
    cells = json.loads(out.read_text()) if out.exists() else []
    cell = cells[0] if cells else {"status": "missing"}
    keep = ("arch", "shape", "mesh", "status", "error", "flops", "argument_size", "output_size", "temp_size_counted",
            "coll_bytes", "collectives", "build_s", "run_s")
    rec = emit({"phase": "dryrun", "rc": rc, "torch": torch.__version__, **{k: cell[k] for k in keep if k in cell},
                "log_tail": (pathlib.Path(root) / "dryrun.log").read_text()[-600:] if rc != 0 else ""})
    check(rc == 0 and cell["status"] == "ok", f"the dry-run cell failed: {rec}")
    return rec


def phase_mesh_models() -> dict:
    """The model stack on a mesh: (1) one NCCL rank, a 1 x 1 mesh, in this
    process: qwen2.5-14b served through ``BatchedServer(mesh=)`` at full
    depth in bf16, its tokens bitwise the one-device server's on the same
    weights, and deepseek-moe-16b's train step at 2 layers on the
    expert-parallel path, loss, gradients and parameters bitwise the
    one-device step; (2) MESH_RANKS gloo ranks on the card in one spawn
    (MESH_CASES): f32 decode and train checks on (1, 2), the padded (1, 3)
    decode, the expert-parallel deepseek gradients on (1, 2), ZeRO-1/2
    with an elastic checkpoint on (2, 2), and the bf16 full-depth server
    on (1, 2).  Each part counts its launches around its mesh runs
    alone."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, no network
    parts = {}
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/store", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            launches, same_tokens = mesh_nccl_serve(mesh, root, parts)
            free_cuda()
            mesh_nccl_moe(mesh, parts, launches)
            free_cuda()
            tp_launches = {k: 0 for k in launches}
            tp_same_tokens = mesh_nccl_tp_serve(mesh, parts, tp_launches)
            for arch in (HYBRID_ARCH, ENCDEC_ARCH):
                free_cuda()
                mesh_nccl_train(mesh, parts, tp_launches, arch, TP_NCCL_TRAIN, f"nccl_tp_train_{PHASE_PREFIX[arch]}1x1")
        finally:
            dist.destroy_process_group()
        # the gloo ranks share the card with this process
        free_gb = free_cuda()
        parent_gb = torch.cuda.memory_reserved() / 1e9
        recs = mesh_spawn(root)
    for name in recs[0]["cases"]:
        lead = recs[0]["cases"][name]
        parts[name] = emit({"phase": "mesh_models", "part": name, "backend": "gloo, collectives staged through pinned host memory",
              "ranks": sum(1 for r in recs if r["cases"][name].get("shape")), **lead,
              "peak_gb_by_rank": [r["cases"][name]["peak_gb"] for r in recs],
              "device_free_gb_by_rank": [r["cases"][name]["device_free_gb_at_start"] for r in recs]})
    # the kernels the gloo ranks launched, over every rank and case
    # (the SSM, hybrid and encoder-decoder families' tensor-parallel cases
    # apart)
    gloo = {k: 0 for k in ops.launch_counts()}
    gloo_tp = dict(gloo)
    for r in recs:
        for name, case in r["cases"].items():
            for k, n in case.get("launches", {}).items():
                (gloo_tp if name.startswith("gloo_tp_") else gloo)[k] += n
    tp_seconds = sum(p.get("wall_s", 0.0) for n, p in parts.items() if n.startswith("gloo_tp_"))
    rec = {"phase": "mesh_models", "seconds": time.perf_counter() - t0, "launches": launches, "gloo_launches": gloo,
           "tp_launches": tp_launches, "gloo_tp_launches": gloo_tp, "gloo_tp_seconds": tp_seconds,
           "device_free_gb_at_spawn": free_gb, "parent_reserved_gb_at_spawn": parent_gb}
    emit(rec)
    # the cases' results again, short, for the end of the output
    rec["summary"] = {
        "phase": "mesh_models_summary",
        "seconds": rec["seconds"],
        "device_free_gb_at_spawn": free_gb,
        "parts": {name: {k: v for k, v in r.items() if k in MESH_SUMMARY_KEYS} for name, r in parts.items()},
    }
    check(same_tokens, "the 1 x 1 NCCL server's tokens differ from the one-device server's")
    check(tp_same_tokens, "mamba2's 1 x 1 NCCL server's tokens differ from the one-device server's")
    return rec


# the numbers of each mesh_models case that its summary line repeats
MESH_SUMMARY_KEYS = (
    "bitwise", "bitwise_loss", "bitwise_params", "grad_leaves_not_bitwise", "logits_rel_err", "cache_rel_err",
    "loss_rel_err", "grad_rel_err_max", "grad_rel_err_leaf", "grad_from_f64", "update_rel_err_max", "routing_flips", "restore_12_bitwise",
    "restore_1_bitwise", "first_step_logits_rel_err", "agree_to_first_divergence", "agree_by_request", "ms",
    "ms_with_comm_debug", "step_ms_median", "plain_step_ms_median", "save_s", "wall_s", "staged_collectives",
    "peak_gb", "peak_gb_by_rank", "device_free_gb_by_rank",
)


def first_divergence(got: list, want: list) -> int:
    """How many tokens, request by request, agree before the first that
    differs."""
    n = 0
    for a, b in zip(sum(got, []), sum(want, [])):
        if a != b:
            break
        n += 1
    return n


def mesh_spawn(root: str) -> list:
    procs = []
    for r in range(MESH_RANKS):
        with open(pathlib.Path(root) / f"rank{r}.log", "w") as log:
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r)]
            cmd += ["--mesh-world", str(MESH_RANKS), "--mesh-dir", root]
            # the ranks share one card: segments that grow and shrink keep a
            # rank's freed memory from stranding in its cache
            env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs, failed = [], []
    for r, p in enumerate(procs):
        path = pathlib.Path(root) / f"rank{r}.json"
        rec = json.loads(path.read_text()) if path.exists() else {"ok": False}
        if p.returncode != 0 or not rec["ok"]:
            log = (pathlib.Path(root) / f"rank{r}.log").read_text()[-1000:]
            done = list(rec.get("cases", {}))
            failed.append(f"rank {r} ({p.returncode}) after {done}:\n{rec.get('error')}\nlog: {log}")
        recs.append(rec)
    check(not failed, f"mesh ranks of {MESH_RANKS} failed:\n" + "\n".join(failed))
    return recs


# ---------------------------------------------------------------------------
# the port's examples, the architecture smoke at published widths, and
# granite-moe-1b-a400m
# ---------------------------------------------------------------------------


def _example(name: str):
    """``examples/torch_<name>.py`` of the repository, imported."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"examples.torch_{name}")


def phase_examples(cpu_tokens: int) -> dict:
    """Each of the port's seven examples through its ``main`` on the card
    (the default device): quickstart, cuda_migration, the three-way
    softmax (which launches the softmax kernel), graph_replay and
    streams_overlap at their reference's rounds, the serving example on
    mamba2-130m at full width and depth (its token count equal to the CPU
    driver's) and the training example on it with a checkpoint every 2
    steps.  One line: each example's wall seconds, its launches and what
    it checked."""
    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]
    sv, tr = EXAMPLE_SERVE, EXAMPLE_TRAIN
    ckpt_dir = tempfile.TemporaryDirectory()
    runs = {
        "quickstart": [],
        "cuda_migration": [],
        "cox_kernels_in_models": [],
        "graph_replay": [],
        "streams_overlap": [],
        "serve_batched": [
            "--arch", sv["arch"], "--batch", str(sv["batch"]), "--ctx", str(sv["ctx"]),
            "--requests", str(sv["n_requests"]), "--tokens", str(sv["max_tokens"]),
        ],
        "train_lm": [
            "--arch", tr["arch"], "--steps", str(tr["steps"]), "--batch", str(tr["batch"]),
            "--seq", str(tr["seq"]), "--ckpt-every", str(tr["ckpt_every"]), "--ckpt-dir", ckpt_dir.name,
        ],
    }
    recs = {}
    for name, argv in runs.items():
        mod = _example(name)
        counts0 = ops.launch_counts()
        sync()
        t0 = time.perf_counter()
        out = mod.main(argv + dev)
        sync()
        wall = time.perf_counter() - t0
        launched = {n: c - counts0[n] for n, c in ops.launch_counts().items() if c > counts0[n]}
        rec = {"wall_s": wall, "launches": launched}
        if name == "quickstart":
            check(np.array_equal(out["out"], out["oracle"]), "quickstart: launch != oracle")
            check(out["flat_error"] == "FlatUnsupported", f"quickstart: flat {out['flat_error']}")
            rec["summary"] = out["summary"]
        elif name == "cox_kernels_in_models":
            check(launched.get("softmax", 0) > 0 or DEVICE != "cuda", f"three-way: launches {launched}")
            rec["max_abs_err"] = out["max_abs_err"]
            rec["kernel_max_abs_err"] = float(np.abs(out["kernel"] - out["ref"]).max())
        elif name == "graph_replay":
            check(out["cuda_graph"] or DEVICE != "cuda", "graph_replay: not a torch.cuda.CUDAGraph")
            rec.update({k: out[k] for k in ("eager_ms", "replay_ms", "cuda_graph")})
        elif name == "streams_overlap":
            rec.update({k: out[k] for k in ("serial_ms", "stream_ms", "event_ms")})
        elif name == "serve_batched":
            check(out["completed"] == sv["n_requests"], f"serve_batched: {out['completed']} requests")
            check(out["tokens"] == cpu_tokens, f"serve_batched: {out['tokens']} tokens, CPU {cpu_tokens}")
            rec.update(
                {
                    **sv,
                    "tokens": out["tokens"],
                    "tok_per_s": out["tok_per_s"],
                    "step_ms_median": statistics.median(out["step_s"]) * 1e3,
                }
            )
        elif name == "train_lm":
            losses = out["losses"]
            check(len(losses) == tr["steps"], f"train_lm: {len(losses)} losses")
            check(all(math.isfinite(x) for x in losses), f"train_lm: losses {losses}")
            saves = [e for e in out["ckpt_log"] if e["op"] == "save"]
            rec.update({**tr, "losses": losses, "step_s": out["step_s"], "ckpt_saves": len(saves)})
            del out
        recs[name] = rec
    ckpt_dir.cleanup()
    free_cuda()
    return emit({"phase": "examples", "examples": recs})


def arch_smoke_seq(cfg) -> int:
    """The text tokens of a model's arch-smoke batch: ARCH_SMOKE's, or for
    a VLM the fewest from there on that make its frontend rows and tokens
    a multiple of the attention kernel's 128-row tile (as the reference
    kernel's bq = bk; llava: 2,880 + 64)."""
    S = ARCH_SMOKE["seq"]
    return S + (-(cfg.n_frontend_tokens + S) % fa.BLOCK if cfg.n_frontend_tokens else 0)


def arch_smoke_batch(cfg, gen) -> dict:
    """tests/test_arch_smoke.py's batch on DEVICE: tokens and labels (B, S),
    an encoder-decoder model's S frames, a VLM's frontend rows."""
    B, S = ARCH_SMOKE["batch"], arch_smoke_seq(cfg)
    batch = {
        k: torch.randint(0, cfg.vocab, (B, S), generator=gen, device=DEVICE, dtype=torch.int32)
        for k in ("tokens", "labels")
    }
    rows = S if cfg.family == "encdec" else cfg.n_frontend_tokens
    if rows:
        batch["frontend"] = torch.randn((B, rows, cfg.d_model), generator=gen, device=DEVICE)
    return batch


def phase_arch_smoke() -> dict:
    """tests/test_arch_smoke.py on the card at published widths: every
    registered model cut to 2 layers (an encoder-decoder model 2 + 2), in
    bf16 from the seed, one forward (loss finite and under log(vocab) + 2,
    logits finite, (B, S) rows of at least vocab columns) and one decode
    step over a zero cache (logits finite, the cache's keys and shapes
    kept), one line a model with its ms and launches (llava's text is 64
    tokens: ``arch_smoke_seq``); then the dense and
    SSM models' greedy decode against their teacher-forced forward over 8
    tokens, in f32 with TF32 off, at the reference's rtol = atol = 2e-2."""
    B = ARCH_SMOKE["batch"]
    per_arch = {}
    for arch in registry.names():
        base = registry.get(arch)
        cuts = dict(n_layers=ARCH_SMOKE["n_layers"])
        if base.enc_layers:
            cuts["enc_layers"] = ARCH_SMOKE["n_layers"]
        cfg = dataclasses.replace(base, **cuts)
        S = arch_smoke_seq(cfg)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(steps.model_specs(cfg), gen, DEVICE)
        sync()
        init_s = time.perf_counter() - t0
        batch = arch_smoke_batch(cfg, gen)
        fwd = encdec.forward if cfg.family == "encdec" else lm.forward
        counts0 = ops.launch_counts()
        with torch.no_grad():
            sync()
            t0 = time.perf_counter()
            loss, logits = fwd(cfg, params, batch)
            sync()
            fwd_ms = (time.perf_counter() - t0) * 1e3
        loss = float(loss)
        check(tuple(logits.shape[:2]) == (B, S) and logits.shape[-1] >= cfg.vocab, f"{arch}: logits {tuple(logits.shape)}")
        check(math.isfinite(loss) and loss < math.log(cfg.vocab) + 2.0, f"{arch}: loss {loss}")
        check(bool(torch.isfinite(logits).all()), f"{arch}: forward logits not finite")
        del logits
        ctx = ARCH_SMOKE["ctx"]
        if cfg.family == "encdec":
            specs, decode = encdec.cache_specs(cfg, B, ctx, ARCH_SMOKE["enc_len"]), encdec.decode_step
        else:
            specs, decode = lm.cache_specs(cfg, B, ctx), lm.decode_step
        cache = init_params(specs, None, DEVICE)
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        toks = torch.zeros(B, dtype=torch.int32, device=DEVICE)
        pos = torch.tensor(ARCH_SMOKE["pos"], dtype=torch.int32, device=DEVICE)
        with torch.no_grad():
            sync()
            t0 = time.perf_counter()
            dec, new_cache = decode(cfg, params, cache, toks, pos)
            sync()
            dec_ms = (time.perf_counter() - t0) * 1e3
        check(dec.shape[0] == B and bool(torch.isfinite(dec).all()), f"{arch}: decode logits")
        check({k: tuple(v.shape) for k, v in new_cache.items()} == shapes, f"{arch}: cache structure")
        launched = {n: c - counts0[n] for n, c in ops.launch_counts().items() if c > counts0[n]}
        per_arch[arch] = launched
        emit(
            {
                "phase": "arch_smoke",
                "arch": arch,
                "family": cfg.family,
                "n_layers": cfg.n_layers,
                "enc_layers": cfg.enc_layers,
                "cuts": f"layers {base.n_layers} -> {cfg.n_layers}"
                + (f", encoder {base.enc_layers} -> {cfg.enc_layers}" if base.enc_layers else "")
                + (f"; text tokens {ARCH_SMOKE['seq']} -> {S}: {cfg.n_frontend_tokens:,} + {S} rows, "
                   "whole 128-row attention tiles" if S != ARCH_SMOKE["seq"] else "")
                + "; widths kept",
                "dtype": "bfloat16",
                "batch": B,
                "seq": S,
                "frontend_rows": batch["frontend"].shape[1] if "frontend" in batch else 0,
                "ctx": ctx,
                "loss": loss,
                "log_vocab": math.log(cfg.vocab),
                "forward_ms": fwd_ms,
                "decode_ms": dec_ms,
                "init_s": init_s,
                "launches": launched,
            }
        )
        del params, batch, cache, new_cache, dec
        free_cuda()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    n = ARCH_SMOKE_DECODE["tokens"]
    rtol = ARCH_SMOKE_DECODE["rtol"]
    errs = {}
    for arch in ARCH_SMOKE_DECODE["archs"]:
        cfg = dataclasses.replace(registry.get(arch), n_layers=ARCH_SMOKE["n_layers"], param_dtype=torch.float32)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = init_params(steps.model_specs(cfg), gen, DEVICE)
        toks = torch.randint(0, cfg.vocab, (1, n), generator=gen, device=DEVICE, dtype=torch.int32)
        with torch.no_grad():
            _, full = lm.forward(cfg, params, {"tokens": toks, "labels": toks})
            cache = init_params(lm.cache_specs(cfg, 1, n), None, DEVICE)
            outs = []
            for t in range(n):
                logits, cache = lm.decode_step(cfg, params, cache, toks[:, t], torch.full((1,), t, dtype=torch.int32, device=DEVICE))
                outs.append(logits)
            dec = torch.stack(outs, dim=1)
        ok = torch.allclose(dec, full, rtol=rtol, atol=rtol)
        errs[arch] = float((dec - full).abs().max())
        check(ok, f"arch_smoke {arch}: decode against forward, max abs err {errs[arch]}")
        del params, cache, full, dec, outs
        free_cuda()
    return emit(
        {
            "phase": "arch_smoke_decode_vs_forward",
            "archs": list(errs),
            "n_layers": ARCH_SMOKE["n_layers"],
            "dtype": "float32",
            "tf32": False,
            "tokens": n,
            "rtol": rtol,
            "atol": rtol,
            "max_abs_err": errs,
            "launches_by_arch": per_arch,
        }
    )


def phase_granite_moe(cpu_tokens: int) -> None:
    """granite-moe-1b-a400m, the MoE model with top 8 of 32 experts and no
    shared expert, at full width and depth in bf16: serve_requests at
    batch 4, ctx 128, 4 requests (its token count the CPU driver's, no
    token in the padded columns, its dropped share recorded), then the
    f32 decode and train cross-checks against the CPU, router flips
    allowed only on near ties and counted."""
    phase_serve(cpu_tokens, GRANITE_MOE_ARCH, run=GRANITE_MOE_SERVE)
    free_cuda()
    phase_cross_check(GRANITE_MOE_ARCH)
    free_cuda()
    phase_train_cross_check(GRANITE_MOE_ARCH, kernels=PATH_KERNELS["moe_train"])
    free_cuda()


KERNEL_META = {
    "softmax": ("src/repro_torch/csrc/softmax.cu", "src/repro/kernels/softmax.py:18"),
    "row_reduce": (
        "src/repro_torch/csrc/row_reduce.cu",
        "src/repro/kernels/warp_reduce.py:29",
    ),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/norms.py:19"),
    "flash_decode": (
        "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention.py:114",
    ),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:26",
    ),
    # the gradients have no TPU kernel: "replaces" names the forward's
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:26",
    ),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/norms.py:19"),
    "layernorm": ("src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/norms.py:44"),
    "layernorm_bwd": ("src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/norms.py:44"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:28"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:28"),
}
GRADIENTS = ("flash_attention_bwd", "rmsnorm_bwd", "layernorm_bwd", "ssd_scan_bwd")
TP_TRAIN_KERNELS = (
    "ssd_scan", "ssd_scan_bwd", "rmsnorm", "rmsnorm_bwd", "layernorm", "layernorm_bwd", "flash_attention",
    "flash_attention_bwd",
)
# the kernels each main path must launch
PATH_KERNELS = {
    "cox_serve": ("softmax", "row_reduce", "rmsnorm", "flash_decode"),
    "train": ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd"),
    "ssm_serve": ("rmsnorm",),
    "ssm_train": ("ssd_scan", "ssd_scan_bwd", "rmsnorm", "rmsnorm_bwd"),
    "granite_serve": ("layernorm", "flash_decode"),
    "granite_train": ("layernorm", "layernorm_bwd", "flash_attention", "flash_attention_bwd"),
    "hybrid_serve": ("rmsnorm", "flash_decode"),
    "hybrid_train": (
        "ssd_scan",
        "ssd_scan_bwd",
        "rmsnorm",
        "rmsnorm_bwd",
        "flash_attention",
        "flash_attention_bwd",
    ),
    "moe_serve": ("rmsnorm", "flash_decode"),
    "moe_train": ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd"),
    "vlm_serve": ("rmsnorm", "flash_decode"),
    "vlm_train": ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd"),
    "encdec_serve": ("layernorm", "flash_decode"),
    "encdec_train": ("layernorm", "layernorm_bwd", "flash_attention", "flash_attention_bwd"),
    "ckpt_drill": ("ssd_scan", "ssd_scan_bwd", "rmsnorm", "rmsnorm_bwd"),
    "services_serve": ("rmsnorm", "flash_decode"),
    "services_chaos": ("rmsnorm",),
    "autotune_serve": ("rmsnorm",),
    "mesh_models": ("rmsnorm", "rmsnorm_bwd", "flash_decode", "flash_attention", "flash_attention_bwd"),
    "mesh_models_gloo_ranks": ("rmsnorm", "rmsnorm_bwd", "flash_decode", "flash_attention", "flash_attention_bwd"),
    # the SSM, hybrid and encoder-decoder families under "tp": mamba2's
    # server and the zamba2 and seamless steps on one NCCL rank, then the
    # gloo ranks' decode steps and gradients
    "mesh_models_tp": TP_TRAIN_KERNELS,
    "mesh_models_tp_gloo_ranks": TP_TRAIN_KERNELS + ("flash_decode",),
    # the examples: the three-way softmax, then mamba2's serving and
    # training examples
    "examples": ("softmax", "rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd"),
    "arch_smoke": ("rmsnorm", "layernorm", "flash_attention", "ssd_scan", "flash_decode"),
    # served, then the decode and train cross-checks
    "granite_moe": ("rmsnorm", "flash_decode", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd"),
}


def cpu_token_count(arch: str = ARCH, run: dict = SERVE) -> int:
    """A serve phase's token count from the same driver on the CPU at the
    smoke width: with no EOS every request runs to ctx - 1, so the count
    depends on the batch, context and requests, not the weights."""
    out = serve.serve_requests(arch + "-smoke", device="cpu", **run)
    return out["tokens"]


def main() -> int:
    if "--mesh-rank" in sys.argv:  # one gloo rank of the mesh_models phase
        a = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return mesh_rank_main(int(a["--mesh-rank"]), int(a["--mesh-world"]), a["--mesh-dir"])
    if "--md-rank" in sys.argv:  # one gloo rank of the multidevice phase
        a = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        global DEVICE
        DEVICE = a["--md-device"]
        return md_rank_main(int(a["--md-rank"]), int(a["--md-world"]), a["--md-dir"])
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    headline = phase_kernels(gen)
    headline.update(phase_serving_kernels(gen))
    headline.update(phase_train_kernels(gen))
    headline.update(phase_ssd_kernels(gen))
    headline.update(phase_ln_kernels(gen))
    cpu_tokens = cpu_token_count()
    ssm_cpu_tokens = cpu_token_count(SSM_ARCH)
    granite_cpu_tokens = cpu_token_count(GRANITE_ARCH)
    new_cpu_tokens = {
        a: cpu_token_count(a) for a in (HYBRID_ARCH, MOE_ARCH, VLM_ARCH, ENCDEC_ARCH)
    }
    example_run = {k: v for k, v in EXAMPLE_SERVE.items() if k != "arch"}
    example_cpu_tokens = cpu_token_count(EXAMPLE_SERVE["arch"], example_run)
    granite_moe_cpu_tokens = cpu_token_count(GRANITE_MOE_ARCH, GRANITE_MOE_SERVE)

    # one dry-run cell on a fake world of 256 ranks, on the host's CPU
    # meanwhile (the card hidden from it)
    dry_root = tempfile.TemporaryDirectory()
    dry_t0 = time.perf_counter()
    dry_proc = dryrun_start(dry_root.name)
    atexit.register(lambda: dry_proc.poll() is None and (dry_proc.kill(), dry_proc.wait()))

    # the main paths, each counted alone: COX launches, the three-way
    # checks and the serve phase; the train phase; the SSM serve phase;
    # the SSM train phase; the granite serve phase; the granite train phase
    ops.reset_launch_counts()
    phase_cox(rng)
    phase_three_way(gen)
    serve_rec = phase_serve(cpu_tokens)
    paths = {"cox_serve": ops.launch_counts()}
    ops.reset_launch_counts()
    phase_train()
    paths["train"] = ops.launch_counts()
    ops.reset_launch_counts()
    phase_serve(ssm_cpu_tokens, SSM_ARCH)
    paths["ssm_serve"] = ops.launch_counts()
    ssm_cfg = registry.get(SSM_ARCH)
    ops.reset_launch_counts()
    phase_train(ssm_cfg, SSM_TRAIN)
    paths["ssm_train"] = ops.launch_counts()
    ops.reset_launch_counts()
    phase_serve(granite_cpu_tokens, GRANITE_ARCH)
    paths["granite_serve"] = ops.launch_counts()
    granite_cfg = _train_cfg(GRANITE_ARCH, GRANITE_TRAIN)
    ops.reset_launch_counts()
    phase_train(granite_cfg, GRANITE_TRAIN)
    paths["granite_train"] = ops.launch_counts()
    # the hybrid, MoE, VLM and encoder-decoder families: each model's serve
    # phase, then its train phase, each counted alone
    vlm_serve_cfg = dataclasses.replace(registry.get(VLM_ARCH), n_layers=VLM_SERVE_LAYERS)
    vlm_cuts = (
        f"layers 60 -> {VLM_SERVE_LAYERS}: the dense family's decode step, which qwen "
        "and granite run at full depth"
    )
    # (arch, serve config, its cuts, train config, train run)
    new_paths = [
        (HYBRID_ARCH, registry.get(HYBRID_ARCH), "none", registry.get(HYBRID_ARCH), HYBRID_TRAIN),
        (MOE_ARCH, registry.get(MOE_ARCH), "none", _train_cfg(MOE_ARCH, MOE_TRAIN), MOE_TRAIN),
        (VLM_ARCH, vlm_serve_cfg, vlm_cuts, _train_cfg(VLM_ARCH, VLM_TRAIN), VLM_TRAIN),
        (
            ENCDEC_ARCH,
            registry.get(ENCDEC_ARCH),
            "none",
            registry.get(ENCDEC_ARCH),
            ENCDEC_TRAIN,
        ),
    ]
    for arch, serve_cfg, serve_cuts, train_cfg, run in new_paths:
        ops.reset_launch_counts()
        phase_serve(new_cpu_tokens[arch], serve_cfg, serve_cuts)
        paths[PHASE_PREFIX[arch] + "serve"] = ops.launch_counts()
        if train_cfg.family == "encdec":
            phase_reference_init(train_cfg, run)
        ops.reset_launch_counts()
        phase_train(train_cfg, run)
        paths[PHASE_PREFIX[arch] + "train"] = ops.launch_counts()
    # checkpoint and restart
    ops.reset_launch_counts()
    phase_ckpt_drill()
    paths["ckpt_drill"] = ops.launch_counts()
    # the runtime services: COX on streams and graphs, then the serving
    # paths that ride them (postprocess kernels, the captured token
    # pipeline, the fault drill)
    phase_services(rng)
    ops.reset_launch_counts()
    phase_services_serve(cpu_tokens, serve_rec)
    paths["services_serve"] = ops.launch_counts()
    ops.reset_launch_counts()
    phase_services_chaos(ssm_cpu_tokens)
    paths["services_chaos"] = ops.launch_counts()
    # the measured tuner, buffer donation and the counted cost model, then
    # the serving path that tunes its postprocess launches
    phase_autotune(rng)
    phase_donate()
    phase_costmodel(rng)
    ops.reset_launch_counts()
    phase_autotune_serve(ssm_cpu_tokens)
    paths["autotune_serve"] = ops.launch_counts()
    # COX on a pool of devices: sharded launches over NCCL and gloo ranks,
    # and streams placed over logical devices (no hand-written kernel)
    phase_multidevice()
    # the model stack on a mesh: one NCCL rank, then gloo ranks on the card
    # (it sets the counts to 0 and reads them around its mesh runs alone)
    mesh_rec = phase_mesh_models()
    paths["mesh_models"] = mesh_rec["launches"]
    paths["mesh_models_gloo_ranks"] = mesh_rec["gloo_launches"]
    paths["mesh_models_tp"] = mesh_rec["tp_launches"]
    paths["mesh_models_tp_gloo_ranks"] = mesh_rec["gloo_tp_launches"]
    # the dry run's cell, started at the beginning on the host's CPU
    dry_rec = phase_dryrun(dry_proc, dry_root.name, dry_t0)

    phase_wrapper_host(gen, serve_rec)
    phase_serve_profile()
    phase_train_profile()
    phase_serve_profile(SSM_ARCH)
    phase_train_profile(ssm_cfg, SSM_TRAIN)
    # the other families' profiles are left out to keep the script in
    # time: the dense and SSM paths' above cover every decode and train
    # kernel but layernorm's, which granite's and seamless's phases time
    # the f32 cross-checks run in full f32: TF32 off for matmuls (PyTorch's
    # default) and for cuDNN (on by default), stated in their lines
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_cross_check()
    phase_train_cross_check()
    phase_cross_check(SSM_ARCH)
    phase_train_cross_check(SSM_ARCH)
    phase_cross_check(GRANITE_ARCH)
    phase_train_cross_check(GRANITE_ARCH)
    for arch in (HYBRID_ARCH, MOE_ARCH, VLM_ARCH, ENCDEC_ARCH):
        phase_cross_check(arch)
        phase_train_cross_check(arch)
    # the port's examples, the architecture smoke at published widths and
    # granite-moe-1b-a400m, each counted alone
    ops.reset_launch_counts()
    phase_examples(example_cpu_tokens)
    paths["examples"] = ops.launch_counts()
    ops.reset_launch_counts()
    phase_arch_smoke()
    paths["arch_smoke"] = ops.launch_counts()
    ops.reset_launch_counts()
    phase_granite_moe(granite_moe_cpu_tokens)
    paths["granite_moe"] = ops.launch_counts()
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(paths[path][name] > 0, f"{name} was not launched on the {path} path")
    emit(mesh_rec["summary"])
    emit({"phase": "dryrun_summary", **{k: dry_rec.get(k) for k in ("arch", "shape", "mesh", "status", "run_s", "torch")}})
    dry_root.cleanup()
    kernels = []
    for name, rec in headline.items():
        source, replaces = KERNEL_META[name]
        by_path = {p: counts[name] for p, counts in paths.items()}
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "role": "gradient (no TPU kernel)" if name in GRADIENTS else "forward",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "shape": rec["shape"],
                "dtype": rec.get("dtype"),
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
            }
        )
        for key in ("lse_ms", "lse_max_abs_err"):
            if key in rec:
                kernels[-1][key] = rec[key]
        if "bound_3xtf32_ms" in rec:
            kernels[-1]["bound_3xtf32_ms"] = rec["bound_3xtf32_ms"]
            kernels[-1]["bound_3xtf32_by"] = rec["bound_3xtf32_by"]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(dev["nvidia_smi"], flush=True)
    device = {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
