# fmt: off
"""Flat collapsing — the prior-art baseline (MCUDA / POCL / DPC semantics,
paper §2.1) and the hybrid dispatcher (paper §5.2.1).

Flat collapsing wraps each (block-level) Parallel Region in a single loop
of length block_size.  It is realized here by running the hierarchical
pipeline with ``warp_size == block_size`` (one "warp" covering the whole
block): the inter-warp loop degenerates to one iteration and every PR is
a single vectorized loop — exactly the flat output shape, Fig. 1(b).

Faithful to the coverage story (Table 1), flat collapsing REJECTS kernels
that use warp-level features: a single block-wide loop cannot represent
warp-scoped barriers (the paper's Code 2 shows why patching them in is
intractable).  ``supports_flat`` is the feature detector; hybrid mode
uses flat when possible (it is ~13% faster on warp-free kernels, Fig. 12)
and hierarchical collapsing otherwise.
"""
from __future__ import annotations

from typing import Optional

from . import kernel_ir as K
from .types import BarrierLevel, CoxUnsupported


class FlatUnsupported(CoxUnsupported):
    """The kernel needs hierarchical collapsing (warp-level features)."""


def flat_rejection_reason(kernel: K.Kernel) -> Optional[str]:
    """Why flat collapsing cannot compile this kernel (None = it can).
    Mirrors the ✗ rows of the paper's Table 1 for POCL-class frameworks."""
    for s in kernel.walk():
        if isinstance(s, K.WarpCall):
            if s.width and s.width != 32:
                return (f"static cooperative-group tile<{s.width}> "
                        f"({s.func}) — sub-warp collective")
            return f"warp-level collective {s.func} (implicit warp barriers)"
        if isinstance(s, K.Barrier) and s.level == BarrierLevel.WARP:
            return "explicit __syncwarp() — warp-scoped barrier"
    return None


def supports_flat(kernel: K.Kernel) -> bool:
    return flat_rejection_reason(kernel) is None


def check_flat(kernel: K.Kernel):
    reason = flat_rejection_reason(kernel)
    if reason is not None:
        raise FlatUnsupported(
            f"flat collapsing cannot express kernel '{kernel.name}': {reason}")


def choose_collapse(kernel: K.Kernel, requested: str = "hybrid") -> str:
    """'hybrid' (default, paper §5.2.1): flat when the kernel has no
    warp-level features, hierarchical otherwise."""
    if requested == "flat":
        check_flat(kernel)
        return "flat"
    if requested == "hier":
        return "hier"
    if requested != "hybrid":
        raise ValueError(f"unknown collapse mode {requested}")
    return "flat" if supports_flat(kernel) else "hier"


# ---------------------------------------------------------------------------
# Launch-level dispatch: grid-execution backend + execution mode.
# Same shape as choose_collapse: an explicit request is validated and
# honored; 'auto' applies the heuristic.
# ---------------------------------------------------------------------------

_BACKENDS = ("scan", "vmap", "sharded")


def captures_atomic_old(kernel: K.Kernel) -> bool:
    """True when any AtomicRMW captures the pre-op value (the atomicAdd
    ticket pattern).  Such kernels observe atomic *intermediate* state —
    old values are unique only under serial execution, so the
    delta-merge backends (vmap/sharded) cannot reproduce them."""
    return any(isinstance(s, K.AtomicRMW) and s.dst for s in kernel.walk())


def choose_backend(kernel: K.Kernel, *, grid: int, mesh=None,
                   requested: str = "auto") -> str:
    """Pick a grid-execution backend (paper §4's one-pthread-per-block,
    reinterpreted for XLA).

    Heuristic (kernel features + grid size): a mesh forces ``sharded``
    (blocks dealt over devices, psum merge); a multi-block grid takes
    ``vmap`` (chunks of blocks run simultaneously) when the kernel has
    enough per-block internal work for batching to pay — shared-memory
    tiles or atomics (measured on the coverage suite: ~2.9x on tiled
    matmul, ~1x on tree reductions/histograms) — while pure streaming
    SPMD kernels stay on ``scan``, whose loop-carried trace fuses into
    one pass over global memory that block-batching cannot beat; a
    single-block grid always degenerates to ``scan`` (nothing to
    parallelize, and the loop-carried path skips mask tracking).

    Kernels that capture atomic old values (:func:`captures_atomic_old`)
    stay on ``scan``: captured old values are only unique under serial
    execution, and the delta-merge backends would silently hand every
    block the same ticket.  An *explicit* vmap/sharded request for such
    a kernel is rejected at backend build time — as is any launch with
    a mesh (a mesh forces ``sharded``, whose merge cannot reproduce
    ticket semantics; drop the mesh to run these kernels).
    """
    if requested != "auto":
        if requested not in _BACKENDS:
            raise ValueError(f"unknown launch backend {requested!r}; "
                             f"available: {_BACKENDS + ('auto',)}")
        if requested == "sharded" and mesh is None:
            raise ValueError("backend='sharded' needs a mesh")
        if requested != "sharded" and mesh is not None:
            raise ValueError(f"a mesh was given but backend={requested!r}; "
                             "use backend='sharded' (or 'auto')")
        return requested
    if mesh is not None:
        return "sharded"
    if grid <= 1 or captures_atomic_old(kernel):
        return "scan"
    if K.uses_grid_sync(kernel):
        # cooperative launches pin the chunk schedule to one all-resident
        # wave and merge global memory at every phase boundary, so the
        # vmap wave pays grid× copies of globals per phase; measured
        # ~10x against the loop-carried scan on the sweep's gridReduce.
        # Explicit backend='vmap'/mesh requests are still honored.
        return "scan"
    blockwise_work = bool(kernel.shared) or \
        any(isinstance(s, K.AtomicRMW) for s in kernel.walk())
    return "vmap" if blockwise_work else "scan"


def choose_mode(kernel: K.Kernel, *, n_warps: int,
                requested: str = "auto") -> str:
    """Resolve the execution mode ('auto' is the default, end to end
    from ``api.launch``).  'auto' burns the block size in (jit mode:
    inter-warp loop unrolled) only when the block is a single warp —
    there the unrolled form has no loop at all and no bloat; for wider
    blocks the fori-loop 'normal' mode traces smaller programs and the
    paper's Fig-13 JIT advantage does not transfer to XLA."""
    if requested in ("normal", "jit"):
        return requested
    if requested != "auto":
        raise ValueError(f"unknown mode {requested!r}")
    return "jit" if n_warps == 1 else "normal"


# ---------------------------------------------------------------------------
# Warp-execution dispatch: serial inter-warp loop vs batched (n_warps, W)
# lane plane.  Same shape again: explicit requests validated and honored,
# 'auto' applies the heuristic.
# ---------------------------------------------------------------------------

# per-block budget for the batched plane's per-warp shared-memory copies
# (shmem bytes × n_warps): CUDA shared memory tops out around 100 KiB
# per block and n_warps ≤ 32, so real kernels always fit — the budget
# guards synthetic giant-shmem kernels from exploding the vmap footprint
WARP_BATCH_SHMEM_BUDGET = 4 << 20


def shared_footprint(kernel: K.Kernel) -> int:
    """Static shared-memory bytes per block."""
    total = 0
    for s in kernel.shared:
        n = 1
        for d in s.shape:
            n *= int(d)
        total += n * s.dtype.itemsize
    return total


def choose_warp_exec(kernel: K.Kernel, *, n_warps: int,
                     requested: str = "auto", machine=None) -> str:
    """Resolve how warps run within each block-level PR.

    'batched' exposes the warp axis to XLA: all warps of a PR run as
    one (n_warps, W) lane plane (``jax.vmap`` over the warp-level
    machine walk), multiplying the parallelism the compiler sees —
    grid-chunk × warps × lanes.  'serial' is the paper's Code 3
    inter-warp loop.

    Heuristic ('auto', measured on the coverage suite — BENCH_PR2.json):
    batch when the block has more than one warp, the kernel keeps
    per-block state in **shared memory** (the blockwise-internal-work
    signal, same as ``choose_backend``'s vmap test), the per-warp
    shared-memory copies fit the size budget (``shared_footprint ×
    n_warps ≤ WARP_BATCH_SHMEM_BUDGET``), and — when the caller
    supplies the compiled ``machine`` — the warp graphs are peel-free:
    a batched PC machine must run *every* ``lax.switch`` branch and
    select per warp, which loses to the serial loop's one-branch
    dispatch (0.4x on peel-heavy warp reductions).  The payoff scales
    with how much non-fusable per-warp work a PR holds: ~1.5x on a
    collective-dense shared kernel at 8 warps (2x with the scalar
    collective backend, whose per-lane loop ops the plane divides by
    n_warps), roughly parity on gather-bound tiled matmul.  Pure
    streaming/vote kernels stay serial: their per-PR lane work is too
    small to amortize the per-warp copy + merge.

    Kernels that capture atomic old values (:func:`captures_atomic_old`)
    stay serial — captured old values are only unique under a serial
    warp order, exactly the scan-only argument one level up — and an
    explicit 'batched' request for such a kernel is rejected.
    """
    if requested == "batched":
        if captures_atomic_old(kernel):
            raise CoxUnsupported(
                f"kernel '{kernel.name}' captures atomic old values "
                f"(atomic_add_old): old values are only unique under a "
                f"serial warp order, which warp-batched execution "
                f"cannot reproduce — use warp_exec='serial'")
        return requested
    if requested == "serial":
        return requested
    if requested != "auto":
        raise ValueError(f"unknown warp_exec {requested!r}; "
                         f"expected 'serial', 'batched' or 'auto'")
    if n_warps <= 1 or captures_atomic_old(kernel):
        return "serial"
    if not kernel.shared:
        return "serial"
    if shared_footprint(kernel) * n_warps > WARP_BATCH_SHMEM_BUDGET:
        return "serial"
    if machine is not None:
        from .regions import warp_peel_count
        # a tuple/list means per-phase machines (cooperative grid-sync
        # kernels): any peel-heavy phase keeps the whole launch serial
        machines = (machine if isinstance(machine, (tuple, list))
                    else (machine,))
        if any(warp_peel_count(m) > 0 for m in machines):
            return "serial"
    return "batched"
