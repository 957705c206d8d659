# fmt: off
"""Grid-barrier phase splitting — cooperative ``this_grid().sync()``.

The paper stops at block scope: COX's hierarchical collapsing has no
answer for a grid-wide barrier (Table 1's grid-sync ✗ rows), because its
pthread-per-block runtime would need every block resident and spinning.
Our schedule is functional, which makes the feature tractable: a grid
barrier is a *program split*.  The kernel body is cut at every top-level
``Barrier(GRID)`` into **phases**; each phase is an ordinary kernel
compiled by the unchanged hierarchical-collapsing pipeline, and the
launcher runs the phase executables in sequence with

* **global memory** carried from phase to phase (every block of phase
  *p+1* observes every write of phase *p* — exactly the grid barrier's
  guarantee), and
* **per-block persistent state** — locals that live across the sync
  (CUDA: registers/local memory persist for the thread's lifetime) and
  shared memory (persists for the block's lifetime) — threaded through
  as per-block carries (``(n_warps, W)`` planes for locals, the flat
  shared buffers for shared memory).

Alignment rule: a grid barrier must be reached by **every thread of
every block the same number of times** (CUDA cooperative launch makes a
misaligned grid sync a deadlock).  We enforce the static form of that
contract: grid syncs may only appear at the top level of the kernel
body — never inside ``if``/``while``/``for`` — so the phase count is a
compile-time constant and every block runs the same phase sequence.
"""
from __future__ import annotations

from typing import List, Sequence, Set

from . import kernel_ir as K
from .types import BarrierLevel, CoxUnsupported, ScalarSpec


def _is_grid_barrier(s: K.Stmt) -> bool:
    return isinstance(s, K.Barrier) and s.level == BarrierLevel.GRID


def validate_grid_syncs(kernel: K.Kernel) -> None:
    """Reject grid barriers inside control flow — the static alignment
    contract above.  A sync under ``if (blockIdx.x == 0)`` would have
    block 0 waiting at a barrier the other blocks never reach (deadlock
    on CUDA, UB at best); a sync inside a loop would need a dynamic
    phase count.  Both get a clear error instead of a wrong answer."""
    def rec(stmts: Sequence[K.Stmt], ctx: str):
        for s in stmts:
            if _is_grid_barrier(s) and ctx:
                raise CoxUnsupported(
                    f"grid_sync inside {ctx}: a grid-wide barrier must be "
                    f"reached by every thread of every block the same "
                    f"number of times (CUDA cooperative-launch alignment), "
                    f"so grid syncs are only supported at the top level of "
                    f"the kernel body — hoist the sync out of the "
                    f"conditional (e.g. keep the divergent work inside the "
                    f"branch and sync unconditionally after it)")
            if isinstance(s, K.If):
                rec(s.then_body, "divergent control flow (if)")
                rec(s.else_body, "divergent control flow (if)")
            elif isinstance(s, K.While):
                rec(s.body, "a loop body (dynamic phase count)")
    rec(kernel.body, "")


def split_phases(kernel: K.Kernel) -> List[K.Kernel]:
    """Cut the kernel body at top-level grid barriers into per-phase
    kernels.  A kernel with no grid sync returns ``[kernel]`` unchanged
    (the identity — single-phase programs compile exactly as before).
    Phase kernels share the original's params/shared specs and statement
    objects (type annotations made on the full kernel carry over)."""
    validate_grid_syncs(kernel)
    bodies: List[List[K.Stmt]] = [[]]
    for s in kernel.body:
        if _is_grid_barrier(s):
            bodies.append([])
        else:
            bodies[-1].append(s)
    if len(bodies) == 1:
        return [kernel]
    for body in bodies[:-1]:
        if any(isinstance(s, K.Return) for s in body):
            raise CoxUnsupported(
                "return before a grid_sync: a thread that exits cannot "
                "reach the grid barrier (cooperative-launch deadlock)")
    return [K.Kernel(f"{kernel.name}.phase{i}", kernel.params, kernel.shared,
                     body, source=kernel.source)
            for i, body in enumerate(bodies)]


# ---------------------------------------------------------------------------
# Cross-phase liveness
# ---------------------------------------------------------------------------


def _stmt_names(stmts: Sequence[K.Stmt], out: Set[str]) -> None:
    """Every local-variable name a statement list touches (reads or
    writes), descending into nested control flow."""
    def expr(e):
        if e is not None:
            out.update(K.expr_vars(e))

    for s in stmts:
        if isinstance(s, K.Assign):
            out.add(s.name)
            expr(s.value)
        elif isinstance(s, (K.StoreGlobal, K.StoreShared)):
            expr(s.index)
            expr(s.value)
        elif isinstance(s, K.AtomicRMW):
            expr(s.index)
            expr(s.value)
            if s.dst:
                out.add(s.dst)
        elif isinstance(s, K.WarpCall):
            if s.dst:
                out.add(s.dst)
            for a in s.args:
                expr(a)
        elif isinstance(s, K.If):
            expr(s.cond)
            _stmt_names(s.then_body, out)
            _stmt_names(s.else_body, out)
        elif isinstance(s, K.While):
            expr(s.cond)
            _stmt_names(s.body, out)


def carried_locals(kernel: K.Kernel, phase_kernels: Sequence[K.Kernel]
                   ) -> Set[str]:
    """Locals that must persist across phase boundaries: any variable
    name appearing in more than one phase.  (Conservative — a name
    reused as an unrelated temp in two phases is carried too; that only
    costs a ``(n_warps, W)`` plane in the carry, never correctness.)
    Scalar params are block-uniform inputs, not carried state."""
    uniforms = {p.name for p in kernel.params if isinstance(p, ScalarSpec)}
    per_phase: List[Set[str]] = []
    for pk in phase_kernels:
        names: Set[str] = set()
        _stmt_names(pk.body, names)
        per_phase.append(names - uniforms)
    carried: Set[str] = set()
    seen: Set[str] = set()
    for names in per_phase:
        carried |= names & seen
        seen |= names
    return carried
