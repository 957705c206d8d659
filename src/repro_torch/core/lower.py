# fmt: off
"""Structured kernel IR → CFG.

The decision point of the whole pipeline (see DESIGN.md §2): a
conditional construct becomes

* a **real CFG branch** iff its body contains a barrier (explicit, or
  implicit via a warp collective).  Its condition must then be uniform at
  the barrier's level — the paper's aligned-barrier assumption — and the
  branch is later *peeled* (lane 0 / warp 0 evaluates, the rest follow).
  The emitted branch block is pure (paper's ``if.cond`` rule); the
  condition is evaluated by *all* threads in the preceding block so side
  effects are preserved (paper §2.3, bullet 2).

* **predicated straight-line code** otherwise: the structured ``If`` /
  ``While`` node stays nested inside a basic block's instruction list and
  the executor evaluates it under an active-lane mask.  This is the
  whole-function-vectorization role clang plays for the paper's output.

Loops are emitted in canonical form (preheader → header(cond eval) →
cond-branch → body…latch → header), the shape LLVM's loop-simplify
guarantees the paper (§3.3.2/§3.3.3).
"""
from __future__ import annotations

from typing import List

from . import kernel_ir as K
from .cfg import CFG, Block, Br, Jmp, Ret
from .types import BarrierLevel, CoxUnsupported


class _Lowerer:
    def __init__(self, kernel: K.Kernel):
        self.kernel = kernel
        self.cfg = CFG(kernel.name)
        self._tmp = 0

    def fresh(self) -> str:
        self._tmp += 1
        return f".c{self._tmp}"

    def run(self) -> CFG:
        entry = self.cfg.new_block("entry")
        self.cfg.entry = entry.name
        exit_b = self.cfg.new_block("exit")
        exit_b.term = Ret()
        self.cfg.exit = exit_b.name

        last = self.lower_stmts(self.kernel.body, entry)
        if last.term is None:
            last.term = Jmp(exit_b.name)
        self.cfg.verify()
        return self.cfg

    # ------------------------------------------------------------------
    def lower_stmts(self, stmts: List[K.Stmt], cur: Block) -> Block:
        """Lower into `cur`; return the block where control continues."""
        for i, s in enumerate(stmts):
            if cur.term is not None:
                # unreachable code after a Return
                raise CoxUnsupported("statements after return are unreachable")
            if isinstance(s, K.Barrier) and s.level == BarrierLevel.GRID:
                # the region machine may not collapse across a grid
                # barrier: compile_kernel phase-splits (repro.core.phases)
                # before lowering, so one reaching the CFG is a misuse of
                # the low-level API
                raise CoxUnsupported(
                    "grid barrier reached CFG lowering: grid_sync kernels "
                    "must be phase-split first (compile via "
                    "repro.core.execute.compile_kernel, which handles it)")
            if isinstance(s, K.Return):
                if i != len(stmts) - 1:
                    raise CoxUnsupported("return must be the last statement")
                cur.term = Jmp(self.cfg.exit)
            elif isinstance(s, K.If):
                cur = self.lower_if(s, cur)
            elif isinstance(s, K.While):
                cur = self.lower_while(s, cur)
            else:
                # Straight-line instruction (Assign / stores / Barrier /
                # WarpCall / AtomicRMW) — appended as-is.
                cur.instrs.append(s)
        return cur

    # ------------------------------------------------------------------
    def lower_if(self, s: K.If, cur: Block) -> Block:
        level = K.subtree_barrier_level(s.then_body + s.else_body)
        if level == BarrierLevel.GRID:
            raise CoxUnsupported(
                "grid_sync inside divergent control flow — a grid barrier "
                "must be reached uniformly by the whole grid (see "
                "repro.core.phases.validate_grid_syncs)")
        if level is None:
            self._check_predicable(s.then_body)
            self._check_predicable(s.else_body)
            cur.instrs.append(s)  # predicated in-place
            return cur
        # Barrier-bearing: real branch.  Evaluate the condition in the head
        # (all threads, side effects preserved), branch from a pure block.
        cond_tmp = self.fresh()
        cur.instrs.append(K.Assign(cond_tmp, s.cond))
        condbr = self.cfg.new_block("if.cond")
        cur.term = Jmp(condbr.name)

        join = self.cfg.new_block("if.exit")
        then_entry = self.cfg.new_block("if.then")
        t_end = self.lower_stmts(s.then_body, then_entry)
        if t_end.term is None:
            t_end.term = Jmp(join.name)
        if s.else_body:
            else_entry = self.cfg.new_block("if.else")
            e_end = self.lower_stmts(s.else_body, else_entry)
            if e_end.term is None:
                e_end.term = Jmp(join.name)
            condbr.term = Br(cond_tmp, then_entry.name, else_entry.name, level)
        else:
            condbr.term = Br(cond_tmp, then_entry.name, join.name, level)
        return join

    # ------------------------------------------------------------------
    def lower_while(self, s: K.While, cur: Block) -> Block:
        level = K.subtree_barrier_level(s.body)
        if level == BarrierLevel.GRID:
            raise CoxUnsupported(
                "grid_sync inside a loop body — the phase count must be "
                "static (see repro.core.phases.validate_grid_syncs)")
        if level is None:
            self._check_predicable(s.body)
            cur.instrs.append(s)  # masked loop, executed in-place
            return cur
        cond_tmp = self.fresh()
        header = self.cfg.new_block("loop.header")
        condbr = self.cfg.new_block("loop.cond")
        exit_b = self.cfg.new_block("loop.exit")
        body_entry = self.cfg.new_block("loop.body")

        cur.term = Jmp(header.name)                       # cur is the preheader
        header.instrs.append(K.Assign(cond_tmp, s.cond))  # evaluated by all threads
        header.term = Jmp(condbr.name)
        condbr.term = Br(cond_tmp, body_entry.name, exit_b.name, level)

        latch = self.lower_stmts(s.body, body_entry)
        if latch.term is None:
            latch.term = Jmp(header.name)                 # single back edge
        else:
            raise CoxUnsupported("loop body must fall through to the latch")
        return exit_b

    # ------------------------------------------------------------------
    def _check_predicable(self, body: List[K.Stmt]):
        for s in body:
            if isinstance(s, K.Return):
                raise CoxUnsupported("return inside divergent control flow")
            if isinstance(s, K.If):
                self._check_predicable(s.then_body)
                self._check_predicable(s.else_body)
            elif isinstance(s, K.While):
                self._check_predicable(s.body)


def lower_kernel(kernel: K.Kernel) -> CFG:
    return _Lowerer(kernel).run()
