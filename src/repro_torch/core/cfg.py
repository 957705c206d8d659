# fmt: off
"""Control-flow graph for the COX pass pipeline.

The unit the paper's LLVM pass operates on.  Invariants guaranteed by
``lower.py`` (mirroring LLVM loop-simplify / lowerswitch, paper §3.3.3):

* every branch is two-way; every ``Br`` block is *pure* (no instructions —
  the paper's ``if.cond`` rule: "only a single conditional-branch
  instruction, no side effects"), and carries the barrier *level* of the
  construct that produced it (warp / block) for hierarchical-PR formation;
* every loop is canonical: single latch, header dominates exits;
* single entry block, single exit block;
* barrier-free divergent control flow never reaches the CFG — it is
  predicated inside straight-line instructions (``kernel_ir.If/While``
  nested in a block's instruction list), so every CFG branch condition is
  warp-uniform (block-uniform for block-level branches) under the paper's
  aligned-barrier assumption (§2.2.3).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Set

from . import kernel_ir as K
from .types import BarrierLevel, CoxUnsupported

# ----------------------------------------------------------------------------
# CFG-only instructions (products of warp-intrinsic lowering, paper §3.2)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class WarpBufStore:
    """Each lane stores its operand into the 32-wide warp buffer
    (the paper's ``@warp_vote[tx] = flag``)."""
    buf: str
    value: K.Expr

    def __repr__(self):
        return f"@{self.buf}[lane] = {self.value}"


@dataclasses.dataclass
class WarpBufCompute:
    """Collective read of the warp buffer (the paper's ``warp_all`` /
    shuffle read — AVX on x86, VPU lane ops here)."""
    dst: str
    func: str           # shfl_down/up/xor/idx, vote_all/any, ballot, red_*
    buf: str
    args: List[K.Expr]  # offset / src-lane / none
    width: int = 0      # static tile width (cooperative groups); 0 = warp

    def __repr__(self):
        return f"{self.dst} = {self.func}(@{self.buf}, {self.args})"


# ----------------------------------------------------------------------------
# Terminators
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Br:
    cond: str                      # name of a b1 variable (pure block rule)
    true: str
    false: str
    level: BarrierLevel = BarrierLevel.WARP  # peel level of this branch

    def targets(self):
        return [self.true, self.false]


@dataclasses.dataclass
class Jmp:
    target: str

    def targets(self):
        return [self.target]


@dataclasses.dataclass
class Ret:
    def targets(self):
        return []


# ----------------------------------------------------------------------------
# Blocks and graph
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Block:
    name: str
    instrs: List = dataclasses.field(default_factory=list)
    term: object = None  # Br | Jmp | Ret

    def ends_with_barrier(self, level: Optional[BarrierLevel] = None) -> bool:
        if not self.instrs or not isinstance(self.instrs[-1], K.Barrier):
            return False
        if level is None:
            return True
        return self.instrs[-1].level >= level

    def has_barrier(self) -> bool:
        return any(isinstance(i, K.Barrier) for i in self.instrs)

    def is_pure_branch(self) -> bool:
        return isinstance(self.term, Br) and not self.instrs


class CFG:
    def __init__(self, name: str):
        self.name = name
        self.blocks: "OrderedDict[str, Block]" = OrderedDict()
        self.entry: str = ""
        self.exit: str = ""
        self._ctr = 0

    # ------------- construction -------------

    def new_block(self, hint: str = "bb") -> Block:
        self._ctr += 1
        b = Block(f"{hint}.{self._ctr}")
        self.blocks[b.name] = b
        return b

    def add_block(self, b: Block):
        self.blocks[b.name] = b

    # ------------- topology -------------

    def succs(self, name: str) -> List[str]:
        return list(self.blocks[name].term.targets())

    def preds(self, name: str) -> List[str]:
        return [b for b, blk in self.blocks.items() if name in blk.term.targets()]

    def pred_map(self) -> Dict[str, List[str]]:
        m: Dict[str, List[str]] = {b: [] for b in self.blocks}
        for b, blk in self.blocks.items():
            for t in blk.term.targets():
                m[t].append(b)
        return m

    def rpo(self) -> List[str]:
        seen: Set[str] = set()
        post: List[str] = []

        def dfs(n: str):
            stack = [(n, iter(self.succs(n)))]
            seen.add(n)
            while stack:
                node, it = stack[-1]
                advanced = False
                for s in it:
                    if s not in seen:
                        seen.add(s)
                        stack.append((s, iter(self.succs(s))))
                        advanced = True
                        break
                if not advanced:
                    post.append(node)
                    stack.pop()

        dfs(self.entry)
        return list(reversed(post))

    def verify(self):
        assert self.entry in self.blocks and self.exit in self.blocks
        reach = set(self.rpo())
        for name, blk in self.blocks.items():
            if blk.term is None:
                raise CoxUnsupported(f"block {name} missing terminator")
            for t in blk.term.targets():
                if t not in self.blocks:
                    raise CoxUnsupported(f"block {name} branches to unknown {t}")
            if isinstance(blk.term, Br) and blk.instrs:
                raise CoxUnsupported(
                    f"branch block {name} is not pure (paper's if.cond rule)")
        if self.exit not in reach:
            raise CoxUnsupported("exit unreachable")

    # ------------- dominators (Cooper-Harvey-Kennedy iterative) -------------

    def _idoms(self, reverse: bool) -> Dict[str, Optional[str]]:
        if reverse:
            root = self.exit
            preds = {b: self.succs(b) for b in self.blocks}   # reversed edges
            order_src = self._rpo_reverse()
        else:
            root = self.entry
            preds = self.pred_map()
            order_src = self.rpo()
        index = {b: i for i, b in enumerate(order_src)}
        idom: Dict[str, Optional[str]] = {b: None for b in order_src}
        idom[root] = root

        def intersect(a: str, b: str) -> str:
            while a != b:
                while index[a] > index[b]:
                    a = idom[a]  # type: ignore
                while index[b] > index[a]:
                    b = idom[b]  # type: ignore
            return a

        changed = True
        while changed:
            changed = False
            for b in order_src:
                if b == root:
                    continue
                new = None
                for p in preds[b]:
                    if p in index and idom.get(p) is not None:
                        new = p if new is None else intersect(new, p)
                if new is not None and idom[b] != new:
                    idom[b] = new
                    changed = True
        idom[root] = None
        return idom

    def _rpo_reverse(self) -> List[str]:
        seen: Set[str] = set()
        post: List[str] = []
        pm = self.pred_map()

        def dfs(n: str):
            stack = [(n, iter(pm[n]))]
            seen.add(n)
            while stack:
                node, it = stack[-1]
                advanced = False
                for s in it:
                    if s not in seen:
                        seen.add(s)
                        stack.append((s, iter(pm[s])))
                        advanced = True
                        break
                if not advanced:
                    post.append(node)
                    stack.pop()

        dfs(self.exit)
        return list(reversed(post))

    def dom_tree(self) -> "DomTree":
        return DomTree(self._idoms(reverse=False), self.entry)

    def postdom_tree(self) -> "DomTree":
        return DomTree(self._idoms(reverse=True), self.exit)

    # ------------- mutation helpers -------------

    def split_after(self, name: str, idx: int, hint: str = "split") -> str:
        """Split block so instrs[:idx+1] stay, rest + terminator move to a
        new block (paper §3.4: split before/after each barrier)."""
        blk = self.blocks[name]
        nb = self.new_block(hint)
        nb.instrs = blk.instrs[idx + 1:]
        nb.term = blk.term
        blk.instrs = blk.instrs[: idx + 1]
        blk.term = Jmp(nb.name)
        if self.exit == name:
            self.exit = nb.name
        return nb.name

    def dump(self) -> str:
        lines = [f"cfg {self.name} entry={self.entry} exit={self.exit}"]
        for name, blk in self.blocks.items():
            lines.append(f"  {name}:")
            for i in blk.instrs:
                lines.append(f"    {i}")
            lines.append(f"    -> {blk.term}")
        return "\n".join(lines)


class DomTree:
    def __init__(self, idom: Dict[str, Optional[str]], root: str):
        self.idom = idom
        self.root = root

    def dominates(self, a: str, b: str) -> bool:
        """True iff a dominates b (or post-dominates, for a PDT)."""
        cur: Optional[str] = b
        while cur is not None:
            if cur == a:
                return True
            cur = self.idom.get(cur)
        return False

    def strictly_dominates(self, a: str, b: str) -> bool:
        return a != b and self.dominates(a, b)
