# fmt: off
"""Structured kernel IR.

The frontend lowers a restricted-Python CUDA-style kernel into this IR.
It plays the role NVVM IR plays in the paper's pipeline (Fig. 3): the
input to the hierarchical-collapsing transformation.  It is structured
(statement trees, not a flat CFG) because the frontend owns the source;
``lower.py`` flattens it into the CFG that the paper's algorithms
(extra-barrier insertion, block splitting, Alg. 1/2) operate on.

Expressions are pure; statements carry all effects.  Thread-varying
semantics: every expression conceptually evaluates once per CUDA thread;
the executor vectorizes a warp's 32 evaluations into one lane-vector op
(the paper's AVX mapping, here the TPU VPU lane axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from .types import BarrierLevel, DType

# ----------------------------------------------------------------------------
# Expressions
# ----------------------------------------------------------------------------


class Expr:
    dtype: Optional[DType] = None  # filled by type inference


@dataclasses.dataclass
class Const(Expr):
    value: Any
    dtype: Optional[DType] = None

    def __repr__(self):
        return f"{self.value}"


@dataclasses.dataclass
class Var(Expr):
    name: str
    dtype: Optional[DType] = None

    def __repr__(self):
        return self.name


@dataclasses.dataclass
class BinOp(Expr):
    op: str  # + - * / // % & | ^ << >> min max pow
    lhs: Expr
    rhs: Expr
    dtype: Optional[DType] = None

    def __repr__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclasses.dataclass
class CmpOp(Expr):
    op: str  # < <= > >= == !=
    lhs: Expr
    rhs: Expr
    dtype: Optional[DType] = None  # always b1

    def __repr__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclasses.dataclass
class BoolOp(Expr):
    op: str  # and or
    args: List[Expr] = dataclasses.field(default_factory=list)
    dtype: Optional[DType] = None

    def __repr__(self):
        return f" {self.op} ".join(map(str, self.args))


@dataclasses.dataclass
class UnOp(Expr):
    op: str  # neg not abs exp log sqrt rsqrt tanh sigmoid floor f32 i32
    operand: Expr
    dtype: Optional[DType] = None

    def __repr__(self):
        return f"{self.op}({self.operand})"


@dataclasses.dataclass
class Select(Expr):
    cond: Expr
    on_true: Expr
    on_false: Expr
    dtype: Optional[DType] = None

    def __repr__(self):
        return f"select({self.cond}, {self.on_true}, {self.on_false})"


@dataclasses.dataclass
class Special(Expr):
    """Thread-identity intrinsics: tid, lane, wid, bid, bdim, gdim, wsize.

    tid/bid/bdim/gdim carry a dim3 ``axis`` ('x' default, so bare calls
    keep their 1-D meaning): the executor decomposes the *linear*
    thread/block id against the launch's static extents, x-fastest
    (``x = lin % dim.x``, ``y = lin // dim.x % dim.y``,
    ``z = lin // (dim.x * dim.y)``).  lane/wid/wsize are axis-less —
    warps are a property of the linearized thread order, as on CUDA.
    """
    kind: str
    dtype: Optional[DType] = None  # i32
    axis: str = "x"

    def __repr__(self):
        suffix = "" if self.axis == "x" else f".{self.axis}"
        return f"%{self.kind}{suffix}"


@dataclasses.dataclass
class LoadGlobal(Expr):
    array: str
    index: Expr
    dtype: Optional[DType] = None

    def __repr__(self):
        return f"{self.array}[{self.index}]"


@dataclasses.dataclass
class LoadShared(Expr):
    array: str
    index: Expr
    dtype: Optional[DType] = None

    def __repr__(self):
        return f"@{self.array}[{self.index}]"


# ----------------------------------------------------------------------------
# Statements
# ----------------------------------------------------------------------------


class Stmt:
    pass


@dataclasses.dataclass
class Assign(Stmt):
    name: str
    value: Expr

    def __repr__(self):
        return f"{self.name} = {self.value}"


@dataclasses.dataclass
class StoreGlobal(Stmt):
    array: str
    index: Expr
    value: Expr

    def __repr__(self):
        return f"{self.array}[{self.index}] = {self.value}"


@dataclasses.dataclass
class AtomicRMW(Stmt):
    """atomicAdd/atomicMax/... — beyond the paper (COX has no atomics)."""
    op: str  # add max min
    array: str
    index: Expr
    value: Expr
    dst: Optional[str] = None  # old value, if captured

    def __repr__(self):
        return f"atomic_{self.op} {self.array}[{self.index}], {self.value}"


@dataclasses.dataclass
class StoreShared(Stmt):
    array: str
    index: Expr
    value: Expr

    def __repr__(self):
        return f"@{self.array}[{self.index}] = {self.value}"


@dataclasses.dataclass
class Barrier(Stmt):
    level: BarrierLevel
    # 'source' distinguishes programmer barriers from the transformer's
    # extra barriers and from RAW/WAR barriers of warp-intrinsic lowering.
    source: str = "explicit"

    def __repr__(self):
        return f"barrier.{self.level.value}<{self.source}>"


@dataclasses.dataclass
class WarpCall(Stmt):
    """A warp-level collective: shfl_down/up/xor/idx, vote_all/any, ballot,
    and tile<N> variants (static cooperative groups).

    Lowered by ``passes.lower_warp_intrinsics`` into
    store→sync(RAW)→compute→sync(WAR) (paper §3.2, Code 5).
    """
    func: str          # shfl_down | shfl_up | shfl_xor | shfl_idx |
                       # vote_all | vote_any | ballot | red_add | red_max | red_min
    dst: Optional[str]
    args: List[Expr]
    width: int = 0     # 0 → full warp; else static tile size (coop groups)

    def __repr__(self):
        w = f"<{self.width}>" if self.width else ""
        return f"{self.dst} = {self.func}{w}({', '.join(map(str, self.args))})"


@dataclasses.dataclass
class If(Stmt):
    cond: Expr
    then_body: List[Stmt]
    else_body: List[Stmt] = dataclasses.field(default_factory=list)

    def __repr__(self):
        return f"if {self.cond}: [{len(self.then_body)}] else [{len(self.else_body)}]"


@dataclasses.dataclass
class While(Stmt):
    """Canonical loop (paper §3.3.2): single latch; for-range loops are
    lowered to this form by the frontend (LLVM loop-simplify analogue)."""
    cond: Expr
    body: List[Stmt]
    # For frontend-known trip counts (range loops with static bounds) the
    # executor's JIT mode may fully unroll:
    static_trip: Optional[int] = None
    induction: Optional[Tuple[str, Expr, Expr]] = None  # (var, init, step)

    def __repr__(self):
        return f"while {self.cond}: [{len(self.body)}]"


@dataclasses.dataclass
class Return(Stmt):
    def __repr__(self):
        return "return"


# ----------------------------------------------------------------------------
# Kernel container
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Kernel:
    name: str
    params: List[Any]                # ArraySpec | ScalarSpec, in order
    shared: List[Any]                # SharedSpec
    body: List[Stmt]
    source: str = ""

    def walk(self):
        """Yield every statement, depth-first."""
        def rec(stmts):
            for s in stmts:
                yield s
                if isinstance(s, If):
                    yield from rec(s.then_body)
                    yield from rec(s.else_body)
                elif isinstance(s, While):
                    yield from rec(s.body)
        yield from rec(self.body)


def subtree_barrier_level(stmts: Sequence[Stmt]) -> Optional[BarrierLevel]:
    """Highest barrier level contained in a statement list (incl. implicit
    barriers from warp collectives), or None.  Drives the lower.py decision
    between *predication* (barrier-free divergence) and *real CFG branches*
    (peelable, per the paper's aligned-barrier assumption)."""
    level: Optional[BarrierLevel] = None

    def up(lvl: BarrierLevel):
        nonlocal level
        if level is None or lvl.rank > level.rank:
            level = lvl

    def rec(body):
        for s in body:
            if isinstance(s, Barrier):
                up(s.level)
            elif isinstance(s, WarpCall):
                up(BarrierLevel.WARP)
            elif isinstance(s, If):
                rec(s.then_body)
                rec(s.else_body)
            elif isinstance(s, While):
                rec(s.body)
    rec(stmts)
    return level


def uses_grid_sync(k: Kernel) -> bool:
    """True when the kernel contains a grid-wide barrier (cooperative
    ``this_grid().sync()``) — the signal that compilation must phase-split
    (``repro.core.phases``) before the collapsing pipeline runs."""
    return any(isinstance(s, Barrier) and s.level == BarrierLevel.GRID
               for s in k.walk())


def uses_warp_features(k: Kernel) -> bool:
    """Feature detector for hybrid mode (paper §5.2.1): flat collapsing is
    used unless warp-level functions / warp barriers are present."""
    for s in k.walk():
        if isinstance(s, WarpCall):
            return True
        if isinstance(s, Barrier) and s.level == BarrierLevel.WARP:
            return True
    return False


def expr_children(e: Expr) -> List[Expr]:
    if isinstance(e, BinOp):
        return [e.lhs, e.rhs]
    if isinstance(e, CmpOp):
        return [e.lhs, e.rhs]
    if isinstance(e, BoolOp):
        return list(e.args)
    if isinstance(e, UnOp):
        return [e.operand]
    if isinstance(e, Select):
        return [e.cond, e.on_true, e.on_false]
    if isinstance(e, (LoadGlobal, LoadShared)):
        return [e.index]
    return []


def expr_vars(e: Expr) -> set:
    out = set()
    stack = [e]
    while stack:
        cur = stack.pop()
        if isinstance(cur, Var):
            out.add(cur.name)
        stack.extend(expr_children(cur))
    return out
