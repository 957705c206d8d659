# fmt: off
"""Forward type inference over the structured kernel IR.

C-like model: a variable's type is fixed by its first assignment
(promoted if later assignments disagree — monotone, so the fixpoint
converges in ≤ |lattice| passes).  Assignments coerce the RHS to the
variable's type at execution, matching C assignment semantics.
"""
from __future__ import annotations

from typing import Dict, List

from . import kernel_ir as K
from .types import ArraySpec, CoxTypeError, DType, ScalarSpec, promote

_INT_PRESERVING = {"//", "%", "&", "|", "^", "<<", ">>"}


class TypeEnv:
    def __init__(self, kernel: K.Kernel):
        self.var: Dict[str, DType] = {}
        self.arrays: Dict[str, DType] = {}
        self.shared: Dict[str, DType] = {}
        for p in kernel.params:
            if isinstance(p, ArraySpec):
                self.arrays[p.name] = p.dtype
            elif isinstance(p, ScalarSpec):
                self.var[p.name] = p.dtype
        for s in kernel.shared:
            self.shared[s.name] = s.dtype

    def merge(self, name: str, dt: DType):
        cur = self.var.get(name)
        self.var[name] = dt if cur is None else promote(cur, dt)


def infer_expr(e: K.Expr, env: TypeEnv) -> DType:
    if isinstance(e, K.Const):
        if e.dtype is None:
            e.dtype = (DType.b1 if isinstance(e.value, bool)
                       else DType.i32 if isinstance(e.value, int) else DType.f32)
        return e.dtype
    if isinstance(e, K.Var):
        dt = env.var.get(e.name)
        e.dtype = dt if dt is not None else e.dtype or DType.i32
        return e.dtype
    if isinstance(e, K.Special):
        e.dtype = DType.i32
        return e.dtype
    if isinstance(e, K.BinOp):
        lt, rt = infer_expr(e.lhs, env), infer_expr(e.rhs, env)
        if e.op == "/":
            e.dtype = promote(promote(lt, rt), DType.f32)
        elif e.op in _INT_PRESERVING and not (lt.is_float or rt.is_float):
            e.dtype = promote(lt, rt)
        else:
            e.dtype = promote(lt, rt)
        return e.dtype
    if isinstance(e, K.CmpOp):
        infer_expr(e.lhs, env)
        infer_expr(e.rhs, env)
        e.dtype = DType.b1
        return e.dtype
    if isinstance(e, K.BoolOp):
        for a in e.args:
            infer_expr(a, env)
        e.dtype = DType.b1
        return e.dtype
    if isinstance(e, K.UnOp):
        it = infer_expr(e.operand, env)
        if e.op in ("f32", "i32", "f16", "bf16", "u32"):
            e.dtype = DType(e.op)
        elif e.op == "not":
            e.dtype = DType.b1
        elif e.op in ("exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid"):
            e.dtype = promote(it, DType.f32)
        elif e.op == "floor":
            e.dtype = promote(it, DType.f32)
        else:  # neg abs
            e.dtype = it
        return e.dtype
    if isinstance(e, K.Select):
        infer_expr(e.cond, env)
        t = infer_expr(e.on_true, env)
        f = infer_expr(e.on_false, env)
        e.dtype = promote(t, f)
        return e.dtype
    if isinstance(e, K.LoadGlobal):
        infer_expr(e.index, env)
        e.dtype = env.arrays[e.array]
        return e.dtype
    if isinstance(e, K.LoadShared):
        infer_expr(e.index, env)
        e.dtype = env.shared[e.array]
        return e.dtype
    raise CoxTypeError(f"cannot infer {e!r}")


def _infer_stmts(body: List[K.Stmt], env: TypeEnv):
    for s in body:
        if isinstance(s, K.Assign):
            env.merge(s.name, infer_expr(s.value, env))
        elif isinstance(s, (K.StoreGlobal, K.StoreShared)):
            infer_expr(s.index, env)
            infer_expr(s.value, env)
        elif isinstance(s, K.AtomicRMW):
            infer_expr(s.index, env)
            infer_expr(s.value, env)
            if s.dst:
                env.merge(s.dst, env.arrays[s.array])
        elif isinstance(s, K.WarpCall):
            for a in s.args:
                infer_expr(a, env)
            if s.func in ("vote_all", "vote_any"):
                dt = DType.b1
            elif s.func == "ballot":
                dt = DType.u32
            else:  # shfl_*, red_*
                dt = s.args[0].dtype or DType.f32
            if s.dst:
                env.merge(s.dst, dt)
        elif isinstance(s, K.If):
            infer_expr(s.cond, env)
            _infer_stmts(s.then_body, env)
            _infer_stmts(s.else_body, env)
        elif isinstance(s, K.While):
            infer_expr(s.cond, env)
            _infer_stmts(s.body, env)
        elif isinstance(s, (K.Barrier, K.Return)):
            pass
        else:
            raise CoxTypeError(f"cannot type stmt {s!r}")


def infer(kernel: K.Kernel) -> Dict[str, DType]:
    """Run to fixpoint; return var -> dtype.  Expr nodes are annotated
    in place on the final pass."""
    env = TypeEnv(kernel)
    for _ in range(4):
        before = dict(env.var)
        _infer_stmts(kernel.body, env)
        if env.var == before:
            break
    _infer_stmts(kernel.body, env)  # final annotate with stable env
    return dict(env.var)
