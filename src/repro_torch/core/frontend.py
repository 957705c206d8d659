# fmt: off
"""Python-AST frontend: restricted-Python CUDA-style kernels → kernel IR.

Plays the role of Clang/NVVM in the paper's pipeline (Fig. 3).  Kernels
are written as Python functions whose first parameter is the COX context
(thread intrinsics); remaining parameters are annotated global arrays or
scalars:

    @cox.kernel
    def reduce(c, out: cox.Array(cox.f32), val: cox.Array(cox.f32)):
        tid = c.thread_idx()
        v = val[tid]
        if tid < 32:
            offset = 16
            while offset > 0:
                v += c.shfl_down(v, offset)
                offset //= 2
        if tid == 0:
            out[0] = v

Canonicalization guarantees (the paper leans on LLVM loop-simplify /
lowerswitch — §3.3.3): every loop this frontend emits has a single latch
and a loop-header condition; every branch is two-way.
"""
from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
from typing import Any, Dict, List, Optional

from . import kernel_ir as K
from .types import (ArraySpec, BarrierLevel, CoxUnsupported, DType,
                    ScalarSpec, SharedSpec)


# ----------------------------------------------------------------------------
# Parameter annotations (public, re-exported from api)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Array:
    """Annotation for a global-memory pointer parameter."""
    dtype: DType = DType.f32


# Scalar annotations are DType members themselves (cox.i32, cox.f32, ...).


_WARP_FUNCS = {
    "shfl_down": "shfl_down",
    "shfl_up": "shfl_up",
    "shfl_xor": "shfl_xor",
    "shfl": "shfl_idx",
    "vote_all": "vote_all",
    "all_sync": "vote_all",
    "vote_any": "vote_any",
    "any_sync": "vote_any",
    "ballot": "ballot",
    "red_add": "red_add",
    "red_max": "red_max",
    "red_min": "red_min",
}

_SPECIALS = {
    "thread_idx": "tid",
    "lane_id": "lane",
    "warp_id": "wid",
    "block_idx": "bid",
    "block_dim": "bdim",
    "grid_dim": "gdim",
    "warp_size": "wsize",
}

# dim3 intrinsics accept an axis; bare calls mean 'x' (CUDA's .x), so
# every 1-D kernel is untouched.  lane/wid/wsize are axis-less: warps
# are a property of the x-fastest linearized thread order.
_DIM3_KINDS = ("tid", "bid", "bdim", "gdim")

# CUDA-style per-axis shorthands: c.tid_y() == c.thread_idx('y')
_AXIS_ALIASES = {
    f"{kind}_{ax}": (kind, ax)
    for kind in _DIM3_KINDS for ax in ("x", "y", "z")
}

_UNARY_MATH = {"exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid", "floor", "abs", "neg"}
_CASTS = {"f32": DType.f32, "i32": DType.i32, "f16": DType.f16,
          "bf16": DType.bf16, "u32": DType.u32}

_DTYPE_BY_NAME = {d.value: d for d in DType}


class _Parser(ast.NodeVisitor):
    def __init__(self, ctx_name: str, arrays: Dict[str, ArraySpec],
                 scalars: Dict[str, ScalarSpec], closure: Dict[str, Any]):
        self.ctx = ctx_name
        self.arrays = arrays
        self.scalars = scalars
        self.closure = closure          # captured Python constants
        self.shared: Dict[str, SharedSpec] = {}
        self._tmp = 0

    # ---------------- helpers ----------------

    def fresh(self, hint="t") -> str:
        self._tmp += 1
        return f".{hint}{self._tmp}"

    def err(self, node, msg) -> CoxUnsupported:
        return CoxUnsupported(f"line {getattr(node, 'lineno', '?')}: {msg}")

    def _is_ctx_call(self, node) -> Optional[str]:
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == self.ctx):
            return node.func.attr
        return None

    # ---------------- expressions ----------------

    def expr(self, node) -> K.Expr:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return K.Const(bool(node.value), DType.b1)
            if isinstance(node.value, int):
                return K.Const(int(node.value), DType.i32)
            if isinstance(node.value, float):
                return K.Const(float(node.value), DType.f32)
            raise self.err(node, f"unsupported constant {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in self.scalars:
                return K.Var(node.id, self.scalars[node.id].dtype)
            if node.id in self.closure:
                v = self.closure[node.id]
                if isinstance(v, bool):
                    return K.Const(bool(v), DType.b1)
                if isinstance(v, int):
                    return K.Const(int(v), DType.i32)
                if isinstance(v, float):
                    return K.Const(float(v), DType.f32)
                raise self.err(node, f"closure var {node.id} has unsupported type {type(v)}")
            return K.Var(node.id)
        if isinstance(node, ast.BinOp):
            op = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
                  ast.FloorDiv: "//", ast.Mod: "%", ast.BitAnd: "&",
                  ast.BitOr: "|", ast.BitXor: "^", ast.LShift: "<<",
                  ast.RShift: ">>"}.get(type(node.op))
            if op is None:
                raise self.err(node, f"unsupported binop {type(node.op).__name__}")
            return K.BinOp(op, self.expr(node.left), self.expr(node.right))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return K.UnOp("neg", self.expr(node.operand))
            if isinstance(node.op, ast.Not):
                return K.UnOp("not", self.expr(node.operand))
            raise self.err(node, "unsupported unary op")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise self.err(node, "chained comparisons unsupported")
            op = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
                  ast.Eq: "==", ast.NotEq: "!="}.get(type(node.ops[0]))
            if op is None:
                raise self.err(node, "unsupported comparison")
            return K.CmpOp(op, self.expr(node.left), self.expr(node.comparators[0]))
        if isinstance(node, ast.BoolOp):
            op = "and" if isinstance(node.op, ast.And) else "or"
            return K.BoolOp(op, [self.expr(v) for v in node.values])
        if isinstance(node, ast.IfExp):
            return K.Select(self.expr(node.test), self.expr(node.body),
                            self.expr(node.orelse))
        if isinstance(node, ast.Subscript):
            return self._load(node)
        if isinstance(node, ast.Call):
            return self._call_expr(node)
        raise self.err(node, f"unsupported expression {type(node).__name__}")

    def _linearize(self, arr_name: str, idxs: List[K.Expr], node) -> K.Expr:
        """Row-major linearization of per-axis indices against a shared
        array's static shape (the CUDA `tile[y][x]` address math)."""
        shape = self.shared[arr_name].shape
        if len(idxs) != len(shape):
            raise self.err(node, "index rank mismatch")
        flat: K.Expr = idxs[0]
        for dim, ix in zip(shape[1:], idxs[1:]):
            flat = K.BinOp("+", K.BinOp("*", flat, K.Const(int(dim), DType.i32)), ix)
        return flat

    def _index(self, arr_name: str, node) -> K.Expr:
        """Indices: 1-D for globals (CUDA pointer semantics); shared arrays
        with known shape accept tuple indices, linearized here."""
        if isinstance(node, ast.Tuple):
            if arr_name not in self.shared:
                raise self.err(node, "multi-dim index only on shared arrays")
            return self._linearize(arr_name,
                                   [self.expr(e) for e in node.elts], node)
        return self.expr(node)

    def _subscript_chain(self, node: ast.Subscript):
        """Peel a chained subscript — ``tile[ty][tx]`` (the CUDA 2-D
        shared-array spelling) — into ``(name, [axis index nodes])``.
        A plain ``name[idx]`` yields a single-element chain."""
        idx_nodes = []
        cur: ast.expr = node
        while isinstance(cur, ast.Subscript):
            idx_nodes.append(cur.slice)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            raise self.err(node, "only name[index] (optionally chained, "
                                 "e.g. tile[ty][tx]) supported")
        return cur.id, list(reversed(idx_nodes))

    def _subscript_index(self, node: ast.Subscript):
        """Resolve a load/store target subscript (plain, tuple, or
        chained) to ``(array name, linear index expr)``."""
        name, chain = self._subscript_chain(node)
        if len(chain) == 1:
            return name, self._index(name, chain[0])
        # chained subscripts: CUDA's `tile[ty][tx]` on a static 2-D/3-D
        # shared tile, lowered to the same row-major linearization as
        # the tuple form `tile[ty, tx]`
        if name not in self.shared:
            raise self.err(node, f"chained subscripts ({name}[i][j]) are "
                                 f"only supported on shared arrays with a "
                                 f"static shape (globals are 1-D CUDA "
                                 f"pointers — linearize the index)")
        if any(isinstance(c, ast.Tuple) for c in chain):
            raise self.err(node, "mixing tuple and chained subscripts "
                                 "is unsupported — write tile[ty][tx] or "
                                 "tile[ty, tx]")
        return name, self._linearize(name, [self.expr(c) for c in chain],
                                     node)

    def _load(self, node: ast.Subscript) -> K.Expr:
        name, idx = self._subscript_index(node)
        if name in self.shared:
            return K.LoadShared(name, idx, self.shared[name].dtype)
        if name in self.arrays:
            return K.LoadGlobal(name, idx, self.arrays[name].dtype)
        raise self.err(node, f"unknown array {name}")

    def _call_expr(self, node: ast.Call) -> K.Expr:
        attr = self._is_ctx_call(node)
        if attr is None:
            # builtins
            if isinstance(node.func, ast.Name) and node.func.id in ("min", "max"):
                if len(node.args) != 2:
                    raise self.err(node, "min/max take 2 args")
                return K.BinOp(node.func.id, self.expr(node.args[0]), self.expr(node.args[1]))
            if isinstance(node.func, ast.Name) and node.func.id == "abs":
                return K.UnOp("abs", self.expr(node.args[0]))
            if isinstance(node.func, ast.Name) and node.func.id == "float":
                return K.UnOp("f32", self.expr(node.args[0]))
            if isinstance(node.func, ast.Name) and node.func.id == "int":
                return K.UnOp("i32", self.expr(node.args[0]))
            raise self.err(node, "unsupported call")
        if attr in _AXIS_ALIASES:
            kind, axis = _AXIS_ALIASES[attr]
            if node.args or node.keywords:
                raise self.err(node, f"{attr}() takes no arguments "
                                     f"(the axis is in the name)")
            return K.Special(kind, DType.i32, axis)
        if attr in _SPECIALS:
            kind = _SPECIALS[attr]
            axis = "x"
            if node.args or node.keywords:
                if node.keywords or len(node.args) != 1:
                    raise self.err(node, f"{attr}() takes at most one "
                                         f"positional axis argument")
                if kind not in _DIM3_KINDS:
                    raise self.err(node, f"{attr}() takes no axis argument "
                                         f"(lane/warp ids are axis-less)")
                a0 = node.args[0]
                if not (isinstance(a0, ast.Constant)
                        and a0.value in ("x", "y", "z")):
                    raise self.err(node, f"{attr}() axis must be a literal "
                                         f"'x', 'y' or 'z'")
                axis = a0.value
            return K.Special(kind, DType.i32, axis)
        if attr in _CASTS:
            return K.UnOp(attr, self.expr(node.args[0]), _CASTS[attr])
        if attr in _UNARY_MATH:
            return K.UnOp(attr, self.expr(node.args[0]))
        if attr in ("min", "max"):
            return K.BinOp(attr, self.expr(node.args[0]), self.expr(node.args[1]))
        if attr == "select":
            return K.Select(self.expr(node.args[0]), self.expr(node.args[1]),
                            self.expr(node.args[2]))
        if attr in _WARP_FUNCS:
            # value-producing warp calls are handled in Assign; reaching here
            # means they are nested inside a larger expression — flattening
            # is done by stmt-level handling, so reject for clarity.
            raise self.err(node, f"warp collective {attr}() must be the sole "
                                 f"RHS of an assignment (e.g. v = c.{attr}(...))")
        if attr == "this_grid":
            raise self.err(
                node, "this_grid() is only supported as a grid barrier — "
                      "write c.this_grid().sync() (or c.grid_sync()) as a "
                      "standalone statement")
        if attr in ("coalesced_threads", "this_multi_grid"):
            raise CoxUnsupported(
                f"dynamic cooperative group '{attr}' requires runtime thread "
                f"scheduling (paper §2.2.3 — same gap as filter_arr)")
        raise self.err(node, f"unknown context intrinsic {attr}")

    # ---------------- statements ----------------

    def stmts(self, body: List[ast.stmt]) -> List[K.Stmt]:
        out: List[K.Stmt] = []
        for s in body:
            out.extend(self.stmt(s))
        return out

    def stmt(self, node: ast.stmt) -> List[K.Stmt]:
        if isinstance(node, ast.Expr):
            if isinstance(node.value, ast.Constant):  # docstring
                return []
            attr = self._is_ctx_call(node.value)
            if attr == "syncthreads":
                return [K.Barrier(BarrierLevel.BLOCK)]
            if attr == "syncwarp":
                return [K.Barrier(BarrierLevel.WARP)]
            if attr == "grid_sync":
                return [K.Barrier(BarrierLevel.GRID)]
            # cooperative-groups spelling: c.this_grid().sync()
            if (isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "sync"
                    and self._is_ctx_call(node.value.func.value)
                    == "this_grid"):
                if node.value.args or node.value.keywords:
                    raise self.err(node, "this_grid().sync() takes no "
                                         "arguments")
                return [K.Barrier(BarrierLevel.GRID)]
            if attr == "atomic_add":
                a = node.value.args
                arr = a[0].id if isinstance(a[0], ast.Name) else None
                if arr not in self.arrays:
                    raise self.err(node, "atomic_add target must be a global array")
                return [K.AtomicRMW("add", arr, self.expr(a[1]), self.expr(a[2]))]
            raise self.err(node, "unsupported expression statement")
        if isinstance(node, ast.Assign):
            if len(node.targets) != 1:
                raise self.err(node, "multi-target assign unsupported")
            return self._assign(node.targets[0], node.value, node)
        if isinstance(node, ast.AugAssign):
            op = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
                  ast.FloorDiv: "//", ast.Mod: "%", ast.BitAnd: "&",
                  ast.BitOr: "|", ast.BitXor: "^", ast.LShift: "<<",
                  ast.RShift: ">>"}.get(type(node.op))
            if op is None:
                raise self.err(node, "unsupported augmented op")
            if isinstance(node.target, ast.Name):
                cur: ast.expr = ast.copy_location(
                    ast.Name(id=node.target.id, ctx=ast.Load()), node)
            elif isinstance(node.target, ast.Subscript):
                cur = ast.copy_location(
                    ast.Subscript(value=node.target.value, slice=node.target.slice,
                                  ctx=ast.Load()), node)
            else:
                raise self.err(node, "unsupported augmented target")
            value = K.BinOp(op, self.expr(cur), self.expr(node.value))
            return self._assign_value(node.target, value, node)
        if isinstance(node, ast.If):
            return [K.If(self.expr(node.test), self.stmts(node.body),
                         self.stmts(node.orelse))]
        if isinstance(node, ast.While):
            if node.orelse:
                raise self.err(node, "while-else unsupported")
            return [K.While(self.expr(node.test), self.stmts(node.body))]
        if isinstance(node, ast.For):
            return self._for_range(node)
        if isinstance(node, ast.Return):
            if node.value is not None:
                raise self.err(node, "kernels return nothing")
            return [K.Return()]
        if isinstance(node, (ast.Break, ast.Continue)):
            raise self.err(node, "break/continue unsupported (non-canonical loop)")
        if isinstance(node, ast.AnnAssign):
            if node.value is None:
                return []
            return self._assign(node.target, node.value, node)
        if isinstance(node, ast.Pass):
            return []
        raise self.err(node, f"unsupported statement {type(node).__name__}")

    def _assign(self, target, value_node, node) -> List[K.Stmt]:
        # shared-memory declaration:  tile = c.shared((64,), cox.f32)
        attr = self._is_ctx_call(value_node) if isinstance(value_node, ast.Call) else None
        if attr == "shared":
            if not isinstance(target, ast.Name):
                raise self.err(node, "shared decl target must be a name")
            shape_node = value_node.args[0]
            if isinstance(shape_node, ast.Tuple):
                dims = []
                for e in shape_node.elts:
                    ev = self.expr(e)
                    if not isinstance(ev, K.Const):
                        raise self.err(node, "shared shape must be static")
                    dims.append(int(ev.value))
                shape = tuple(dims)
            else:
                ev = self.expr(shape_node)
                if not isinstance(ev, K.Const):
                    raise self.err(node, "shared shape must be static")
                shape = (int(ev.value),)
            dt = DType.f32
            if len(value_node.args) > 1:
                dt = self._dtype_arg(value_node.args[1], node)
            self.shared[target.id] = SharedSpec(target.id, shape, dt)
            return []
        if attr in _WARP_FUNCS:
            if not isinstance(target, ast.Name):
                raise self.err(node, "warp collective result must go to a name")
            args = [self.expr(a) for a in value_node.args]
            width = 0
            for kw in value_node.keywords:
                if kw.arg == "width":
                    wv = self.expr(kw.value)
                    if not isinstance(wv, K.Const):
                        raise self.err(node, "tile width must be static "
                                             "(dynamic groups unsupported, paper §2.2.3)")
                    width = int(wv.value)
                else:
                    raise self.err(node, f"unknown kwarg {kw.arg}")
            return [K.WarpCall(_WARP_FUNCS[attr], target.id, args, width)]
        if attr == "atomic_add_old":
            a = value_node.args
            if not isinstance(target, ast.Name) or not isinstance(a[0], ast.Name):
                raise self.err(node, "bad atomic form")
            return [K.AtomicRMW("add", a[0].id, self.expr(a[1]), self.expr(a[2]),
                                dst=target.id)]
        return self._assign_value(target, self.expr(value_node), node)

    def _assign_value(self, target, value: K.Expr, node) -> List[K.Stmt]:
        if isinstance(target, ast.Name):
            if target.id in self.arrays or target.id in self.shared:
                raise self.err(node, f"cannot rebind array name {target.id}")
            if target.id in self.scalars:
                raise self.err(node, f"scalar parameter {target.id} is "
                                     f"read-only; copy it to a local first")
            return [K.Assign(target.id, value)]
        if isinstance(target, ast.Subscript):
            name, idx = self._subscript_index(target)
            if name in self.shared:
                return [K.StoreShared(name, idx, value)]
            if name in self.arrays:
                return [K.StoreGlobal(name, idx, value)]
            raise self.err(node, f"unknown array {name}")
        raise self.err(node, "unsupported assignment target")

    def _dtype_arg(self, node, ctx_node) -> DType:
        # cox.f32 etc. appear as Attribute or Name in closure
        if isinstance(node, ast.Attribute):
            name = node.attr
            if name in _DTYPE_BY_NAME:
                return _DTYPE_BY_NAME[name]
        if isinstance(node, ast.Name) and node.id in self.closure:
            v = self.closure[node.id]
            if isinstance(v, DType):
                return v
        raise self.err(ctx_node, "expected a cox dtype")

    def _for_range(self, node: ast.For) -> List[K.Stmt]:
        if node.orelse:
            raise self.err(node, "for-else unsupported")
        if not (isinstance(node.iter, ast.Call) and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"):
            raise self.err(node, "only range() loops supported")
        if not isinstance(node.target, ast.Name):
            raise self.err(node, "loop target must be a name")
        a = node.iter.args
        if len(a) == 1:
            start, stop, step = K.Const(0, DType.i32), self.expr(a[0]), K.Const(1, DType.i32)
        elif len(a) == 2:
            start, stop, step = self.expr(a[0]), self.expr(a[1]), K.Const(1, DType.i32)
        elif len(a) == 3:
            start, stop, step = self.expr(a[0]), self.expr(a[1]), self.expr(a[2])
        else:
            raise self.err(node, "bad range()")
        var = node.target.id
        if isinstance(step, K.Const) and int(step.value) < 0:
            cond = K.CmpOp(">", K.Var(var), stop)
        elif isinstance(step, K.Const):
            cond = K.CmpOp("<", K.Var(var), stop)
        else:
            raise self.err(node, "range step must be a static constant")
        static_trip = None
        if all(isinstance(e, K.Const) for e in (start, stop, step)):
            s0, s1, st = int(start.value), int(stop.value), int(step.value)
            static_trip = max(0, -(-(s1 - s0) // st) if st > 0 else -(-(s0 - s1) // -st))
        body = self.stmts(node.body)
        # a user assignment to the induction variable invalidates the
        # static trip count (the executor would unroll the wrong length)
        def assigns_var(stmts) -> bool:
            for s in stmts:
                if isinstance(s, K.Assign) and s.name == var:
                    return True
                if isinstance(s, K.If) and (assigns_var(s.then_body)
                                            or assigns_var(s.else_body)):
                    return True
                if isinstance(s, K.While) and assigns_var(s.body):
                    return True
            return False
        if assigns_var(body):
            static_trip = None
        body.append(K.Assign(var, K.BinOp("+", K.Var(var), step)))
        return [K.Assign(var, start),
                K.While(cond, body, static_trip=static_trip,
                        induction=(var, start, step))]


def parse_kernel(fn, name: Optional[str] = None) -> K.Kernel:
    """Parse a Python function into a kernel IR."""
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = None
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fdef = n
            break
    if fdef is None:
        raise CoxUnsupported("no function definition found")
    args = fdef.args.args
    if not args:
        raise CoxUnsupported("kernel needs a context parameter")
    ctx_name = args[0].arg

    # closure constants (for captured Python ints/floats and dtypes)
    closure: Dict[str, Any] = {}
    if fn.__closure__ and fn.__code__.co_freevars:
        for nm, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                closure[nm] = cell.cell_contents
            except ValueError:
                pass
    closure.update({k: v for k, v in fn.__globals__.items()
                    if isinstance(v, (int, float, DType)) and not k.startswith("__")})

    # parameter specs from annotations (evaluated objects via fn signature;
    # eval_str handles modules with `from __future__ import annotations`)
    try:
        sig = inspect.signature(fn, eval_str=True)
    except Exception:
        sig = inspect.signature(fn)
    arrays: Dict[str, ArraySpec] = {}
    scalars: Dict[str, ScalarSpec] = {}
    params: List[Any] = []
    for p in list(sig.parameters.values())[1:]:
        ann = p.annotation
        if isinstance(ann, Array):
            spec = ArraySpec(p.name, ann.dtype)
            arrays[p.name] = spec
        elif isinstance(ann, DType):
            spec = ScalarSpec(p.name, ann)
            scalars[p.name] = spec
        elif ann is inspect.Parameter.empty:
            spec = ArraySpec(p.name, DType.f32)  # CUDA default: float*
            arrays[p.name] = spec
        else:
            raise CoxUnsupported(
                f"parameter {p.name}: annotate with cox.Array(dtype) or a cox dtype")
        params.append(spec)

    parser = _Parser(ctx_name, arrays, scalars, closure)
    body = parser.stmts(fdef.body)
    return K.Kernel(name or fn.__name__, params, list(parser.shared.values()),
                    body, source=src)
