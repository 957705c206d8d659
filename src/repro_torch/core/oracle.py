# fmt: off
"""Ground-truth oracle: a per-thread CUDA-semantics interpreter.

Executes the *untransformed* kernel IR exactly the way a GPU would under
the paper's assumptions: one Python generator per CUDA thread, real
barriers (threads advance region-by-region between synchronization
events), real warp collectives (the scheduler gathers each lane's
contribution and distributes results).  Completely independent of the
hierarchical-collapsing pipeline and of JAX — numpy only — so agreement
between this oracle and the compiled executor is strong evidence of
transformation correctness.

Scheduling model: between events, a released group's threads run to
their next event one at a time (tid order).  For correctly synchronized
programs (CUDA race-freedom between barriers) every legal schedule gives
the same answer, so this is a valid oracle; racy programs are UB in CUDA
too.  Volta-style intra-warp lockstep is NOT simulated — kernels must
use __syncwarp()/collectives for intra-warp communication, which is
required by post-Volta CUDA anyway.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import kernel_ir as K
from .types import (ArraySpec, BarrierLevel, CoxUnsupported, DType,
                    dim3_tuple)


class OracleMisaligned(Exception):
    """Threads reached different synchronization points — the kernel
    violates the aligned-barrier assumption (paper §2.2.3)."""


def _np(dt: DType):
    return {DType.f32: np.float32, DType.f16: np.float16,
            DType.bf16: np.float32,  # numpy has no bf16; f32 stand-in
            DType.i32: np.int32, DType.i64: np.int64,
            DType.u32: np.uint32, DType.b1: np.bool_}[dt]


class _Thread:
    def __init__(self, kernel: K.Kernel, tid: int, warp_size: int,
                 uniforms: Dict[str, Any], globals_: Dict[str, np.ndarray],
                 shmem: Dict[str, np.ndarray],
                 var_types: Dict[str, DType]):
        self.k = kernel
        self.tid = tid
        self.W = warp_size
        self.uniforms = uniforms
        self.globals = globals_
        self.shmem = shmem
        self.vars: Dict[str, Any] = {}
        self.var_types = var_types

    # ------------- expression evaluation (pure, per-thread) -------------

    def ev(self, e: K.Expr):
        if isinstance(e, K.Const):
            return e.value
        if isinstance(e, K.Var):
            if e.name in self.uniforms:
                return self.uniforms[e.name]
            return self.vars.get(e.name, 0)
        if isinstance(e, K.Special):
            if e.kind == "lane":
                return self.tid % self.W
            if e.kind == "wid":
                return self.tid // self.W
            if e.kind == "wsize":
                return self.W
            ax = {"x": 0, "y": 1, "z": 2}[getattr(e, "axis", "x")]
            if e.kind == "tid":
                bx, by, _ = self.uniforms["bdim3"]
                return (self.tid % bx, (self.tid // bx) % by,
                        self.tid // (bx * by))[ax]
            if e.kind == "bid":
                gx, gy, _ = self.uniforms["gdim3"]
                bid = self.uniforms["bid"]
                return (bid % gx, (bid // gx) % gy, bid // (gx * gy))[ax]
            if e.kind == "bdim":
                return self.uniforms["bdim3"][ax]
            if e.kind == "gdim":
                return self.uniforms["gdim3"][ax]
            return self.uniforms[e.kind]
        if isinstance(e, K.BinOp):
            a, b = self.ev(e.lhs), self.ev(e.rhs)
            if e.op == "+":
                return a + b
            if e.op == "-":
                return a - b
            if e.op == "*":
                return a * b
            if e.op == "/":
                return float(a) / float(b)
            if e.op == "//":
                return a // b
            if e.op == "%":
                return a % b
            if e.op == "&":
                return (a and b) if isinstance(a, (bool, np.bool_)) else a & b
            if e.op == "|":
                return (a or b) if isinstance(a, (bool, np.bool_)) else a | b
            if e.op == "^":
                return (bool(a) != bool(b)) if isinstance(a, (bool, np.bool_)) else a ^ b
            if e.op == "<<":
                return a << b
            if e.op == ">>":
                return a >> b
            if e.op == "min":
                return min(a, b)
            if e.op == "max":
                return max(a, b)
            raise CoxUnsupported(e.op)
        if isinstance(e, K.CmpOp):
            a, b = self.ev(e.lhs), self.ev(e.rhs)
            return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                    "==": a == b, "!=": a != b}[e.op]
        if isinstance(e, K.BoolOp):
            vals = [bool(self.ev(a)) for a in e.args]
            return all(vals) if e.op == "and" else any(vals)
        if isinstance(e, K.UnOp):
            v = self.ev(e.operand)
            if e.op == "neg":
                return -v
            if e.op == "not":
                return not bool(v)
            if e.op == "abs":
                return abs(v)
            if e.op in ("f32",):
                return float(v)
            if e.op in ("i32", "u32"):
                return int(v)
            if e.op in ("f16", "bf16"):
                return float(np.float16(v)) if e.op == "f16" else float(v)
            if e.op == "exp":
                return math.exp(v)
            if e.op == "log":
                return math.log(v)
            if e.op == "sqrt":
                return math.sqrt(v)
            if e.op == "rsqrt":
                return 1.0 / math.sqrt(v)
            if e.op == "tanh":
                return math.tanh(v)
            if e.op == "sigmoid":
                return 1.0 / (1.0 + math.exp(-v))
            if e.op == "floor":
                return math.floor(v)
            raise CoxUnsupported(e.op)
        if isinstance(e, K.Select):
            return self.ev(e.on_true) if bool(self.ev(e.cond)) else self.ev(e.on_false)
        if isinstance(e, K.LoadGlobal):
            idx = int(self.ev(e.index))
            arr = self.globals[e.array]
            return arr[idx] if 0 <= idx < arr.size else arr.dtype.type(0)
        if isinstance(e, K.LoadShared):
            idx = int(self.ev(e.index))
            arr = self.shmem[e.array]
            return arr[idx] if 0 <= idx < arr.size else arr.dtype.type(0)
        raise CoxUnsupported(f"oracle cannot eval {e!r}")

    def _coerce(self, name: str, v):
        dt = self.var_types.get(name)
        if dt is None:
            return v
        return _np(dt)(v)

    # ------------- statement execution (generator; yields sync events) ----

    def run(self):
        yield from self.stmts(self.k.body)

    def stmts(self, body: Sequence[K.Stmt]):
        for s in body:
            if isinstance(s, K.Assign):
                self.vars[s.name] = self._coerce(s.name, self.ev(s.value))
            elif isinstance(s, K.StoreGlobal):
                idx = int(self.ev(s.index))
                arr = self.globals[s.array]
                if 0 <= idx < arr.size:
                    arr[idx] = self.ev(s.value)
            elif isinstance(s, K.StoreShared):
                idx = int(self.ev(s.index))
                arr = self.shmem[s.array]
                if 0 <= idx < arr.size:
                    arr[idx] = self.ev(s.value)
            elif isinstance(s, K.AtomicRMW):
                idx = int(self.ev(s.index))
                arr = self.globals[s.array]
                if 0 <= idx < arr.size:
                    old = arr[idx]
                    if s.dst:
                        self.vars[s.dst] = self._coerce(s.dst, old)
                    v = self.ev(s.value)
                    if s.op == "add":
                        arr[idx] = old + v
                    elif s.op == "max":
                        arr[idx] = max(old, v)
                    else:
                        arr[idx] = min(old, v)
            elif isinstance(s, K.Barrier):
                yield ("barrier", s.level)
            elif isinstance(s, K.WarpCall):
                val = self.ev(s.args[0])
                extra = [self.ev(a) for a in s.args[1:]]
                res = yield ("collective", s.func, val, tuple(extra),
                             s.width or self.W)
                if s.dst:
                    self.vars[s.dst] = self._coerce(s.dst, res)
            elif isinstance(s, K.If):
                if bool(self.ev(s.cond)):
                    yield from self.stmts(s.then_body)
                else:
                    yield from self.stmts(s.else_body)
            elif isinstance(s, K.While):
                guard = 0
                while bool(self.ev(s.cond)):
                    yield from self.stmts(s.body)
                    guard += 1
                    if guard > 1_000_000:
                        raise CoxUnsupported("oracle loop guard tripped")
            elif isinstance(s, K.Return):
                return
            else:
                raise CoxUnsupported(f"oracle cannot run {s!r}")


# ---------------------------------------------------------------------------
# Warp-collective math (independent scalar implementations)
# ---------------------------------------------------------------------------


def _collective(func: str, lanes: List[int], vals: Dict[int, Any],
                extras: Dict[int, tuple], width: int) -> Dict[int, Any]:
    """lanes: lane ids (within warp) present; returns result per lane."""
    out: Dict[int, Any] = {}
    segs: Dict[int, List[int]] = {}
    for ln in lanes:
        segs.setdefault(ln // width, []).append(ln)
    for seg_lanes in segs.values():
        seg_set = set(seg_lanes)
        base = (seg_lanes[0] // width) * width
        if func == "vote_all":
            r = all(bool(vals[ln]) for ln in seg_lanes)
            for ln in seg_lanes:
                out[ln] = r
        elif func == "vote_any":
            r = any(bool(vals[ln]) for ln in seg_lanes)
            for ln in seg_lanes:
                out[ln] = r
        elif func == "ballot":
            r = 0
            for ln in seg_lanes:
                if bool(vals[ln]):
                    r |= 1 << (ln - base)
            for ln in seg_lanes:
                out[ln] = r
        elif func == "red_add":
            r = sum(vals[ln] for ln in seg_lanes)
            for ln in seg_lanes:
                out[ln] = r
        elif func == "red_max":
            r = max(vals[ln] for ln in seg_lanes)
            for ln in seg_lanes:
                out[ln] = r
        elif func == "red_min":
            r = min(vals[ln] for ln in seg_lanes)
            for ln in seg_lanes:
                out[ln] = r
        elif func == "shfl_down":
            for ln in seg_lanes:
                src = ln + int(extras[ln][0])
                out[ln] = vals[src] if (src - base) < width and src in seg_set \
                    else vals[ln]
        elif func == "shfl_up":
            for ln in seg_lanes:
                src = ln - int(extras[ln][0])
                out[ln] = vals[src] if (src - base) >= 0 and src in seg_set \
                    else vals[ln]
        elif func == "shfl_xor":
            for ln in seg_lanes:
                src = ln ^ int(extras[ln][0])
                out[ln] = vals[src] if src in seg_set else vals[ln]
        elif func == "shfl_idx":
            for ln in seg_lanes:
                src = base + (int(extras[ln][0]) % width)
                out[ln] = vals[src] if src in seg_set else vals[ln]
        else:
            raise CoxUnsupported(f"oracle collective {func}")
    return out


# ---------------------------------------------------------------------------
# Block scheduler
# ---------------------------------------------------------------------------


def run_block(kernel: K.Kernel, *, bid: int, block: int, grid: int,
              warp_size: int, scalars: Dict[str, Any],
              globals_: Dict[str, np.ndarray], var_types: Dict[str, DType],
              block_dim=None, grid_dim=None, state: Optional[dict] = None):
    """Run one block to completion.  ``state`` carries the block's
    persistent context across cooperative grid-sync phases: per-thread
    local variables (CUDA: registers live for the thread's lifetime) and
    shared memory (lives for the block's lifetime).  Returns the state
    for the next phase."""
    uniforms = {"bid": bid, "bdim": block, "gdim": grid,
                "bdim3": dim3_tuple(block_dim) or (block, 1, 1),
                "gdim3": dim3_tuple(grid_dim) or (grid, 1, 1)}
    uniforms.update(scalars)
    shmem = (state["shmem"] if state is not None else
             {s.name: np.zeros(int(np.prod(s.shape)), _np(s.dtype))
              for s in kernel.shared})
    gens = []
    threads = []
    for tid in range(block):
        th = _Thread(kernel, tid, warp_size, uniforms, globals_, shmem,
                     var_types)
        if state is not None:
            th.vars = dict(state["vars"][tid])
        threads.append(th)
        gens.append(th.run())

    event: List[Optional[tuple]] = [None] * block
    done = [False] * block

    def step(tid, send=None):
        try:
            event[tid] = gens[tid].send(send) if send is not None or \
                event[tid] is not None else next(gens[tid])
        except StopIteration:
            event[tid] = None
            done[tid] = True

    def first_step(tid):
        try:
            event[tid] = next(gens[tid])
        except StopIteration:
            event[tid] = None
            done[tid] = True

    for tid in range(block):
        first_step(tid)

    n_warps = -(-block // warp_size)
    for _ in range(10_000_000):
        if all(done):
            return {"vars": [th.vars for th in threads], "shmem": shmem}
        progressed = False
        # 1) release any warp whose live lanes all sit at the same warp event
        for w in range(n_warps):
            tids = [t for t in range(w * warp_size,
                                     min((w + 1) * warp_size, block))]
            live = [t for t in tids if not done[t]]
            if not live:
                continue
            evs = [event[t] for t in live]
            if any(e is None for e in evs):
                continue
            kinds = {e[0] for e in evs}
            if kinds == {"collective"}:
                funcs = {(e[1], e[4]) for e in evs}
                if len(funcs) != 1:
                    raise OracleMisaligned(
                        f"warp {w}: lanes at different collectives {funcs}")
                func, width = evs[0][1], evs[0][4]
                lanes = [t - w * warp_size for t in live]
                vals = {t - w * warp_size: event[t][2] for t in live}
                extras = {t - w * warp_size: event[t][3] for t in live}
                res = _collective(func, lanes, vals, extras, width)
                for t in live:
                    ev_res = res[t - w * warp_size]
                    try:
                        event[t] = gens[t].send(ev_res)
                    except StopIteration:
                        event[t] = None
                        done[t] = True
                progressed = True
            elif kinds == {"barrier"} and all(
                    e[1] == BarrierLevel.WARP for e in evs):
                for t in live:
                    try:
                        event[t] = gens[t].send(None)
                    except StopIteration:
                        event[t] = None
                        done[t] = True
                progressed = True
        if progressed:
            continue
        # 2) all live threads at a block barrier → release everyone
        live = [t for t in range(block) if not done[t]]
        if live and all(event[t] is not None and event[t][0] == "barrier"
                        and event[t][1] == BarrierLevel.BLOCK for t in live):
            for t in live:
                try:
                    event[t] = gens[t].send(None)
                except StopIteration:
                    event[t] = None
                    done[t] = True
            continue
        raise OracleMisaligned(
            f"deadlock: events={[(t, event[t]) for t in live][:8]}")
    raise CoxUnsupported("oracle scheduler guard tripped")


def run_grid(kernel: K.Kernel, *, grid, block, args: Sequence[Any],
             warp_size: int = 32) -> Dict[str, np.ndarray]:
    """Reference execution of kernel<<<grid, block>>>(*args); ``grid``
    and ``block`` accept ``int | (x, y[, z])`` dim3 geometry (threads
    linearize x-fastest into warps, blocks into the grid walk).

    Cooperative kernels (``this_grid().sync()``) run with the same phase
    split the compiler uses (``repro.core.phases``): all blocks complete
    phase *p* before any block starts phase *p+1* — the grid barrier's
    guarantee — with each block's per-thread locals and shared memory
    persisting across phases."""
    from .phases import split_phases
    from .typeinfer import infer
    from .types import as_dim3
    grid3 = as_dim3(grid, "grid")
    block3 = as_dim3(block, "block")
    var_types = infer(kernel)
    phase_kernels = split_phases(kernel)
    globals_: Dict[str, np.ndarray] = {}
    shapes: Dict[str, tuple] = {}
    scalars: Dict[str, Any] = {}
    for spec, val in zip(kernel.params, args):
        if isinstance(spec, ArraySpec):
            a = np.asarray(val, _np(spec.dtype))
            shapes[spec.name] = a.shape
            globals_[spec.name] = a.reshape(-1).copy()
        else:
            scalars[spec.name] = _np(spec.dtype)(val)
    states: List[Optional[dict]] = [None] * grid3.total
    for pk in phase_kernels:
        for bid in range(grid3.total):
            states[bid] = run_block(
                pk, bid=bid, block=block3.total, grid=grid3.total,
                warp_size=warp_size, scalars=scalars, globals_=globals_,
                var_types=var_types, block_dim=block3, grid_dim=grid3,
                state=states[bid])
    return {k: v.reshape(shapes[k]) for k, v in globals_.items()}
