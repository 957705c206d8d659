"""Two-level executor for hierarchically-collapsed kernels, on torch.

Generated-code shape (paper Code 3):

    for each block-level PR:                 # block machine node
        for wid in range(n_warps):           # inter-warp loop
            run the PR's warp-level machine  # warp PRs + peeled branches
              -- every warp PR evaluates all W lanes at once (the
                 intra-warp "loop" is the lane axis of a (W,) tensor)

Loop peeling (paper section 3.3.1): branch conditions are evaluated by
*all* lanes but the direction is taken from lane 0 (warp level) or warp
0 lane 0 (block level) -- sound under the aligned-barrier assumption.

The port runs eagerly.  A warp-uniform program counter is a Python
integer, so the reference's ``lax.while_loop``/``lax.switch`` machines
become Python loops, and a peel or a lane-divergent ``while`` reads one
flag back from the device.  Every such read goes through
:func:`_host_bool`, which counts it in the module-level ``host_syncs``.

Modes:
* ``jit``    -- static-trip predicated loops up to ``_UNROLL_LIMIT`` are
               unrolled (no flag read per iteration);
* ``normal`` -- every loop runs as a masked while.

Warp execution is ``serial`` (the paper's inter-warp loop).  The
batched ``(n_warps, W)`` plane is queue item A.5 and raises here.

Memory semantics follow the reference exactly:
* global and shared arrays live flat with one extra *sink* slot at the
  end; a masked-off or out-of-range store writes the sink, never a raw
  out-of-range index (which would be a device-side assert on CUDA);
* indices in ``[-n, -1]`` wrap as JAX's ``.at[]`` does; loads outside the
  array read 0;
* binary operands are promoted by :func:`_result_dtype` (JAX's rules with
  64-bit types off) and casts follow JAX's ``astype`` (float to int
  truncates and saturates, NaN goes to 0, ``u32`` wraps).

``simd=False`` switches warp collectives to per-lane loop emulation
(Table 2's "w/o AVX" baseline).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import collectives
from . import kernel_ir as K
from .cfg import CFG, WarpBufCompute, WarpBufStore
from .lower import lower_kernel
from .passes import (
    insert_extra_barriers,
    lower_warp_intrinsics,
    split_blocks_at_barriers,
)
from .regions import (
    EXIT,
    BlockPR,
    Machine,
    WarpPR,
    build_machine,
    replication_classes,
    warp_peel_count,
)
from .typeinfer import infer
from .types import U32_MASK, ArraySpec, CoxUnsupported, DType, ScalarSpec, dim3_tuple

_UNROLL_LIMIT = 64  # static-trip predicated loops up to this are unrolled in jit mode

# Device-to-host flag reads (peels, masked-while trips): one per call of
# _host_bool.  A plain integer; callers read it before and after a launch.
host_syncs = 0


def _host_bool(t: torch.Tensor) -> bool:
    global host_syncs
    host_syncs += 1
    return bool(t.item())


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledKernel:
    """Result of the full pass pipeline, ready to execute.

    A kernel with grid-wide barriers (``c.grid_sync()``) compiles to a
    *multi-phase* container: ``phases`` holds one ordinary single-phase
    CompiledKernel per inter-sync program segment (``phases.py``) and
    ``cfg``/``machine``/``classes`` of the container itself are unset.
    """

    kernel: K.Kernel
    cfg: Optional[CFG]
    machine: Optional[Machine]
    var_types: Dict[str, DType]
    classes: Dict[str, str]  # var -> 'block' | 'warp'
    warp_bufs: Dict[str, DType]
    warp_size: int
    phases: Tuple["CompiledKernel", ...] = ()  # per-phase compilations
    carried: Tuple[str, ...] = ()  # locals live across phases

    @property
    def n_phases(self) -> int:
        return len(self.phases) or 1

    def phase_list(self) -> Tuple["CompiledKernel", ...]:
        """The executable phase sequence -- ``(self,)`` for the ordinary
        single-phase case."""
        return self.phases or (self,)

    @property
    def array_params(self) -> List[ArraySpec]:
        return [p for p in self.kernel.params if isinstance(p, ArraySpec)]

    def summary(self) -> str:
        if self.phases:
            inner = "; ".join(p.summary() for p in self.phases)
            return (
                f"kernel {self.kernel.name}: {len(self.phases)} "
                f"grid-sync phases, {len(self.carried)} carried "
                f"locals [{inner}]"
            )
        n_bpr = sum(isinstance(n, BlockPR) for n in self.machine.nodes)
        n_wpr = sum(
            sum(isinstance(w, WarpPR) for w in n.warp.nodes)
            for n in self.machine.nodes
            if isinstance(n, BlockPR)
        )
        n_peel = warp_peel_count(self.machine)
        n_block = len([v for v, c in self.classes.items() if c == "block"])
        return (
            f"kernel {self.kernel.name}: {len(self.cfg.blocks)} blocks, "
            f"{n_bpr} block-level PRs, {n_wpr} warp-level PRs, "
            f"{n_peel} warp peels, {n_block} block-replicated vars"
        )


def compile_kernel(kernel: K.Kernel, warp_size: int = 32) -> CompiledKernel:
    """Run the hierarchical-collapsing pipeline (paper Fig. 4 steps 1-5).

    Kernels using ``c.grid_sync()`` are phase-split first: type inference
    runs once over the full kernel so cross-phase locals agree, each phase
    runs the unchanged pipeline, and locals live across phase boundaries
    are forced to the 'block' replication class in every phase so their
    per-warp rows can be carried between phases."""
    from .phases import carried_locals, split_phases

    phase_kernels = split_phases(kernel)
    if len(phase_kernels) == 1:
        return _compile_one(kernel, warp_size, infer(kernel), ())
    var_types = infer(kernel)  # full-kernel: cross-phase var types
    carried = tuple(sorted(carried_locals(kernel, phase_kernels)))
    compiled = tuple(
        _compile_one(pk, warp_size, dict(var_types), carried) for pk in phase_kernels
    )
    uniforms = {p.name for p in kernel.params if isinstance(p, ScalarSpec)}
    vt = {v: t for v, t in var_types.items() if v not in uniforms}
    return CompiledKernel(
        kernel, None, None, vt, {}, {}, warp_size, phases=compiled, carried=carried
    )


def _compile_one(
    kernel: K.Kernel,
    warp_size: int,
    var_types: Dict[str, DType],
    force_block: Tuple[str, ...],
) -> CompiledKernel:
    """The single-phase pipeline (paper Fig. 4 steps 1-5)."""
    cfg = lower_kernel(kernel)
    warp_bufs = lower_warp_intrinsics(cfg, var_types)
    for b, dt in warp_bufs.items():
        var_types[b] = dt
    insert_extra_barriers(cfg)
    split_blocks_at_barriers(cfg)
    cfg.verify()
    machine = build_machine(cfg)
    uniforms = {p.name for p in kernel.params if isinstance(p, ScalarSpec)}
    for u in uniforms:  # scalar params are block-uniform, never replicated
        var_types.pop(u, None)
    classes = replication_classes(machine, uniforms)
    # every var assigned anywhere must have a class; default to warp-local
    for v in var_types:
        classes.setdefault(v, "warp")
    # cross-phase locals must live in the carried per-warp rows
    for v in force_block:
        classes[v] = "block"
    return CompiledKernel(
        kernel, cfg, machine, var_types, classes, warp_bufs, warp_size
    )


# ---------------------------------------------------------------------------
# dtype semantics (JAX with 64-bit types off)
# ---------------------------------------------------------------------------


def _result_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """JAX's promotion of two strongly-typed operands with x64 off, over
    the executor's dtypes (int64 only ever carries u32)."""
    if a == b:
        return a
    if a == torch.bool:
        return b
    if b == torch.bool:
        return a
    if a.is_floating_point and b.is_floating_point:
        return torch.float32  # bf16 with f16, or a half type with f32
    if a.is_floating_point:
        return a
    if b.is_floating_point:
        return b
    return torch.int32  # i32 with u32: int64, canonicalized to int32


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = _result_dtype(a.dtype, b.dtype)
    return _cast(a, dt), _cast(b, dt)


def _wrap(t: torch.Tensor) -> torch.Tensor:
    """Bring int64-carried u32 results back into [0, 2**32)."""
    return t & U32_MASK if t.dtype == torch.int64 else t


def _cast(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """JAX ``astype``: float to int truncates toward zero, saturates at
    the target's range and sends NaN to 0; anything into u32 wraps."""
    if v.dtype == dt:
        return v
    if v.dtype.is_floating_point and not dt.is_floating_point and dt != torch.bool:
        lo, hi = (0, U32_MASK) if dt == torch.int64 else (-(2**31), 2**31 - 1)
        return torch.nan_to_num(v.double(), nan=0.0).clamp(lo, hi).to(dt)
    if dt == torch.int64:
        return v.to(torch.int64) & U32_MASK
    return v.to(dt)


def _floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.floor_divide`` on promoted operands, division by zero
    included (int: ``x // 0`` is -1 for x == 0 else -2; u32: all ones)."""
    if a.is_floating_point():
        return _float_divmod(a, b)[0]
    zero = b == 0
    if a.dtype == torch.int64:  # u32: non-negative, plain division
        q = torch.div(a, torch.where(zero, 1, b), rounding_mode="floor")
        return torch.where(zero, U32_MASK, q)
    neg1 = b == -1  # INT_MIN // -1 traps on x86; JAX wraps to INT_MIN
    safe = torch.where(zero | neg1, 1, b)
    q = torch.div(a, safe, rounding_mode="floor")
    q = torch.where(neg1, -a, q)
    by_zero = torch.where(a == 0, -1, -2).to(a.dtype)
    return torch.where(zero, by_zero, q)


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.remainder`` on promoted operands (``x % 0`` is 0 for ints)."""
    if a.is_floating_point():
        trunc = torch.fmod(a, b)
        plus = ((trunc < 0) != (b < 0)) & (trunc != 0)
        return torch.where(plus, trunc + b, trunc)
    bad = (b == 0) | (b == -1)
    r = torch.remainder(a, torch.where(bad, 1, b))
    return torch.where(bad, 0, r).to(a.dtype)


def _float_divmod(a: torch.Tensor, b: torch.Tensor):
    """JAX's float divmod: fmod-based, quotient rounded half away from 0."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    mod = torch.where(ind, mod + b, mod)
    div = torch.where(ind, div - 1, div)
    rounded = torch.where(div >= 0, torch.floor(div + 0.5), torch.ceil(div - 0.5))
    return rounded.to(a.dtype), mod


def _shift(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA shifts: a count outside [0, 32) gives 0, or -1 for an
    arithmetic right shift of a negative value."""
    ok = (b >= 0) & (b < 32)
    s = torch.where(ok, b, 0)
    if op == "<<":
        return _wrap(torch.where(ok, a << s, 0).to(a.dtype))
    fill = torch.where(a < 0, -1, 0).to(a.dtype)
    return torch.where(ok, a >> s, fill)


_ARITH = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
    "min": torch.minimum,
    "max": torch.maximum,
}

_BITWISE = {"&": torch.bitwise_and, "|": torch.bitwise_or, "^": torch.bitwise_xor}
_LOGICAL = {"&": torch.logical_and, "|": torch.logical_or, "^": torch.logical_xor}

_CMPS = {
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
    "==": torch.eq,
    "!=": torch.ne,
}

_UNARY_F32 = {
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "tanh": torch.tanh,
    "floor": torch.floor,
}


def _binop(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "/":
        if not (a.is_floating_point() or b.is_floating_point()):
            a, b = a.to(torch.float32), b.to(torch.float32)
        a, b = _promote(a, b)
        return torch.true_divide(a, b)
    if op in _BITWISE and (a.dtype == torch.bool or b.dtype == torch.bool):
        return _LOGICAL[op](a, b)
    a, b = _promote(a, b)
    if op == "//":
        return _floor_divide(a, b)
    if op == "%":
        return _remainder(a, b)
    if op in ("<<", ">>"):
        return _shift(op, a, b)
    if op in _BITWISE:
        return _BITWISE[op](a, b)
    return _wrap(_ARITH[op](a, b))


# ---------------------------------------------------------------------------
# Memory: flat arrays with a sink slot at the end
# ---------------------------------------------------------------------------


def _norm_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``.at[]`` index normalization: ``[-n, -1]`` wraps."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def load(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].get(mode="fill", fill_value=0)`` on a sink-slotted
    flat array (logical length ``arr.numel() - 1``)."""
    n = arr.shape[0] - 1
    i = _norm_index(idx, n)
    ok = (i >= 0) & (i < n)
    return arr[torch.where(ok, i, n)].masked_fill(~ok, 0)


def store_index(idx: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """The index a masked store writes: the normalized index for active
    in-range lanes, the sink slot ``n`` for every other lane -- what
    ``.at[].set(mode="drop")`` drops."""
    i = _norm_index(idx.expand(m.shape), n)
    ok = m & (i >= 0) & (i < n)
    return torch.where(ok, i, n)


def with_sink(flat: torch.Tensor) -> torch.Tensor:
    """A fresh copy of a flat array with the sink slot appended."""
    return torch.cat([flat, flat.new_zeros(1)])


# ---------------------------------------------------------------------------
# Environment
# ---------------------------------------------------------------------------


class _Env:
    """Mutable view over the machine state for one (block, warp) context.

    Block-replicated vars are lists of per-warp ``(W,)`` rows and warp
    vars are ``(W,)`` tensors; both are replaced on write, never written
    in place, so a value read earlier never changes under a reader.
    Global and shared arrays are updated in place (every read of them is
    a gather, which copies)."""

    def __init__(
        self,
        ck: CompiledKernel,
        *,
        wid: int,
        uniforms: Dict[str, Any],
        block_vars: Dict[str, List[torch.Tensor]],
        shmem: Dict[str, torch.Tensor],
        globals_: Dict[str, torch.Tensor],
        simd: bool,
        consts: Dict[Any, torch.Tensor],
        block_total: int,
        block_dim3: Optional[Tuple[int, int, int]] = None,
        grid_dim3: Optional[Tuple[int, int, int]] = None,
    ):
        self.ck = ck
        # static dim3 extents for the per-axis intrinsics; None means a
        # 1-D launch (tid_x/bid_x are the linear ids, y/z are zero)
        self.block_dim3 = block_dim3
        self.grid_dim3 = grid_dim3
        self.W = ck.warp_size
        self.wid = wid
        self.uniforms = uniforms
        self.warp_vars: Dict[str, torch.Tensor] = {}
        self.block_vars = block_vars
        self.shmem = shmem
        self.globals = globals_
        self.simd = simd
        self.consts = consts
        self.device = uniforms["bid"].device
        self.lane = self.const_lanes()
        self.base_mask = self.lane + wid * self.W < block_total

    # ---------------- constants (cached per launch, per device) ----------

    def const(self, value, dtype: torch.dtype) -> torch.Tensor:
        key = (repr(value), dtype)  # repr keeps -0.0 apart from 0.0
        t = self.consts.get(key)
        if t is None:
            t = self.consts[key] = torch.tensor(value, dtype=dtype, device=self.device)
        return t

    def const_lanes(self) -> torch.Tensor:
        key = ("lanes", self.W)
        t = self.consts.get(key)
        if t is None:
            t = torch.arange(self.W, dtype=torch.int32, device=self.device)
            self.consts[key] = t
        return t

    # ---------------- variables ----------------

    def _dtype(self, name: str) -> DType:
        return self.ck.var_types.get(name, DType.f32)

    def read_var(self, name: str) -> torch.Tensor:
        if name in self.uniforms:
            return self.uniforms[name]
        if self.ck.classes.get(name, "warp") == "warp":
            v = self.warp_vars.get(name)
            if v is None:  # never written: zero, like the reference's carry
                v = self.const(0, self._dtype(name).compute).expand(self.W)
            return v
        return self.block_vars[name][self.wid]

    def write_var(self, name: str, value, mask=None):
        value = _cast(value, self._dtype(name).compute).expand(self.W)
        if mask is not None:
            value = torch.where(mask, value, self.read_var(name))
        if self.ck.classes.get(name, "warp") == "warp":
            self.warp_vars[name] = value
        else:
            self.block_vars[name][self.wid] = value


# ---------------------------------------------------------------------------
# Expression evaluation (vectorized across the warp's lanes)
# ---------------------------------------------------------------------------


def eval_expr(e: K.Expr, env: _Env) -> torch.Tensor:
    if isinstance(e, K.Const):
        return env.const(e.value, (e.dtype or DType.f32).compute)
    if isinstance(e, K.Var):
        return env.read_var(e.name)
    if isinstance(e, K.Special):
        return _eval_special(e, env)
    if isinstance(e, K.BinOp):
        return _binop(e.op, eval_expr(e.lhs, env), eval_expr(e.rhs, env))
    if isinstance(e, K.CmpOp):
        a, b = _promote(eval_expr(e.lhs, env), eval_expr(e.rhs, env))
        return _CMPS[e.op](a, b)
    if isinstance(e, K.BoolOp):
        vals = [eval_expr(a, env).to(torch.bool) for a in e.args]
        out = vals[0]
        for v in vals[1:]:
            out = out & v if e.op == "and" else out | v
        return out
    if isinstance(e, K.UnOp):
        return _eval_unop(e.op, eval_expr(e.operand, env))
    if isinstance(e, K.Select):
        cond = eval_expr(e.cond, env).to(torch.bool)
        a, b = _promote(eval_expr(e.on_true, env), eval_expr(e.on_false, env))
        return torch.where(cond, a, b)
    if isinstance(e, K.LoadGlobal):
        return load(env.globals[e.array], _cast(eval_expr(e.index, env), torch.int32))
    if isinstance(e, K.LoadShared):
        return load(env.shmem[e.array], _cast(eval_expr(e.index, env), torch.int32))
    raise CoxUnsupported(f"cannot evaluate {e!r}")


def _eval_unop(op: str, v: torch.Tensor) -> torch.Tensor:
    if op == "neg":
        return _wrap(-v)
    if op == "not":
        return ~v.to(torch.bool)
    if op == "abs":
        return torch.abs(v)
    if op in ("f32", "i32", "f16", "bf16", "u32"):
        return _cast(v, DType(op).compute)
    if op == "rsqrt":
        return torch.rsqrt(v.to(torch.float32))
    if op == "sigmoid":
        return torch.sigmoid(v.to(torch.float32))
    if v.dtype in (torch.int32, torch.bool):
        v = v.to(torch.float32)
    return _UNARY_F32[op](v)


_AXIS_IX = {"x": 0, "y": 1, "z": 2}


def _decompose(lin, extents, axis: str):
    """x-fastest dim3 decomposition of a linear id against static
    extents (lanes past the logical extent -- the partial last warp --
    produce out-of-range components; their stores are masked off)."""
    dx, dy, dz = extents
    if axis == "x":
        return lin if dy == 1 and dz == 1 else lin % dx
    if axis == "y":
        if dy == 1:
            return torch.zeros_like(lin)
        return lin // dx if dz == 1 else (lin // dx) % dy
    return torch.zeros_like(lin) if dz == 1 else lin // (dx * dy)


def _eval_special(e: K.Special, env: _Env) -> torch.Tensor:
    """Thread-identity intrinsics: per-lane (tx, ty, tz) vectors and
    per-block (bx, by, bz) uniforms, decomposed from linear ids."""
    i32 = torch.int32
    if e.kind == "lane":
        return env.lane
    if e.kind == "wid":
        return env.const(env.wid, i32).expand(env.W)
    if e.kind == "wsize":
        return env.const(env.W, i32)
    axis = getattr(e, "axis", "x")
    if e.kind == "tid":
        lin = env.lane + env.wid * env.W
        if env.block_dim3 is None:  # direct make_block_fn caller: 1-D
            return lin if axis == "x" else torch.zeros_like(lin)
        return _decompose(lin, env.block_dim3, axis)
    if e.kind == "bid":
        bid = env.uniforms["bid"]
        if env.grid_dim3 is None:
            return bid if axis == "x" else torch.zeros_like(bid)
        return _decompose(bid, env.grid_dim3, axis)
    if e.kind == "bdim":
        if env.block_dim3 is None:
            return env.uniforms["bdim"]
        return env.const(env.block_dim3[_AXIS_IX[axis]], i32)
    if e.kind == "gdim":
        if env.grid_dim3 is None:
            return env.uniforms["gdim"]
        return env.const(env.grid_dim3[_AXIS_IX[axis]], i32)
    return _cast(env.uniforms[e.kind], i32)


# ---------------------------------------------------------------------------
# Instruction execution (with predication masks for barrier-free divergence)
# ---------------------------------------------------------------------------


def _store_mask(env: _Env, mask):
    m = env.base_mask
    return m if mask is None else (m & mask)


def _lanes_of(env: _Env, v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bool).expand(env.W)


def exec_instrs(instrs: List, env: _Env, mask, *, jit_mode: bool):
    for ins in instrs:
        exec_instr(ins, env, mask, jit_mode=jit_mode)


def _store(arr: torch.Tensor, ins, env: _Env, mask):
    m = _store_mask(env, mask)
    raw = _cast(eval_expr(ins.index, env), torch.int32)
    idx = store_index(raw, m, arr.shape[0] - 1)
    val = _cast(eval_expr(ins.value, env), arr.dtype).expand(m.shape)
    arr.index_put_((idx,), val)


def exec_instr(ins, env: _Env, mask, *, jit_mode: bool):
    if isinstance(ins, K.Assign):
        env.write_var(ins.name, eval_expr(ins.value, env), mask)
    elif isinstance(ins, K.StoreGlobal):
        _store(env.globals[ins.array], ins, env, mask)
    elif isinstance(ins, K.StoreShared):
        _store(env.shmem[ins.array], ins, env, mask)
    elif isinstance(ins, K.AtomicRMW):
        _atomic(ins, env, mask)
    elif isinstance(ins, K.Barrier):
        pass  # structural only -- ordering is preserved by lane vectorization
    elif isinstance(ins, WarpBufStore):
        if mask is not None:
            raise CoxUnsupported(
                "warp collective inside divergent (predicated) control flow -- "
                "dynamic-mask collectives are outside the supported set "
                "(paper section 2.2.3)"
            )
        env.write_var(ins.buf, eval_expr(ins.value, env), None)
    elif isinstance(ins, WarpBufCompute):
        if mask is not None:
            raise CoxUnsupported("warp collective inside divergent control flow")
        buf = env.read_var(ins.buf)
        fn = collectives.dispatch(ins.func, env.simd)
        extra = [eval_expr(a, env) for a in ins.args]
        res = fn(buf, *extra, W=env.W, width=ins.width, mask=env.base_mask)
        env.write_var(ins.dst, res, None)
    elif isinstance(ins, K.If):
        cond = _lanes_of(env, eval_expr(ins.cond, env))
        m_t = cond if mask is None else (mask & cond)
        exec_instrs(ins.then_body, env, m_t, jit_mode=jit_mode)
        if ins.else_body:
            m_f = ~cond if mask is None else (mask & ~cond)
            exec_instrs(ins.else_body, env, m_f, jit_mode=jit_mode)
    elif isinstance(ins, K.While):
        _exec_masked_while(ins, env, mask, jit_mode=jit_mode)
    elif isinstance(ins, K.Return):
        raise CoxUnsupported("return must terminate the kernel")
    else:
        raise CoxUnsupported(f"cannot execute {ins!r}")


def _atomic(ins: K.AtomicRMW, env: _Env, mask):
    """Atomic read-modify-write of a warp's lanes.  Duplicate indices
    accumulate (``index_add_`` / ``scatter_reduce_``).  On CUDA a float
    sum's order is the device's and changes from run to run: it is exact
    only where every order rounds alike (counts, small integers), and
    otherwise agrees with the CPU within rtol = atol = 1e-5
    (``tests/test_torch_cuda.py``); max, min and integer sums are exact."""
    m = _store_mask(env, mask)
    tgt = env.globals[ins.array]
    raw = _cast(eval_expr(ins.index, env), torch.int32).expand(m.shape)
    idx = store_index(raw, m, tgt.shape[0] - 1)
    val = _cast(eval_expr(ins.value, env), tgt.dtype).expand(m.shape)
    if ins.dst:
        # every lane observes the pre-op value, as the reference gathers it
        old = load(tgt, torch.where(m, raw, 0))
        env.write_var(ins.dst, old, mask)
    if ins.op == "add":
        tgt.index_add_(0, idx, val)
        if tgt.dtype == torch.int64:
            tgt.bitwise_and_(U32_MASK)
    else:
        tgt.scatter_reduce_(0, idx, val, "amax" if ins.op == "max" else "amin")


def _exec_masked_while(ins: K.While, env: _Env, mask, *, jit_mode: bool):
    """Barrier-free loop with potentially lane-divergent trip counts:
    iterate while any lane is active, with per-lane masking.  The active
    set is ``mask_in & cond``, recomputed every trip (a lane whose
    condition turns true again re-enters, as in the reference); each
    trip's any-lane test is one counted host read."""
    if jit_mode and ins.static_trip is not None and ins.static_trip <= _UNROLL_LIMIT:
        for _ in range(ins.static_trip):
            cond = _lanes_of(env, eval_expr(ins.cond, env))
            m = cond if mask is None else (mask & cond)
            exec_instrs(ins.body, env, m, jit_mode=jit_mode)
        return
    while True:
        cond = _lanes_of(env, eval_expr(ins.cond, env))
        active = cond if mask is None else (mask & cond)
        if not _host_bool(active.any()):
            return
        exec_instrs(ins.body, env, active, jit_mode=jit_mode)


# ---------------------------------------------------------------------------
# Warp-level machine (runs one warp through one block-level PR)
# ---------------------------------------------------------------------------


def run_warp_graph(node: BlockPR, env: _Env, *, jit_mode: bool) -> int:
    """Execute the block-level PR's warp-level region graph for env.wid.
    Returns the exit index (which block-level successor to take)."""
    g = node.warp
    linear = _try_linear(g)
    if linear is not None:
        for wnode in linear:
            exec_instrs_of_warp_pr(wnode, env, jit_mode=jit_mode)
        return linear[-1].succ[1]

    # general case: PC-dispatch machine, the PC a Python int
    exit_pc = len(g.nodes)
    pc, exit_ix = g.entry, 0
    while pc != exit_pc:
        wnode = g.nodes[pc]
        if isinstance(wnode, WarpPR):
            exec_instrs_of_warp_pr(wnode, env, jit_mode=jit_mode)
            target = wnode.succ
        else:  # WarpPeel -- loop peeling: lane 0 decides (paper 3.3.1)
            flag = _host_bool(env.read_var(wnode.cond)[0])
            target = wnode.on_true if flag else wnode.on_false
        kind, val = target
        if kind == "node":
            pc = val
        else:
            pc, exit_ix = exit_pc, val
    return exit_ix


def exec_instrs_of_warp_pr(wnode: WarpPR, env: _Env, *, jit_mode: bool):
    for bname in wnode.blocks:
        exec_instrs(env.ck.cfg.blocks[bname].instrs, env, None, jit_mode=jit_mode)


def _try_linear(g) -> Optional[List[WarpPR]]:
    """Fast path: the warp graph is a pure chain of PRs ending at exit 0
    (no peels, no cycles) -- the shape every warp-feature-free PR has."""
    out: List[WarpPR] = []
    seen = set()
    cur = g.entry
    while True:
        node = g.nodes[cur]
        if not isinstance(node, WarpPR) or cur in seen:
            return None
        seen.add(cur)
        out.append(node)
        kind, val = node.succ
        if kind == "exit":
            return out
        cur = val


# ---------------------------------------------------------------------------
# Block-level machine
# ---------------------------------------------------------------------------


def make_block_fn(
    ck: CompiledKernel,
    *,
    n_warps: int,
    mode: str = "jit",
    simd: bool = True,
    warp_exec: str = "serial",
    block_dim=None,
    grid_dim=None,
    persist: Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]] = None,
):
    """Build ``f(uniforms, globals[, state]) -> globals[, state]`` that
    executes one CUDA block, updating the sink-slotted flat ``globals``
    tensors in place.  ``uniforms`` holds 0-d tensors for bid, bdim,
    gdim and every scalar kernel parameter.

    ``persist=(var_names, shared_names)`` makes the block function one
    *phase* of a cooperative (grid-sync) kernel: it takes
    ``state={"bv": {var: (n_warps, W)}, "sh": {name: flat}}`` holding
    this block's carried locals and shared memory from the previous
    phase (zeros for phase 0), and returns their final values too.

    ``block_dim``/``grid_dim`` are the launch's static dim3 extents; they
    feed only the per-axis intrinsics.  ``None`` means a 1-D launch."""
    if warp_exec not in ("serial", "batched"):
        raise ValueError(
            f"unknown warp_exec {warp_exec!r}; expected 'serial' or 'batched'"
        )
    if warp_exec == "batched":
        raise CoxUnsupported(
            "warp_exec='batched' (the (n_warps, W) warp plane) is not ported "
            "yet: ROADMAP queue item A.5"
        )
    if ck.phases:
        raise ValueError(
            "make_block_fn runs one phase: pass a phase CompiledKernel "
            "(ck.phase_list()), not the multi-phase container"
        )
    jit_mode = mode == "jit"
    W = ck.warp_size
    bdim3 = dim3_tuple(block_dim)
    gdim3 = dim3_tuple(grid_dim)
    block_total = bdim3[0] * bdim3[1] * bdim3[2] if bdim3 else None
    linear = _try_linear_block(ck.machine)
    consts: Dict[Any, torch.Tensor] = {}
    block_types = {
        v: ck.var_types.get(v, DType.f32).compute
        for v, c in ck.classes.items()
        if c == "block"
    }

    def block_fn(uniforms: Dict[str, Any], globals_: Dict[str, Any], state=None):
        dev = uniforms["bid"].device
        bt = block_total if block_total is not None else int(uniforms["bdim"])
        block_vars = {
            v: [torch.zeros(W, dtype=dt, device=dev)] * n_warps
            for v, dt in block_types.items()
        }
        shmem = {
            s.name: torch.zeros(_prod(s.shape) + 1, dtype=s.dtype.compute, device=dev)
            for s in ck.kernel.shared
        }
        if persist is not None:
            if state is None:
                raise ValueError(
                    "persist block fn needs state= (carried per-block "
                    "locals + shared memory)"
                )
            block_vars.update({v: list(state["bv"][v].unbind(0)) for v in persist[0]})
            shmem.update({s: with_sink(state["sh"][s]) for s in persist[1]})

        def run_block_pr(node: BlockPR) -> int:
            """One block-level PR: the inter-warp loop (paper's Code 3
            outer loop).  Returns the block-level successor."""
            ex = 0
            for wid in range(n_warps):
                env = _Env(
                    ck,
                    wid=wid,
                    uniforms=uniforms,
                    block_vars=block_vars,
                    shmem=shmem,
                    globals_=globals_,
                    simd=simd,
                    consts=consts,
                    block_total=bt,
                    block_dim3=bdim3,
                    grid_dim3=gdim3,
                )
                ex = run_warp_graph(node, env, jit_mode=jit_mode)
            if not node.succ_ids:
                return EXIT
            return node.succ_ids[min(max(ex, 0), len(node.succ_ids) - 1)]

        if linear is not None:
            for node in linear:
                run_block_pr(node)
        else:  # general PC machine at block level
            pc = ck.machine.entry
            while pc != EXIT:
                node = ck.machine.nodes[pc]
                if isinstance(node, BlockPR):
                    pc = run_block_pr(node)
                else:  # BlockPeel -- warp 0 lane 0 decides
                    flag = _host_bool(block_vars[node.cond][0][0])
                    pc = node.t_id if flag else node.f_id
        if persist is None:
            return globals_
        out_state = {
            "bv": {v: torch.stack(block_vars[v]) for v in persist[0]},
            "sh": {s: shmem[s][:-1] for s in persist[1]},
        }
        return globals_, out_state

    return block_fn


def _try_linear_block(machine: Machine) -> Optional[List[BlockPR]]:
    out: List[BlockPR] = []
    seen = set()
    cur = machine.entry
    while cur != EXIT:
        node = machine.nodes[cur]
        if not isinstance(node, BlockPR) or cur in seen:
            return None
        if len(set(node.succ_ids)) > 1:
            return None
        seen.add(cur)
        out.append(node)
        cur = node.succ_ids[0] if node.succ_ids else EXIT
    return out
