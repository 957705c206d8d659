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

The port runs eagerly.  Program counters live on the host, so the
reference's ``lax.while_loop``/``lax.switch`` machines become Python
loops, and a peel or a lane-divergent ``while`` reads flags back from
the device.  Every such read goes through :func:`_host_bool` or
:func:`_host_flags`, which count it in the module-level ``host_syncs``.

Modes:
* ``jit``    -- static-trip predicated loops up to ``_UNROLL_LIMIT`` are
               unrolled (no flag read per iteration);
* ``normal`` -- every loop runs as a masked while.

Warp execution (``warp_exec``, orthogonal to the mode):
* ``serial``  -- the inter-warp loop above (the paper's Code 3 shape);
* ``batched`` -- all warps of a block-level PR run at once as one
  ``(n_warps, W)`` lane plane, each on its own copy of the shared and
  global arrays the PR writes, merged at the PR's end (a barrier) by the
  single-writer select of ``backends/merge.py``: bitwise the serial
  loop's result for race-free kernels.

Block-parallel execution (the ``vmap`` backend) runs a chunk of blocks
the same way, as one more leading *copy* axis of every lane tensor.  The
reference gets a program counter per copy from ``vmap`` of its lax
machines; here the machines keep one PC per copy on the host, decided
by one flag read for all copies at a peel, and run a node once for every
copy that sits at it (:func:`_walk`).

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
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
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
#
# An array may carry leading *copy* axes -- one copy per block of a
# block-parallel wave, or per warp of the batched plane -- that are a
# prefix of the lane tensors' copy axes.  A lane reaches its own copy
# through a flat offset (``_offsets``); an array without copy axes is
# shared by every lane.


def _norm_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``.at[]`` index normalization: ``[-n, -1]`` wraps."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def _offsets(arr: torch.Tensor, nb: int, consts: Dict[Any, torch.Tensor]):
    """Flat offsets of ``arr``'s copies for lanes with ``nb`` copy axes:
    ``None`` for an array without copy axes, else a tensor of shape
    ``copy axes + (1,) * (nb - their count) + (1,)``."""
    if arr.dim() == 1:
        return None
    key = ("offsets", tuple(arr.shape), nb, arr.device)
    t = consts.get(key)
    if t is None:
        copies = tuple(arr.shape[:-1])
        t = torch.arange(_prod(copies), dtype=torch.int64, device=arr.device)
        t = (t * arr.shape[-1]).reshape(copies + (1,) * (nb - len(copies) + 1))
        consts[key] = t
    return t


def _bshape(a, b) -> tuple:
    """The broadcast of two shapes (``torch.broadcast_shapes`` costs a
    hundred microseconds a call, on the executor's hottest path)."""
    if a == b:
        return tuple(a)
    if len(a) < len(b):
        a, b = b, a
    b = (1,) * (len(a) - len(b)) + tuple(b)
    return tuple(x if y == 1 else y for x, y in zip(a, b))


def load(arr: torch.Tensor, idx: torch.Tensor, offs=None) -> torch.Tensor:
    """``arr.at[idx].get(mode="fill", fill_value=0)`` on a sink-slotted
    flat array (logical length ``arr.shape[-1] - 1``); ``offs`` selects
    each lane's copy."""
    n = arr.shape[-1] - 1
    i = _norm_index(idx, n)
    ok = (i >= 0) & (i < n)
    j = torch.where(ok, i, n)
    # torch.take, not arr[j]: indexing with a 0-d tensor reads it to the
    # host (.item()), which a CUDA graph capture refuses
    if offs is not None:
        return torch.take(arr, offs + j).masked_fill(~ok, 0)
    return torch.take(arr, j).masked_fill(~ok, 0)


def store_index(idx: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """The index a masked store writes: the normalized index for active
    in-range lanes, the sink slot ``n`` for every other lane -- what
    ``.at[].set(mode="drop")`` drops."""
    shape = _bshape(idx.shape, m.shape)
    i = _norm_index(idx.expand(shape), n)
    ok = m & (i >= 0) & (i < n)
    return torch.where(ok, i, n)


def _flat_index(idx: torch.Tensor, val: torch.Tensor, offs):
    """Index and value of a scatter into a flattened array, broadcast to
    one shape."""
    flat = idx if offs is None else offs + idx
    shape = _bshape(flat.shape, val.shape)
    return flat.expand(shape), val.expand(shape)


def _scatter(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, offs=None):
    """``arr[idx] = val`` in place, each lane into its own copy."""
    flat, val = _flat_index(idx, val, offs)
    arr.view(-1).index_put_((flat,), val)


def with_sink(flat: torch.Tensor) -> torch.Tensor:
    """A fresh copy of a flat array (or of its copies) with the sink
    slot appended."""
    return torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], dim=-1)


# ---------------------------------------------------------------------------
# Environment
# ---------------------------------------------------------------------------


class _Env:
    """Mutable view over the machine state of one warp context.

    Lane tensors have ``shape`` = copy axes + ``(W,)``: no copy axes for
    one warp of one block (the serial ``scan`` path), ``(C,)`` for warp
    ``wid`` of each block of a chunk, ``(n_warps,)`` or ``(C, n_warps)``
    for the batched warp plane, whose ``wid`` is a ``(n_warps, 1)``
    tensor.  Values may be smaller and broadcast against ``shape``.

    Block-replicated vars are lists of per-warp rows (serial warps) or
    one ``(..., n_warps, W)`` plane (``block_rows``); warp vars are
    tensors.  Both are replaced on write, never written in place, so a
    value read earlier never changes under a reader.  Global and shared
    arrays are updated in place (every read of them is a gather, which
    copies).

    ``live`` is the set of copies this context runs for -- ``None`` for
    all, else ``(host flags, device mask)`` over the copy axes -- and
    ``copy_mask`` the copies at the machine node being executed: every
    variable write, store and atomic honours it, so a copy outside it
    changes nothing.

    Under ``track_writes`` (a copy of memory whose writes are merged
    later) stores also set ``store_masks``, atomics add into
    ``atomic_deltas`` instead of the arrays, and a load of an atomic
    target adds the copy's own delta.  Stores to ``log_arrays`` are
    appended to ``store_log`` and replayed after the batched plane."""

    def __init__(
        self,
        ck: CompiledKernel,
        *,
        wid,
        shape: Tuple[int, ...],
        uniforms: Dict[str, Any],
        block_vars: Dict[str, Any],
        shmem: Dict[str, torch.Tensor],
        globals_: Dict[str, torch.Tensor],
        simd: bool,
        consts: Dict[Any, torch.Tensor],
        block_total: int,
        block_dim3: Optional[Tuple[int, int, int]] = None,
        grid_dim3: Optional[Tuple[int, int, int]] = None,
        block_rows: bool = False,
        track_writes: bool = False,
        store_masks: Optional[Dict[str, torch.Tensor]] = None,
        atomic_deltas: Optional[Dict[str, torch.Tensor]] = None,
        shared_masks: Optional[Dict[str, torch.Tensor]] = None,
        log_arrays: Set[str] = frozenset(),
        live=None,
    ):
        self.ck = ck
        # static dim3 extents for the per-axis intrinsics; None means a
        # 1-D launch (tid_x/bid_x are the linear ids, y/z are zero)
        self.block_dim3 = block_dim3
        self.grid_dim3 = grid_dim3
        self.W = ck.warp_size
        self.wid = wid
        self.shape = shape
        self.nb = len(shape) - 1  # copy axes of the lane tensors
        self.uniforms = uniforms
        self.warp_vars: Dict[str, torch.Tensor] = {}
        self.block_vars = block_vars
        self.block_rows = block_rows
        self.shmem = shmem
        self.globals = globals_
        self.simd = simd
        self.consts = consts
        self.device = uniforms["bid"].device
        self.track_writes = track_writes
        self.store_masks = store_masks if store_masks is not None else {}
        self.atomic_deltas = atomic_deltas if atomic_deltas is not None else {}
        self.shared_masks = shared_masks if shared_masks is not None else {}
        self.log_arrays = log_arrays
        self.store_log: List[Tuple[str, torch.Tensor, torch.Tensor]] = []
        self.live = live
        self.copy_mask = None if live is None else live[1].unsqueeze(-1)
        self.lane = self.const_lanes()
        self.tid = self.lane + wid * self.W
        self.base_mask = self.tid < block_total

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

    def offsets(self, arr: torch.Tensor):
        return _offsets(arr, self.nb, self.consts)

    # ---------------- variables ----------------

    def _dtype(self, name: str) -> DType:
        return self.ck.var_types.get(name, DType.f32)

    def read_var(self, name: str) -> torch.Tensor:
        if name in self.uniforms:
            return self.uniforms[name]
        if self.ck.classes.get(name, "warp") == "warp":
            v = self.warp_vars.get(name)
            if v is None:  # never written: zero, like the reference's carry
                v = self.const(0, self._dtype(name).compute).expand(self.shape)
            return v
        if self.block_rows:
            return self.block_vars[name]
        return self.block_vars[name][self.wid]

    def write_var(self, name: str, value, mask=None):
        value = _cast(value, self._dtype(name).compute).expand(self.shape)
        if self.copy_mask is not None:
            mask = self.copy_mask if mask is None else (mask & self.copy_mask)
        if mask is not None:
            value = torch.where(mask, value, self.read_var(name))
        if self.ck.classes.get(name, "warp") == "warp":
            self.warp_vars[name] = value
        elif self.block_rows:
            self.block_vars[name] = value
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
        idx = _cast(eval_expr(e.index, env), torch.int32)
        arr = env.globals[e.array]
        val = load(arr, idx, env.offsets(arr))
        delta = env.atomic_deltas.get(e.array) if env.track_writes else None
        if delta is not None:  # the copy sees its own atomic updates
            val = _binop("+", val, load(delta, idx, env.offsets(delta)))
        return val
    if isinstance(e, K.LoadShared):
        idx = _cast(eval_expr(e.index, env), torch.int32)
        arr = env.shmem[e.array]
        return load(arr, idx, env.offsets(arr))
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
        wid = env.wid if torch.is_tensor(env.wid) else env.const(env.wid, i32)
        return wid.expand(env.shape)
    if e.kind == "wsize":
        return env.const(env.W, i32)
    axis = getattr(e, "axis", "x")
    if e.kind == "tid":
        if env.block_dim3 is None:  # direct make_block_fn caller: 1-D
            return env.tid if axis == "x" else torch.zeros_like(env.tid)
        return _decompose(env.tid, env.block_dim3, axis)
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
    m = env.base_mask if mask is None else (env.base_mask & mask)
    return m if env.copy_mask is None else (m & env.copy_mask)


def _lanes_of(env: _Env, v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bool).expand(env.shape)


def exec_instrs(instrs: List, env: _Env, mask, *, jit_mode: bool):
    for ins in instrs:
        exec_instr(ins, env, mask, jit_mode=jit_mode)


def _store(ins, env: _Env, mask, *, shared: bool):
    arr = env.shmem[ins.array] if shared else env.globals[ins.array]
    m = _store_mask(env, mask)
    raw = _cast(eval_expr(ins.index, env), torch.int32)
    idx = store_index(raw, m, arr.shape[-1] - 1)
    val = _cast(eval_expr(ins.value, env), arr.dtype)
    if not shared and ins.array in env.log_arrays:
        env.store_log.append((ins.array, idx, val))
        return
    offs = env.offsets(arr)
    _scatter(arr, idx, val, offs)
    masks = env.shared_masks if shared else env.store_masks
    if ins.array in masks:
        _scatter(masks[ins.array], idx, env.const(True, torch.bool), offs)


def exec_instr(ins, env: _Env, mask, *, jit_mode: bool):
    if isinstance(ins, K.Assign):
        env.write_var(ins.name, eval_expr(ins.value, env), mask)
    elif isinstance(ins, K.StoreGlobal):
        _store(ins, env, mask, shared=False)
    elif isinstance(ins, K.StoreShared):
        _store(ins, env, mask, shared=True)
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
    (``tests/test_torch_cuda.py``); max, min and integer sums are exact.

    Under ``track_writes`` the update goes into the copy's delta buffer,
    merged later by summing (``backends/merge.py``)."""
    m = _store_mask(env, mask)
    tgt = env.atomic_deltas[ins.array] if env.track_writes else env.globals[ins.array]
    offs = env.offsets(tgt)
    raw = _cast(eval_expr(ins.index, env), torch.int32)
    idx = store_index(raw, m, tgt.shape[-1] - 1)
    val = _cast(eval_expr(ins.value, env), tgt.dtype)
    if ins.dst:
        if env.track_writes:
            # the delta buffer is not the value a serial execution would
            # observe; LaunchPlan.check_mergeable / check_warp_batchable
            # refuse such launches first, this guards direct callers
            raise CoxUnsupported(
                "atomic old-value capture under write-tracking: captured old "
                "values are only exact under serial execution -- use the "
                "scan backend with serial warps"
            )
        # every lane observes the pre-op value, as the reference gathers it
        old = load(tgt, torch.where(m, raw, 0), offs)
        env.write_var(ins.dst, old, mask)
    flat, val = _flat_index(idx, val, offs)
    flat, val = flat.reshape(-1), val.reshape(-1)
    t = tgt.view(-1)
    if ins.op == "add":
        t.index_add_(0, flat, val)
        if t.dtype == torch.int64:
            t.bitwise_and_(U32_MASK)
    else:
        t.scatter_reduce_(0, flat, val, "amax" if ins.op == "max" else "amin")


def _exec_masked_while(ins: K.While, env: _Env, mask, *, jit_mode: bool):
    """Barrier-free loop with potentially lane-divergent trip counts:
    iterate while any lane is active, with per-lane masking.  The active
    set is ``mask_in & cond`` (and the copy mask), recomputed every trip
    (a lane whose condition turns true again re-enters, as in the
    reference); each trip's any-lane test is one counted host read for
    all copies at once."""
    if jit_mode and ins.static_trip is not None and ins.static_trip <= _UNROLL_LIMIT:
        for _ in range(ins.static_trip):
            cond = _lanes_of(env, eval_expr(ins.cond, env))
            m = cond if mask is None else (mask & cond)
            exec_instrs(ins.body, env, m, jit_mode=jit_mode)
        return
    while True:
        active = _lanes_of(env, eval_expr(ins.cond, env))
        if mask is not None:
            active = mask & active
        if env.copy_mask is not None:
            active = active & env.copy_mask
        if not _host_bool(active.any()):
            return
        exec_instrs(ins.body, env, active, jit_mode=jit_mode)


# ---------------------------------------------------------------------------
# Write sets and the batched plane's per-PR plan
# ---------------------------------------------------------------------------


def _written_names(instrs) -> Tuple[Set[str], Set[str], Set[str], Set[str]]:
    """(variables, global arrays, shared arrays, atomic targets) a
    statement list may write, descending into If/While.  Atomic targets
    are also members of the global set; they are reported apart because
    they merge by delta sum, not by writer selection."""
    wv: Set[str] = set()
    arrays: Set[str] = set()
    sh: Set[str] = set()
    atomics: Set[str] = set()
    stack = list(instrs)
    while stack:
        s = stack.pop()
        if isinstance(s, K.Assign):
            wv.add(s.name)
        elif isinstance(s, K.StoreGlobal):
            arrays.add(s.array)
        elif isinstance(s, K.StoreShared):
            sh.add(s.array)
        elif isinstance(s, K.AtomicRMW):
            arrays.add(s.array)
            atomics.add(s.array)
            if s.dst:
                wv.add(s.dst)
        elif isinstance(s, WarpBufStore):
            wv.add(s.buf)
        elif isinstance(s, WarpBufCompute):
            wv.add(s.dst)
        elif isinstance(s, K.If):
            stack.extend(s.then_body)
            stack.extend(s.else_body)
        elif isinstance(s, K.While):
            stack.extend(s.body)
    return wv, arrays, sh, atomics


def _instr_exprs(s):
    """Every expression an instruction evaluates (not descending into
    nested statements)."""
    if isinstance(s, K.Assign):
        return [s.value]
    if isinstance(s, (K.StoreGlobal, K.StoreShared, K.AtomicRMW)):
        return [s.index, s.value]
    if isinstance(s, WarpBufStore):
        return [s.value]
    if isinstance(s, WarpBufCompute):
        return list(s.args)
    if isinstance(s, (K.If, K.While)):
        return [s.cond]
    return []


def _loaded_globals(instrs) -> Set[str]:
    """Global arrays any expression in ``instrs`` may read."""
    out: Set[str] = set()
    stack = list(instrs)
    estack: List[K.Expr] = []
    while stack:
        s = stack.pop()
        estack.extend(_instr_exprs(s))
        if isinstance(s, K.If):
            stack.extend(s.then_body)
            stack.extend(s.else_body)
        elif isinstance(s, K.While):
            stack.extend(s.body)
    while estack:
        e = estack.pop()
        if isinstance(e, K.LoadGlobal):
            out.add(e.array)
        estack.extend(K.expr_children(e))
    return out


def _stored_in_while(instrs, in_while: bool = False) -> Set[str]:
    """Global arrays stored from inside a While body (the reference's
    log entries cannot escape a ``lax.while`` trace; the port keeps its
    classification)."""
    out: Set[str] = set()
    for s in instrs:
        if isinstance(s, K.StoreGlobal) and in_while:
            out.add(s.array)
        elif isinstance(s, K.If):
            out |= _stored_in_while(s.then_body, in_while)
            out |= _stored_in_while(s.else_body, in_while)
        elif isinstance(s, K.While):
            out |= _stored_in_while(s.body, True)
    return out


@dataclasses.dataclass(frozen=True)
class _PRPlan:
    """Static per-block-level-PR plan of the batched warp plane: what to
    copy, mask and merge, and which stores go through the replay log."""

    block_vars: Tuple[str, ...]  # block-replicated vars written
    shared: Tuple[str, ...]  # shared arrays written (mask + merge)
    masked: Tuple[str, ...]  # globals on the copy/mask/merge path
    atomics: Tuple[str, ...]  # atomic targets (delta merge)
    logged: Tuple[str, ...]  # globals on the store-log path


def _pr_plan(ck: CompiledKernel, node: BlockPR) -> _PRPlan:
    """Write sets and store-log eligibility of one block-level PR.

    An array's stores go through the log when the warp graph is linear,
    every store to it sits outside While bodies, the PR never *loads* it
    (a logged store skips the per-warp copy, so a same-lane reload would
    read stale data), and it is not an atomic target in this PR."""
    wv: Set[str] = set()
    g: Set[str] = set()
    sh: Set[str] = set()
    at: Set[str] = set()
    loads: Set[str] = set()
    in_while: Set[str] = set()
    for bname in node.blocks:
        instrs = ck.cfg.blocks[bname].instrs
        w, a, s, t = _written_names(instrs)
        wv |= w
        g |= a
        sh |= s
        at |= t
        loads |= _loaded_globals(instrs)
        in_while |= _stored_in_while(instrs)
    bvw = {v for v in wv if ck.classes.get(v) == "block"}
    logged: Set[str] = set()
    if _try_linear(node.warp) is not None:
        logged = (g - at) - loads - in_while
    return _PRPlan(
        tuple(sorted(bvw)),
        tuple(sorted(sh)),
        tuple(sorted(g - logged)),
        tuple(sorted(at)),
        tuple(sorted(logged)),
    )


# ---------------------------------------------------------------------------
# PC machines over copies
# ---------------------------------------------------------------------------
#
# The reference gets a program counter per copy from vmap of
# lax.while_loop/lax.switch.  Here a machine keeps one PC per copy on the
# host (and a device twin, to build copy masks without a transfer).
# While every live copy sits at one node the node runs once for all of
# them; when a peel sends them apart, each step runs the lowest node some
# copy sits at, under the mask of the copies there, until every copy has
# left the machine.


def _host_flags(t: torch.Tensor) -> np.ndarray:
    """One counted host read of a bool tensor, flattened."""
    global host_syncs
    host_syncs += 1
    return t.reshape(-1).cpu().numpy()


def _branch(flag: torch.Tensor, sel: np.ndarray, shape, on_true: int, on_false: int):
    """Next PCs at a peel: an int when the selected copies agree, else
    ``(host PCs, device PCs)`` per copy."""
    flag = flag.to(torch.bool).expand(shape)
    host = _host_flags(flag)
    taken = host[sel]
    if taken.all():
        return on_true
    if not taken.any():
        return on_false
    return (
        np.where(host, on_true, on_false),
        torch.where(flag, on_true, on_false).to(torch.int64),
    )


def _walk(n_nodes: int, entry: int, step, shape, live, device):
    """Run a PC machine whose nodes are ``0 .. n_nodes - 1`` over the
    copies of ``shape``; a PC of ``n_nodes`` or more has left it.
    ``step(pc, sel, mask)`` runs node ``pc`` for the copies ``sel``
    (host flags) under the device copy mask ``mask`` (``None``: every
    copy) and returns the next PC as an int or per copy (``_branch``).
    Returns the final PCs, on the host and (several copies) the device."""
    n = _prod(shape)
    live_h = None if live is None else live[0]
    live_d = None if live is None else live[1]
    n_live = n if live_h is None else int(live_h.sum())
    pcs = np.full(n, entry, dtype=np.int64)
    pcs_d = torch.full(shape, entry, dtype=torch.int64, device=device) if n > 1 else None
    while True:
        todo = pcs < n_nodes if live_h is None else (pcs < n_nodes) & live_h
        if not todo.any():
            return pcs, pcs_d
        p = int(pcs[todo].min())
        sel = todo & (pcs == p)
        if int(sel.sum()) == n_live:  # every live copy is here
            mask = live_d
        else:
            mask = pcs_d == p if live_d is None else (live_d & (pcs_d == p))
        nxt = step(p, sel, mask)
        if isinstance(nxt, int):
            pcs[sel] = nxt
            if pcs_d is not None:
                pcs_d = torch.where(mask, nxt, pcs_d) if mask is not None else (
                    torch.full_like(pcs_d, nxt)
                )
        else:
            host, dev = nxt
            pcs = np.where(sel, host, pcs)
            pcs_d = dev if mask is None else torch.where(mask, dev, pcs_d)


def _result(host: np.ndarray, dev, live):
    """A per-copy machine result as an int when the live copies agree,
    else ``(host, device)``."""
    vals = host if live is None else host[live[0]]
    if vals.size == 0 or (vals == vals[0]).all():
        return int(vals[0]) if vals.size else 0
    return host, dev


def run_warp_graph(node: BlockPR, env: _Env, *, jit_mode: bool):
    """Execute the block-level PR's warp-level region graph for every
    copy of ``env``.  Returns the exit index (which block-level
    successor to take): an int, or ``(host, device)`` per copy when the
    copies leave by different exits."""
    g = node.warp
    linear = _try_linear(g)
    if linear is not None:
        for wnode in linear:
            exec_instrs_of_warp_pr(wnode, env, jit_mode=jit_mode)
        return linear[-1].succ[1]

    n_nodes = len(g.nodes)

    def enc(target) -> int:
        kind, val = target
        return val if kind == "node" else n_nodes + val

    def step(pc, sel, mask):
        env.copy_mask = None if mask is None else mask.unsqueeze(-1)
        wnode = g.nodes[pc]
        if isinstance(wnode, WarpPR):
            exec_instrs_of_warp_pr(wnode, env, jit_mode=jit_mode)
            return enc(wnode.succ)
        # WarpPeel -- loop peeling: each copy's lane 0 decides (paper 3.3.1)
        flag = env.read_var(wnode.cond)[..., 0]
        return _branch(flag, sel, env.shape[:-1], enc(wnode.on_true), enc(wnode.on_false))

    pcs, pcs_d = _walk(n_nodes, g.entry, step, env.shape[:-1], env.live, env.device)
    return _result(pcs - n_nodes, None if pcs_d is None else pcs_d - n_nodes, env.live)


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
    track_writes: bool = False,
    warp_exec: str = "serial",
    block_dim=None,
    grid_dim=None,
    persist: Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]] = None,
):
    """Build the function that executes one CUDA block -- or a chunk of
    blocks at once.

    ``f(uniforms, globals_[, state])``: ``uniforms`` holds 0-d tensors
    for bdim, gdim and every scalar kernel parameter, and ``bid`` -- a
    0-d tensor for one block, or a ``(C,)`` tensor for a chunk of C
    blocks, which then run as a leading copy axis of every lane tensor.
    ``globals_`` holds the sink-slotted flat arrays.

    Without ``track_writes`` the blocks update ``globals_`` and it is
    returned (the serial ``scan`` path: one block, in place).  With
    ``track_writes`` (the block-parallel ``vmap`` path) ``globals_`` is
    left alone: each block runs on its own copy of every array the
    phase stores to, with write masks, and adds its atomics into delta
    buffers; ``f`` returns ``(copies, masks, deltas)``, each keyed by
    array with the chunk axis first, for ``backends/merge.py``.

    ``warp_exec='batched'`` replaces the inter-warp loop by one
    ``(n_warps, W)`` lane plane per block-level PR: every warp runs on
    its own copy of the shared and global arrays the PR writes, with
    write masks and atomic deltas, and the copies are merged at the PR's
    end (a block barrier) by the same single-writer select.  Stores to
    arrays a PR never reads go through a log replayed once after the
    plane (:func:`_pr_plan`).  Bitwise the serial loop's result for
    race-free kernels.

    ``persist=(var_names, shared_names)`` makes the function one *phase*
    of a cooperative (grid-sync) kernel: it takes ``state={"bv": {var:
    (..., n_warps, W)}, "sh": {name: (..., size)}}`` holding the blocks'
    carried locals and shared memory (leading chunk axis as ``bid``'s)
    and returns their final values as a last output.

    ``block_dim``/``grid_dim`` are the launch's static dim3 extents; they
    feed only the per-axis intrinsics.  ``None`` means a 1-D launch."""
    if warp_exec not in ("serial", "batched"):
        raise ValueError(
            f"unknown warp_exec {warp_exec!r}; expected 'serial' or 'batched'"
        )
    if ck.phases:
        raise ValueError(
            "make_block_fn runs one phase: pass a phase CompiledKernel "
            "(ck.phase_list()), not the multi-phase container"
        )
    from .backends import merge  # deferred: backends imports execute

    jit_mode = mode == "jit"
    W = ck.warp_size
    bdim3 = dim3_tuple(block_dim)
    gdim3 = dim3_tuple(grid_dim)
    block_total = bdim3[0] * bdim3[1] * bdim3[2] if bdim3 else None
    instrs = list(_all_instrs(ck))
    stored = sorted({s.array for s in instrs if isinstance(s, K.StoreGlobal)})
    atomic_targets = sorted({s.array for s in instrs if isinstance(s, K.AtomicRMW)})
    batch_warps = warp_exec == "batched" and n_warps > 1
    if batch_warps and any(isinstance(s, K.AtomicRMW) and s.dst for s in instrs):
        # LaunchPlan.check_warp_batchable refuses these first
        raise CoxUnsupported(
            "atomic old-value capture under warp-batched execution: captured "
            "old values are only unique under serial warp order -- use "
            "warp_exec='serial'"
        )
    pr_plans = (
        {n.id: _pr_plan(ck, n) for n in ck.machine.nodes if isinstance(n, BlockPR)}
        if batch_warps
        else {}
    )
    linear = _try_linear_block(ck.machine)
    n_nodes = len(ck.machine.nodes)
    consts: Dict[Any, torch.Tensor] = {}
    block_types = {
        v: ck.var_types.get(v, DType.f32).compute
        for v, c in ck.classes.items()
        if c == "block"
    }

    def block_fn(uniforms: Dict[str, Any], globals_: Dict[str, Any], state=None):
        bid = uniforms["bid"]
        bshape = tuple(bid.shape)  # copy axes of the block machine
        dev = bid.device
        bt = block_total if block_total is not None else int(uniforms["bdim"])

        def lanes_bid(extra: int):
            # bid against lane tensors with `extra` more axes than bshape
            return bid if not bshape else bid.reshape(bshape + (1,) * extra)

        u_serial = {**uniforms, "bid": lanes_bid(1)}
        u_plane = {**uniforms, "bid": lanes_bid(2)}
        zero = {dt: torch.zeros(W, dtype=dt, device=dev) for dt in set(block_types.values())}
        if batch_warps:
            bv: Dict[str, Any] = {
                v: zero[dt].expand(bshape + (n_warps, W)) for v, dt in block_types.items()
            }
        else:
            bv = {v: [zero[dt]] * n_warps for v, dt in block_types.items()}
        sh = {
            s.name: torch.zeros(
                bshape + (_prod(s.shape) + 1,), dtype=s.dtype.compute, device=dev
            )
            for s in ck.kernel.shared
        }
        if persist is not None:
            if state is None:
                raise ValueError(
                    "persist block fn needs state= (carried per-block "
                    "locals + shared memory)"
                )
            for v in persist[0]:
                plane = state["bv"][v]
                bv[v] = plane if batch_warps else list(plane.unbind(-2))
            sh.update({s: with_sink(state["sh"][s]) for s in persist[1]})
        if track_writes:
            g = dict(globals_)
            for k in stored:
                g[k] = globals_[k].expand(bshape + globals_[k].shape).clone()
            sm = merge.zeros_masks({k: globals_[k] for k in stored}, bshape)
            ad = merge.zeros_deltas({k: globals_[k] for k in atomic_targets}, bshape)
        else:
            g, sm, ad = globals_, {}, {}

        def env_for(wid, shape, uniforms_, mem, **kw):
            return _Env(
                ck,
                wid=wid,
                shape=shape,
                uniforms=uniforms_,
                block_vars=bv,
                shmem=mem[0],
                globals_=mem[1],
                simd=simd,
                consts=consts,
                block_total=bt,
                block_dim3=bdim3,
                grid_dim3=gdim3,
                **kw,
            )

        def run_warp_plane(node: BlockPR, live):
            """All warps of one block-level PR as one ``(n_warps, W)``
            lane plane (per block of the chunk).  Sound because warps are
            independent between barriers and a block-level PR boundary is
            a barrier.  Each warp runs on its own copy of the shared and
            global arrays the PR writes; the copies merge here.  Block-
            replicated vars are written only at each warp's own row, so
            the plane is already merged.  All warps of a block reach the
            same exit under the aligned-barrier assumption; warp 0's is
            taken."""
            plan = pr_plans[node.id]
            wshape = bshape + (n_warps,)

            def per_warp(t):
                return t.unsqueeze(-2).expand(wshape + t.shape[-1:]).clone()

            g_w = {k: per_warp(g[k]) for k in plan.masked}
            sh_w = {k: per_warp(sh[k]) for k in plan.shared}
            if track_writes:
                # the block's deltas so far, so loads see its earlier atomics
                ad_w = {k: per_warp(ad[k]) for k in plan.atomics}
            else:
                ad_w = merge.zeros_deltas({k: g[k] for k in plan.atomics}, wshape)
            wlive = None
            if live is not None:
                wlive = (np.repeat(live[0], n_warps), live[1].unsqueeze(-1).expand(wshape))
            wids = consts.get(("wids", n_warps))
            if wids is None:
                wids = torch.arange(n_warps, dtype=torch.int32, device=dev)
                wids = consts[("wids", n_warps)] = wids.reshape(n_warps, 1)
            env = env_for(
                wids,
                wshape + (W,),
                u_plane,
                ({**sh, **sh_w}, {**g, **g_w}),
                block_rows=True,
                track_writes=True,
                store_masks=merge.zeros_masks(g_w, wshape),
                atomic_deltas={**ad, **ad_w},
                shared_masks=merge.zeros_masks(sh_w, wshape),
                log_arrays=set(plan.logged),
                live=wlive,
            )
            ex = run_warp_graph(node, env, jit_mode=jit_mode)
            for k in plan.shared:
                sh[k], _ = merge.select_writer(
                    sh[k], sh_w[k], env.shared_masks[k], axis=-2
                )
            if track_writes:
                new_d = {k: merge.wrap(ad_w[k] - ad[k].unsqueeze(-2)) for k in plan.atomics}
                g_new, wrote, dsum = merge.merge_chunk(
                    {k: g[k] for k in plan.masked},
                    g_w,
                    env.store_masks,
                    new_d,
                    fold_deltas=False,
                    axis=-2,
                )
                for k in stored:
                    if k in wrote:
                        g[k], sm[k] = g_new[k], sm[k] | wrote[k]
                for k, d in dsum.items():
                    ad[k] = merge.wrap(ad[k] + d)
            else:
                g_new, _, _ = merge.merge_chunk(
                    {k: g[k] for k in plan.masked},
                    g_w,
                    env.store_masks,
                    ad_w,
                    fold_deltas=True,
                    axis=-2,
                )
                g.update(g_new)
            # the store log: one flat scatter per logged store (the
            # single-writer contract makes the warps' lanes disjoint;
            # masked-off lanes carry the sink index)
            for name, idx, val in env.store_log:
                offs = _offsets(g[name], len(wshape), consts)
                _scatter(g[name], idx, val, offs)
                if track_writes:
                    _scatter(sm[name], idx, env.const(True, torch.bool), offs)
            if isinstance(ex, int):
                return ex
            host, dev_ex = ex
            return _result(host.reshape(-1, n_warps)[:, 0], dev_ex[..., 0], live)

        def run_block_pr(node: BlockPR, live):
            """One block-level PR: the inter-warp loop (paper's Code 3
            outer loop), or the batched warp plane.  Returns the exit
            index of the last warp (warp 0's on the plane)."""
            if batch_warps:
                return run_warp_plane(node, live)
            ex = 0
            for wid in range(n_warps):
                env = env_for(
                    wid,
                    bshape + (W,),
                    u_serial,
                    (sh, g),
                    track_writes=track_writes,
                    store_masks=sm,
                    atomic_deltas=ad,
                    live=live,
                )
                ex = run_warp_graph(node, env, jit_mode=jit_mode)
            return ex

        def block_step(pc, sel, mask):
            node = ck.machine.nodes[pc]
            live = None if mask is None else (sel, mask)
            if isinstance(node, BlockPR):
                return _succ(node, run_block_pr(node, live))
            # BlockPeel -- each block's warp 0 lane 0 decides
            rows = bv[node.cond]
            flag = rows[..., 0, 0] if batch_warps else rows[0][..., 0]
            t, f = (n_nodes if i == EXIT else i for i in (node.t_id, node.f_id))
            return _branch(flag, sel, bshape, t, f)

        if linear is not None:
            for node in linear:
                run_block_pr(node, None)
        else:
            _walk(n_nodes, ck.machine.entry, block_step, bshape, None, dev)
        if track_writes:
            out = ({k: g[k] for k in stored}, sm, ad)
        else:
            out = (g,)
        if persist is not None:
            rows = {
                v: bv[v]
                if batch_warps
                else torch.stack([r.expand(bshape + (W,)) for r in bv[v]], dim=-2)
                for v in persist[0]
            }
            out += ({"bv": rows, "sh": {s: sh[s][..., :-1] for s in persist[1]}},)
        return out if len(out) > 1 else out[0]

    def _succ(node: BlockPR, ex):
        """Block-level successor(s) of a PR's exit index."""
        succ = [n_nodes if s == EXIT else s for s in node.succ_ids] or [n_nodes]
        if isinstance(ex, int):
            return succ[min(max(ex, 0), len(succ) - 1)]
        host, dev_ex = ex
        key = ("succ", node.id, dev_ex.device)
        table = consts.get(key)
        if table is None:
            table = consts[key] = torch.tensor(succ, dtype=torch.int64, device=dev_ex.device)
        return (
            np.asarray(succ)[np.clip(host, 0, len(succ) - 1)],
            table[dev_ex.clamp(0, len(succ) - 1)],
        )

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


def walk_instrs(ck: CompiledKernel):
    """Every instruction of the kernel, descending into If/While (and
    into every phase of a multi-phase compilation)."""
    return _all_instrs(ck)


def _all_instrs(ck: CompiledKernel):
    for sub in ck.phase_list():
        for blk in sub.cfg.blocks.values():
            stack = list(blk.instrs)
            while stack:
                s = stack.pop()
                yield s
                if isinstance(s, K.If):
                    stack.extend(s.then_body)
                    stack.extend(s.else_body)
                elif isinstance(s, K.While):
                    stack.extend(s.body)
