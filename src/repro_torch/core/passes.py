# fmt: off
"""The hierarchical-collapsing pass pipeline (paper §3, Fig. 4 steps 1-3).

Step 1  lower_warp_intrinsics   — warp collectives → buffer store,
                                  RAW warp barrier, collective compute,
                                  WAR warp barrier (paper §3.2, Code 5).
Step 2  insert_extra_barriers   — entry/exit barriers (POCL rule) and the
                                  conditional-construct barriers of
                                  Algorithm 1 + the for-loop rule (§3.3).
Step 3  split_blocks_at_barriers — barriers terminate their block (§3.4).

PR discovery (Fig. 4 steps 4-5 / Algorithm 2) lives in regions.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from . import kernel_ir as K
from .cfg import CFG, Block, Br, WarpBufCompute, WarpBufStore
from .types import BarrierLevel, CoxUnsupported, DType

# ----------------------------------------------------------------------------
# Step 1: warp-intrinsic lowering
# ----------------------------------------------------------------------------

_VOTE_FUNCS = {"vote_all", "vote_any", "ballot"}


def warp_buf_name(dtype: DType) -> str:
    return f".warpbuf_{dtype.value}"


def lower_warp_intrinsics(cfg: CFG, var_types: Dict[str, DType]) -> Dict[str, DType]:
    """Replace WarpCall instrs; returns {buffer name: dtype} used.

    The RAW barrier orders every lane's buffer store before the collective
    read; the WAR barrier orders the read before the *next* collective's
    store into the same (reused) buffer — exactly Code 5 in the paper.  In
    SIMD execution both are naturally satisfied by lane vectorization; in
    scalar (per-lane) execution they are real ordering points.
    """
    bufs: Dict[str, DType] = {}
    for blk in cfg.blocks.values():
        out: List = []
        for ins in blk.instrs:
            if isinstance(ins, K.WarpCall):
                src = ins.args[0]
                if ins.func in _VOTE_FUNCS:
                    bdt = DType.b1
                else:
                    bdt = src.dtype or DType.f32
                buf = warp_buf_name(bdt)
                bufs[buf] = bdt
                out.append(WarpBufStore(buf, src))
                out.append(K.Barrier(BarrierLevel.WARP, source="raw"))
                out.append(WarpBufCompute(ins.dst, ins.func, buf,
                                          list(ins.args[1:]), ins.width))
                out.append(K.Barrier(BarrierLevel.WARP, source="war"))
            else:
                out.append(ins)
        blk.instrs = out
    return bufs


# ----------------------------------------------------------------------------
# Step 2: extra barriers
# ----------------------------------------------------------------------------


def _block_barrier_level(blk: Block) -> Optional[BarrierLevel]:
    lvl: Optional[BarrierLevel] = None
    for i in blk.instrs:
        if isinstance(i, K.Barrier):
            if lvl is None or i.level.rank > lvl.rank:
                lvl = i.level
    return lvl


def _reachable_from(cfg: CFG, src: str) -> Set[str]:
    seen = {src}
    stack = [src]
    while stack:
        n = stack.pop()
        for s in cfg.succs(n):
            if s not in seen:
                seen.add(s)
                stack.append(s)
    return seen


def insert_extra_barriers(cfg: CFG):
    """Algorithm 1, adapted: walk the idom chain (robust form of the
    paper's predecessor walk) from each conditionally-executed barrier
    block up to the governing branch block; insert same-level barriers at
    the construct's head end / body end / exit begin (if-then) or around
    the back edge (canonical loop).  Fixpoint until no new conditional
    barrier blocks appear."""
    # POCL-style entry/exit barriers first (paper §3.3).
    ent = cfg.blocks[cfg.entry]
    ent.instrs.insert(0, K.Barrier(BarrierLevel.BLOCK, source="entry"))
    ext = cfg.blocks[cfg.exit]
    ext.instrs.append(K.Barrier(BarrierLevel.BLOCK, source="exit"))

    processed: Set[Tuple[str, str]] = set()  # (branch block, level)
    for _round in range(64):
        dt = cfg.dom_tree()
        pdt = cfg.postdom_tree()
        work = [name for name, blk in cfg.blocks.items()
                if _block_barrier_level(blk) is not None
                and not pdt.dominates(name, cfg.entry)]
        changed = False
        for name in work:
            level = _block_barrier_level(cfg.blocks[name])
            assert level is not None
            # --- find the governing branch block via the idom chain ---
            cur = dt.idom.get(name)
            while cur is not None and pdt.dominates(name, cur):
                cur = dt.idom.get(cur)
            if cur is None or not isinstance(cfg.blocks[cur].term, Br):
                continue  # not governed by a conditional (e.g. already fixed)
            key = (cur, level.value)
            if key in processed:
                continue
            processed.add(key)
            changed = True
            is_loop = cur in _reachable_from(cfg, name)  # back edge to the cond
            if is_loop:
                _barriers_for_loop(cfg, cur, level)
            else:
                _barriers_for_if(cfg, cur, name, level, dt, pdt)
        if not changed:
            break
    else:
        raise CoxUnsupported("extra-barrier insertion did not converge")


def _append_barrier(blk: Block, level: BarrierLevel):
    if blk.instrs and isinstance(blk.instrs[-1], K.Barrier) \
            and blk.instrs[-1].level >= level:
        return
    blk.instrs.append(K.Barrier(level, source="extra"))


def _prepend_barrier(blk: Block, level: BarrierLevel):
    if blk.instrs and isinstance(blk.instrs[0], K.Barrier) \
            and blk.instrs[0].level >= level:
        return
    blk.instrs.insert(0, K.Barrier(level, source="extra"))


def _barriers_for_if(cfg: CFG, condbr: str, barrier_block: str,
                     level: BarrierLevel, dt, pdt):
    """Paper Alg. 1: barrier at end of if-head, end of if-body,
    beginning of if-exit — all at the inner barrier's level.  The if-exit
    is the immediate post-dominator of the branch block; the if-body ends
    at the join's predecessors dominated by the taken arm (robust to
    nesting, unlike the raw predecessor walk in the paper's pseudocode)."""
    br: Br = cfg.blocks[condbr].term  # type: ignore
    # end of if-head: every predecessor of the (pure) branch block
    for p in cfg.preds(condbr):
        _append_barrier(cfg.blocks[p], level)
    join = pdt.idom.get(condbr)
    if join is None:
        return
    # which arm contains the barrier block?
    side = br.true if dt.dominates(br.true, barrier_block) else br.false
    # end of if-body: join predecessors inside that arm
    for p in cfg.preds(join):
        if dt.dominates(side, p):
            _append_barrier(cfg.blocks[p], level)
    # beginning of if-exit
    _prepend_barrier(cfg.blocks[join], level)


def _barriers_for_loop(cfg: CFG, condbr: str, level: BarrierLevel):
    """Paper §3.3.2: barriers before/after the loop's back-edge branch.
    With canonical loops (header = cond eval block, single latch) this is:
    begin of header (covers preheader entry and each next iteration) and
    end of the latch; plus begin of the loop exit."""
    br: Br = cfg.blocks[condbr].term  # type: ignore
    header = None
    for p in cfg.preds(condbr):
        header = p  # canonical: single pred (the cond-eval header)
    assert header is not None, "canonical loop must have a cond-eval header"
    _prepend_barrier(cfg.blocks[header], level)
    for p in cfg.preds(header):
        _append_barrier(cfg.blocks[p], level)   # latch end + preheader end
    # loop exit: the Br target that does not re-enter the loop
    body, exit_b = br.true, br.false
    _prepend_barrier(cfg.blocks[exit_b], level)


# ----------------------------------------------------------------------------
# Step 3: split blocks at barriers
# ----------------------------------------------------------------------------


def split_blocks_at_barriers(cfg: CFG):
    """After this pass every barrier is the *last* instruction of its
    block (paper §3.4), so PRs are unions of whole blocks."""
    work = list(cfg.blocks.keys())
    while work:
        name = work.pop()
        blk = cfg.blocks[name]
        for i, ins in enumerate(blk.instrs):
            if isinstance(ins, K.Barrier) and i != len(blk.instrs) - 1:
                nb = cfg.split_after(name, i, hint="bar")
                work.append(nb)
                break


# ----------------------------------------------------------------------------
# Algorithm 2 (literal) — used for validation in tests
# ----------------------------------------------------------------------------


def find_parallel_regions_alg2(cfg: CFG, level: BarrierLevel) -> List[frozenset]:
    """A direct transliteration of the paper's Algorithm 2 ("Find all
    warp-level PRs"; block-level variant considers only block barriers).
    regions.py computes the same partition constructively; tests assert
    they agree."""
    def is_end_block(blk: Block) -> bool:
        lvl = _block_barrier_level(blk)
        if lvl is None:
            return False
        return True if level == BarrierLevel.WARP else lvl >= BarrierLevel.BLOCK

    pr_set: List[frozenset] = []
    end_blocks = [n for n, b in cfg.blocks.items() if is_end_block(b)]
    pm = cfg.pred_map()
    for name in end_blocks:
        pr = {name}
        pending = list(pm[name])
        visited = set()
        while pending:
            cur = pending.pop(0)
            if cur in visited:
                continue
            visited.add(cur)
            if is_end_block(cfg.blocks[cur]):
                continue
            if cfg.blocks[cur].is_pure_branch():
                continue  # loop-peeling blocks belong to no PR
            pr.add(cur)
            pending.extend(pm[cur])
        pr_set.append(frozenset(pr))
    return pr_set
