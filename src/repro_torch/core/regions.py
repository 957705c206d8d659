# fmt: off
"""Hierarchical Parallel Regions (paper §3.5, Fig. 7) and the two-level
machine the executor runs.

Partitioning (constructive form of Algorithm 2):

* **block level** — cut every out-edge of a block ending with a *block*
  barrier; isolate pure-branch blocks whose branch level is BLOCK (they
  become block-level peel nodes).  Connected components of what remains
  are the block-level PRs.  A block-level PR may contain warp-level
  control flow inside it — that is exactly the hierarchy of Fig. 7.
* **warp level, within each block-level PR** — cut every out-edge of a
  block ending with *any* barrier; isolate every remaining pure-branch
  block (warp-level peel).  Components are the warp-level PRs; by
  construction each is a straight Jmp-chain (all barrier-free divergence
  was predicated by the frontend).

The executor wraps each block-level PR in one inter-warp loop and runs
its warp-level machine per warp — the generated-code shape of Code 3 —
or, under warp-batched execution, runs all warps of the PR at once as a
(n_warps, W) lane plane (``execute.py``).  Warp-peel nodes resolve
their branch direction from lane 0 of the condition; in the batched
plane that decision becomes **per-warp** — each warp's lane 0 steers
that warp's own PC through the warp graph, so warps may sit at
different peel targets simultaneously (vmap's masked while/switch
batching keeps finished warps frozen).

Invariant (paper: "a warp-level PR is always a subset of a block-level
PR"): holds by construction and is property-tested.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from . import kernel_ir as K
from .cfg import CFG, Block, Br, Jmp, Ret, WarpBufCompute, WarpBufStore
from .types import BarrierLevel, CoxUnsupported

EXIT = -1  # sentinel node id


# ------------------------------ warp level ---------------------------------

WTarget = Tuple[str, int]  # ("node", id) | ("exit", exit_ix)


@dataclasses.dataclass
class WarpPR:
    id: int
    blocks: List[str]           # chain order
    succ: WTarget = ("exit", 0)


@dataclasses.dataclass
class WarpPeel:
    id: int
    cond: str
    on_true: WTarget = ("exit", 0)
    on_false: WTarget = ("exit", 0)


@dataclasses.dataclass
class WarpGraph:
    nodes: List[object]
    entry: int
    exit_targets: List[str]     # CFG block names outside the block-level PR
    # exit_targets[i] is where exit_ix == i continues at block level


# ------------------------------ block level --------------------------------


@dataclasses.dataclass
class BlockPR:
    id: int
    blocks: Set[str]
    entry_block: str
    warp: WarpGraph = None  # type: ignore
    succ_ids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BlockPeel:
    id: int
    cond: str
    t_id: int = EXIT
    f_id: int = EXIT


@dataclasses.dataclass
class Machine:
    nodes: List[object]
    entry: int
    cfg: CFG


def warp_peel_count(machine: Machine) -> int:
    """Number of warp-level peel nodes across all block-level PRs — the
    lane-0-resolved branches whose directions become per-warp under
    warp-batched execution.  0 means every warp graph is a straight
    chain and the batched plane never diverges at the PC level."""
    n = 0
    for node in machine.nodes:
        if isinstance(node, BlockPR) and node.warp is not None:
            n += sum(isinstance(w, WarpPeel) for w in node.warp.nodes)
    return n


# ----------------------------------------------------------------------------


class _UF:
    def __init__(self, items):
        self.p = {i: i for i in items}

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        self.p[self.find(a)] = self.find(b)


def _ends_with_barrier(blk: Block, level: BarrierLevel) -> bool:
    if not blk.instrs or not isinstance(blk.instrs[-1], K.Barrier):
        return False
    if level == BarrierLevel.WARP:
        return True  # any barrier ends a warp-level PR
    # block-level cut: block barriers and anything wider (a grid barrier
    # may never be collapsed across — defensive; compile_kernel splits
    # phases before a GRID barrier can reach the region machine)
    return blk.instrs[-1].level >= BarrierLevel.BLOCK


def _components(cfg: CFG, members: Set[str], cut_level: BarrierLevel,
                peels: Set[str]) -> Dict[str, int]:
    """Union-find components of `members` under the cut rules."""
    uf = _UF(members)
    for u in members:
        if u in peels:
            continue
        blk = cfg.blocks[u]
        if _ends_with_barrier(blk, cut_level):
            continue
        for v in blk.term.targets():
            if v in members and v not in peels:
                uf.union(u, v)
    comp: Dict[str, int] = {}
    remap: Dict[str, int] = {}
    for b in members:
        if b in peels:
            continue
        r = uf.find(b)
        if r not in remap:
            remap[r] = len(remap)
        comp[b] = remap[r]
    return comp


def build_machine(cfg: CFG) -> Machine:
    all_blocks = set(cfg.blocks.keys())
    block_peels = {n for n, b in cfg.blocks.items()
                   if b.is_pure_branch() and b.term.level == BarrierLevel.BLOCK}
    comp = _components(cfg, all_blocks, BarrierLevel.BLOCK, block_peels)

    nodes: List[object] = []
    comp_node: Dict[int, BlockPR] = {}
    peel_node: Dict[str, BlockPeel] = {}

    comp_blocks: Dict[int, Set[str]] = {}
    for b, c in comp.items():
        comp_blocks.setdefault(c, set()).add(b)

    # allocate node ids deterministically: components in order of their
    # first block in CFG insertion order, then peels
    order = []
    seen_c = set()
    for name in cfg.blocks:
        if name in block_peels:
            order.append(("peel", name))
        else:
            c = comp[name]
            if c not in seen_c:
                seen_c.add(c)
                order.append(("comp", c))

    def node_id_of_block(name: str) -> int:
        if name in block_peels:
            return peel_node[name].id
        return comp_node[comp[name]].id

    for kind, key in order:
        nid = len(nodes)
        if kind == "comp":
            blocks = comp_blocks[key]
            entry = _component_entry(cfg, blocks)
            node = BlockPR(nid, blocks, entry)
            comp_node[key] = node
        else:
            br: Br = cfg.blocks[key].term  # type: ignore
            node = BlockPeel(nid, br.cond)
            peel_node[key] = node
        nodes.append(node)

    # resolve edges
    for kind, key in order:
        if kind == "peel":
            name = key
            br: Br = cfg.blocks[name].term  # type: ignore
            pn = peel_node[name]
            pn.t_id = node_id_of_block(br.true)
            pn.f_id = node_id_of_block(br.false)
        else:
            node = comp_node[key]
            node.warp = _build_warp_graph(cfg, node)
            succ_ids = []
            for tgt in node.warp.exit_targets:
                succ_ids.append(EXIT if tgt == "@ret" else node_id_of_block(tgt))
            node.succ_ids = succ_ids

    entry_id = node_id_of_block(cfg.entry)
    return Machine(nodes, entry_id, cfg)


def _component_entry(cfg: CFG, blocks: Set[str]) -> str:
    if cfg.entry in blocks:
        return cfg.entry
    entries = set()
    for name in blocks:
        for p in cfg.preds(name):
            if p not in blocks:
                entries.add(name)
    if len(entries) != 1:
        raise CoxUnsupported(
            f"parallel region with {len(entries)} entries ({sorted(entries)}) — "
            f"irreducible control flow is outside the supported set")
    return entries.pop()


# ----------------------------------------------------------------------------


def _build_warp_graph(cfg: CFG, bpr: BlockPR) -> WarpGraph:
    members = bpr.blocks
    peels = {n for n in members if cfg.blocks[n].is_pure_branch()}
    comp = _components(cfg, members, BarrierLevel.WARP, peels)

    comp_blocks: Dict[int, List[str]] = {}
    for b, c in comp.items():
        comp_blocks.setdefault(c, []).append(b)

    nodes: List[object] = []
    comp_node: Dict[int, WarpPR] = {}
    peel_node: Dict[str, WarpPeel] = {}
    exit_targets: List[str] = []

    order = []
    seen_c = set()
    for name in cfg.blocks:
        if name not in members:
            continue
        if name in peels:
            order.append(("peel", name))
        else:
            c = comp[name]
            if c not in seen_c:
                seen_c.add(c)
                order.append(("comp", c))

    for kind, key in order:
        nid = len(nodes)
        if kind == "comp":
            chain = _chain_order(cfg, set(comp_blocks[key]), members)
            node = WarpPR(nid, chain)
            comp_node[key] = node
        else:
            br: Br = cfg.blocks[key].term  # type: ignore
            node = WarpPeel(nid, br.cond)
            peel_node[key] = node
        nodes.append(node)

    def target_of(name: str) -> WTarget:
        if name in members:
            if name in peels:
                return ("node", peel_node[name].id)
            return ("node", comp_node[comp[name]].id)
        if name not in exit_targets:
            exit_targets.append(name)
        return ("exit", exit_targets.index(name))

    for kind, key in order:
        if kind == "peel":
            br = cfg.blocks[key].term
            pn = peel_node[key]
            pn.on_true = target_of(br.true)
            pn.on_false = target_of(br.false)
        else:
            node = comp_node[key]
            last = cfg.blocks[node.blocks[-1]]
            if isinstance(last.term, Ret):
                if "@ret" not in exit_targets:
                    exit_targets.append("@ret")
                node.succ = ("exit", exit_targets.index("@ret"))
            elif isinstance(last.term, Jmp):
                node.succ = target_of(last.term.target)
            else:
                raise CoxUnsupported(
                    f"warp PR {node.blocks} ends in a branch with instructions — "
                    f"violates the pure-branch invariant")

    entry = target_of(bpr.entry_block)
    assert entry[0] == "node"
    return WarpGraph(nodes, entry[1], exit_targets)


def _chain_order(cfg: CFG, blocks: Set[str], region: Set[str]) -> List[str]:
    """Warp-level PRs are Jmp-chains; order them by walking."""
    entries = [b for b in blocks
               if not any(p in blocks for p in cfg.preds(b))]
    # a single-block self-contained component has itself as entry
    if not entries:
        raise CoxUnsupported(f"warp PR {sorted(blocks)} has no entry (cycle "
                             f"without a barrier?)")
    if len(entries) != 1:
        raise CoxUnsupported(f"warp PR {sorted(blocks)} has multiple entries")
    chain = []
    cur: Optional[str] = entries[0]
    visited = set()
    while cur is not None and cur in blocks and cur not in visited:
        chain.append(cur)
        visited.add(cur)
        t = cfg.blocks[cur].term
        nxt = None
        if isinstance(t, Jmp) and t.target in blocks:
            nxt = t.target
        cur = nxt
    if len(chain) != len(blocks):
        raise CoxUnsupported(
            f"warp PR {sorted(blocks)} is not a chain (got {chain})")
    return chain


# ----------------------------------------------------------------------------
# Variable replication analysis (paper §3.6)
# ----------------------------------------------------------------------------


def _expr_reads(e: Optional[K.Expr], out: Set[str]):
    if e is None:
        return
    stack = [e]
    while stack:
        cur = stack.pop()
        if isinstance(cur, K.Var):
            out.add(cur.name)
        stack.extend(K.expr_children(cur))


def _instr_vars(ins, out: Set[str]):
    if isinstance(ins, K.Assign):
        out.add(ins.name)
        _expr_reads(ins.value, out)
    elif isinstance(ins, (K.StoreGlobal, K.StoreShared)):
        _expr_reads(ins.index, out)
        _expr_reads(ins.value, out)
    elif isinstance(ins, K.AtomicRMW):
        _expr_reads(ins.index, out)
        _expr_reads(ins.value, out)
        if ins.dst:
            out.add(ins.dst)
    elif isinstance(ins, WarpBufStore):
        out.add(ins.buf)
        _expr_reads(ins.value, out)
    elif isinstance(ins, WarpBufCompute):
        out.add(ins.dst)
        out.add(ins.buf)
        for a in ins.args:
            _expr_reads(a, out)
    elif isinstance(ins, K.If):
        _expr_reads(ins.cond, out)
        for s in ins.then_body + ins.else_body:
            _instr_vars(s, out)
    elif isinstance(ins, K.While):
        _expr_reads(ins.cond, out)
        for s in ins.body:
            _instr_vars(s, out)
    elif isinstance(ins, K.Barrier):
        pass


def replication_classes(machine: Machine, uniforms: Set[str]) -> Dict[str, str]:
    """Classify every local: 'block' → replicated (n_warps, W) — lives
    across block-level PRs (the paper's length-block_size arrays);
    'warp' → (W,) — confined to one block-level PR (the paper's
    length-32 arrays).  Kernel scalar params are uniform and excluded."""
    usage: Dict[str, Set[int]] = {}
    block_marked: Set[str] = set()
    for node in machine.nodes:
        if isinstance(node, BlockPeel):
            block_marked.add(node.cond)
            continue
        refs: Set[str] = set()
        for bname in node.blocks:
            for ins in machine.cfg.blocks[bname].instrs:
                _instr_vars(ins, refs)
            t = machine.cfg.blocks[bname].term
            if isinstance(t, Br):
                refs.add(t.cond)
        for v in refs:
            usage.setdefault(v, set()).add(node.id)
    classes: Dict[str, str] = {}
    for v, nodes in usage.items():
        if v in uniforms:
            continue
        if v in block_marked or len(nodes) > 1:
            classes[v] = "block"
        else:
            classes[v] = "warp"
    for v in block_marked:
        classes[v] = "block"
    # warp buffers never cross a barrier (RAW/WAR bracketing) — force warp
    for v in list(classes):
        if v.startswith(".warpbuf_"):
            classes[v] = "warp"
    return classes
