"""CUDA graphs: stream capture -> instantiate -> replay (port of the
reference's ``graphs.py``).

CUDA's answer to per-launch overhead is ``cudaGraph_t``: record a
stream's schedule once, bake it into an executable, then relaunch the
whole DAG with one host call.  The reference stages the captured DAG as
one jitted XLA program; here, on the card, it is a
``torch.cuda.CUDAGraph``:

* static input buffers are filled from the captured bindings (the
  arrays flat with their sink slot, the scalars 0-d);
* a warm-up pass of the nodes runs on a side stream, as torch requires
  (it also fills each runner's cached constants, so the capture makes no
  copy from host memory);
* the nodes' runners are captured in node order, each on fresh copies of
  its inputs (a runner updates its globals in place), producer outputs
  threading into consumer bindings;
* a replay copies the rebound values into the static inputs, calls
  ``graph.replay()`` on the current stream and returns **clones** of the
  static outputs.  The reference's replay is pure and returns fresh
  outputs; the serving pipeline feeds ``res["hist"]`` back in as the next
  replay's ``hist``, so an aliased static buffer would be overwritten
  under it.

On the CPU, :meth:`GraphExec.replay` runs the captured nodes in order
(the device decides that, never a failure).

**Kernels that read the host.**  The executor decides some control flow
on the host (a peel, a lane-divergent masked loop: ``execute.
_host_bool`` / ``_host_flags``), and a CUDA graph cannot capture a
device-to-host read.  The warm-up counts each node's host reads; a node
that makes any (for instance a loop over 256 past the jit unroll limit
of 64, or a ``grid_sync`` phase walk) makes ``instantiate`` raise
``CoxUnsupported`` on the card, naming the kernel and the host read.
Such a kernel is launched eagerly on a stream instead.  A capture that
fails for any other reason raises ``CoxUnsupported`` too.  Neither ever
takes the replay -> eager rung of the degradation ladder: that rung is
for injected and transient faults, and ``CoxUnsupported`` is a user
error there, which takes no fallback.

* :class:`~types.GraphRef` -- capture-time placeholder for a captured
  launch's output; passing one to a later captured launch records a
  *data edge*.
* :class:`GraphNode` / :class:`GraphNodeHandle` -- one captured
  ``LaunchRequest`` and its handle.
* :class:`Graph` -- ``capture()`` context manager (or
  ``stream.begin_capture()`` / ``end_capture()``), ``instantiate()``,
  ``replay(**bindings)``.
* :class:`GraphExec` -- an instantiated graph: the staged executable
  plus this instantiation's current input bindings (rebinding at replay
  is ``cudaGraphExecKernelNodeSetParams``).

The executable joins the dispatcher's shared staging LRU, keyed by the
captured DAG's per-node keys: two structurally identical captures stage
once.  Replay semantics follow CUDA: inputs not rebound keep their
values, rebindings persist across replays.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import errors as _errors
from . import execute as _execute
from . import faults as _faults
from . import streams as _streams
from .backends.plan import _to_tensor, flat_outputs
from .execute import with_sink
from .types import ArraySpec, CoxTypeError, CoxUnsupported, GraphRef

_names = itertools.count()


class GraphNode:
    """One captured launch: the request plus its schedule edges (stream
    program order + captured event edges + data edges), as node-index
    deps.  Capture order is a topological order by construction."""

    __slots__ = ("graph", "idx", "req", "deps", "label")

    def __init__(self, graph: "Graph", idx: int, req, deps: Tuple[int, ...], label: str):
        self.graph = graph
        self.idx = idx
        self.req = req
        self.deps = deps
        self.label = label

    def __repr__(self):
        return f"GraphNode({self.idx}:{self.label})"


class GraphNodeHandle:
    """Capture-mode stand-in for :class:`~streams.LaunchHandle`:
    ``.outputs`` / ``.arrays()`` hand back :class:`~types.GraphRef`
    placeholders (flat / reshaped) so dependent launches chain the same
    way whether the stream is capturing or not.  ``result()`` /
    ``done()`` raise: captured work has no results until replay."""

    __slots__ = ("node",)

    def __init__(self, node: GraphNode):
        self.node = node

    @property
    def request(self):
        return self.node.req

    @property
    def graph(self) -> "Graph":
        return self.node.graph

    @property
    def stream(self):
        return self.node.req.stream

    def _refs(self, flat: bool) -> Dict[str, GraphRef]:
        req = self.node.req
        out = {}
        for s in req.ck.kernel.params:
            if not isinstance(s, ArraySpec):
                continue
            shape = tuple(req.shapes[s.name])
            if flat:
                n = 1
                for d in shape:
                    n *= int(d)
                shape = (n,)
            out[s.name] = GraphRef(self.node, s.name, shape, s.dtype)
        return out

    @property
    def outputs(self) -> Dict[str, GraphRef]:
        """Flat placeholders, the async chaining endpoint."""
        return self._refs(flat=True)

    def arrays(self) -> Dict[str, GraphRef]:
        """Reshaped placeholders, what ``kern.launch`` returns."""
        return self._refs(flat=False)

    def done(self) -> bool:
        raise CoxUnsupported(
            f"{self.node!r} was captured, not launched -- captured work runs "
            f"only at graph.replay(); there is no completion to query"
        )

    def result(self):
        raise CoxUnsupported(
            f"{self.node!r} was captured, not launched -- captured work runs "
            f"only at graph.replay(); take outputs from the replay's return value"
        )


class Graph:
    """A captured launch DAG (CUDA ``cudaGraph_t``).

    Build one with :meth:`capture` (or ``stream.begin_capture(graph)``);
    :meth:`instantiate` stages it; :meth:`replay` runs it with optionally
    rebound inputs.  A graph is immutable once instantiated."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"graph{next(_names)}"
        self.nodes: List[GraphNode] = []
        self._tails: Dict[Any, GraphNode] = {}  # stream -> captured tail
        self._streams: set = set()  # currently capturing
        self._disp = None
        self._exec: Optional["GraphExec"] = None
        self._frozen = False

    def __repr__(self):
        return f"Graph({self.name!r}, nodes={len(self.nodes)})"

    def __len__(self):
        return len(self.nodes)

    # ------------- capture bookkeeping (driven by Stream) -------------

    def _attach_stream(self, stream) -> None:
        if self._frozen:
            raise CoxUnsupported(
                f"{self!r} is already instantiated -- an instantiated graph is "
                f"immutable; capture into a fresh Graph"
            )
        if self._disp is None:
            self._disp = stream.dispatcher
        elif stream.dispatcher is not self._disp:
            raise CoxUnsupported(f"{self!r}: all capturing streams must share one dispatcher")
        self._streams.add(stream)

    def _detach_stream(self, stream) -> None:
        self._streams.discard(stream)

    def _tail_node(self, stream) -> Optional[GraphNode]:
        return self._tails.get(stream)

    @contextlib.contextmanager
    def capture(self, *streams):
        """Capture launches issued on ``streams`` (default: the default
        stream) into this graph for the ``with`` block."""
        from . import streams as _streams

        if not streams:
            streams = (_streams.get_dispatcher().default,)
        for s in streams:
            s.begin_capture(self)
        try:
            yield self
        finally:
            for s in streams:
                if s._capture is self:
                    s.end_capture()

    def add_request(self, req, *, stream) -> GraphNodeHandle:
        """Record one launch as a graph node (``Stream.launch`` calls it
        while capturing).  Schedule edges: the stream's captured tail
        and pending captured event edges; data edges: every
        :class:`GraphRef` argument."""
        if req.donate:
            raise CoxUnsupported(
                f"kernel '{req.ck.kernel.name}': donate=True is not "
                f"capturable -- a replayed graph elides consumed "
                f"intermediates entirely (the static buffers already give "
                f"the reuse donation buys), and donating an external "
                f"input would consume the caller's buffer on every replay"
            )
        stream.dispatcher.resolve_target(req, stream)
        deps = []
        tail = self._tails.get(stream)
        if tail is not None:
            deps.append(tail.idx)
        deps.extend(stream._consume_capture_deps())
        for pname, val in (req.globals_ or {}).items():
            if isinstance(val, GraphRef):
                if val.node.graph is not self:
                    raise CoxUnsupported(
                        f"kernel '{req.ck.kernel.name}': argument '{pname}' "
                        f"references a launch captured in {val.node.graph!r}, not "
                        f"{self!r} -- data edges cannot cross graphs"
                    )
                deps.append(val.node.idx)
        req.stream = stream
        node = GraphNode(self, len(self.nodes), req, tuple(sorted(set(deps))), req.ck.kernel.name)
        self.nodes.append(node)
        self._tails[stream] = node
        return GraphNodeHandle(node)

    # ------------------------- instantiate -------------------------

    def instantiate(self, dispatcher=None, *, device=None) -> "GraphExec":
        """Stage the captured DAG and return a fresh :class:`GraphExec`
        bound to the captured input values.  The staged executable is
        shared through the dispatcher's LRU (a second instantiation is a
        stage hit); each :class:`GraphExec` carries its own bindings.
        ``device=``, when given, must be (a pool entry of) the device the
        nodes were captured for; left ``None`` the graph inherits the
        pinned or placed device of a capturing stream, so it replays
        where the stream's eager launches run (``GraphExec.device``).  A
        sharded launch on a gloo group cannot be captured on the card
        (its collective runs through the host): the instantiation raises
        ``CoxUnsupported``."""
        if self._streams:
            raise CoxUnsupported(
                f"{self!r} is still capturing on "
                f"{sorted(s.name for s in self._streams)} -- end_capture() first"
            )
        if not self.nodes:
            raise CoxUnsupported(f"{self!r} is empty -- capture at least one launch before instantiating")
        from . import streams as _streams

        disp = dispatcher or self._disp or _streams.get_dispatcher()
        from . import runtime as _runtime

        if device is not None:
            entry = device if isinstance(device, _runtime.LogicalDevice) else torch.device(device)
        else:
            entry = next((s._device for s in self._tails if s._device is not None), None)
        targets = {n.req.target for n in self.nodes}
        if len(targets) != 1 or (entry is not None and _runtime.physical(entry) not in targets):
            raise CoxUnsupported(
                f"{self!r}: its nodes run on {sorted(map(str, targets))}"
                + (f", not {entry}" if entry is not None else "")
                + " -- a graph replays on one device, as a CUDA graph launches into "
                "one stream; capture the streams of one device"
            )
        (target,) = targets
        if target.type == "cuda":
            _refuse_host_collectives(self.nodes)
        spec = _binding_spec(self.nodes)
        key = ("graph",) + tuple(_node_sig(n, spec) for n in self.nodes)
        nodes = self.nodes

        def builder():
            return _build_graph(disp, nodes, spec, target)

        exe, raw_fn = disp.stage_graph(key, builder)
        self._frozen = True
        return GraphExec(self, disp, exe, raw_fn, spec, device=target, placed=entry)

    def replay(self, **bindings) -> Dict[str, Any]:
        """Instantiate lazily (once), then replay."""
        if self._exec is None:
            self._exec = self.instantiate()
        return self._exec.replay(**bindings)


def _binding_spec(nodes: List[GraphNode]) -> Dict[str, Any]:
    """Resolve the captured DAG's dataflow into a static spec:

    * ``node_bindings`` -- per node, per param: ``('ref', producer_idx,
      out_name)`` (a data edge) or ``('ext'|'sext', canonical_name)``;
    * ``inputs`` -- canonical input name -> (node idx, param, kind);
    * ``dtypes`` -- canonical input name -> DType;
    * ``outputs`` -- canonical output name -> (node idx, out name) over
      the *terminal* outputs (consumed intermediates are elided);
    * ``aliases`` -- bare param name -> every canonical input it names.

    Canonical names are the bare param name when unique among external
    inputs, else ``{param}_n{node_idx}``."""
    ext_counts: Dict[str, int] = {}
    for n in nodes:
        req = n.req
        for s in req.ck.kernel.params:
            if isinstance(s, ArraySpec) and isinstance(req.globals_[s.name], GraphRef):
                continue
            ext_counts[s.name] = ext_counts.get(s.name, 0) + 1

    def canon(pname: str, idx: int) -> str:
        return pname if ext_counts[pname] == 1 else f"{pname}_n{idx}"

    inputs: Dict[str, tuple] = {}
    dtypes: Dict[str, Any] = {}
    aliases: Dict[str, List[str]] = {}
    node_bindings: List[tuple] = []
    consumed = set()
    for n in nodes:
        req = n.req
        binds = []
        for s in req.ck.kernel.params:
            if isinstance(s, ArraySpec):
                v = req.globals_[s.name]
                if isinstance(v, GraphRef):
                    binds.append((s.name, ("ref", v.node.idx, v.name)))
                    consumed.add((v.node.idx, v.name))
                    continue
                c = canon(s.name, n.idx)
                binds.append((s.name, ("ext", c)))
                inputs[c] = (n.idx, s.name, "array")
            else:
                c = canon(s.name, n.idx)
                binds.append((s.name, ("sext", c)))
                inputs[c] = (n.idx, s.name, "scalar")
            dtypes[c] = s.dtype
            aliases.setdefault(s.name, []).append(c)
        node_bindings.append(tuple(binds))

    term = [
        (n.idx, s.name)
        for n in nodes
        for s in n.req.ck.kernel.params
        if isinstance(s, ArraySpec) and (n.idx, s.name) not in consumed
    ]
    tcounts: Dict[str, int] = {}
    for _, nm in term:
        tcounts[nm] = tcounts.get(nm, 0) + 1
    outputs = {(nm if tcounts[nm] == 1 else f"{nm}_n{i}"): (i, nm) for i, nm in term}
    return {
        "node_bindings": tuple(node_bindings),
        "inputs": inputs,
        "dtypes": dtypes,
        "outputs": outputs,
        "aliases": aliases,
    }


def _node_sig(node: GraphNode, spec: Dict[str, Any]) -> tuple:
    """One node's part of the graph stage key: kernel identity (safe:
    the staged executable keeps the nodes, so every ck, alive), the
    runner key (geometry + knobs + device) and the binding structure.
    Schedule-only edges are absent: values flow through data edges."""
    req = node.req
    return ((id(req.ck),) + req.fn_key()) + spec["node_bindings"][node.idx]


def _materialize_inputs(vals: Dict[str, Any], spec: Dict[str, Any], device):
    """The canonical inputs as tensors on ``device``: arrays flat with a
    sink slot, scalars 0-d, both in their compute dtype."""
    ext_g: Dict[str, torch.Tensor] = {}
    ext_s: Dict[str, torch.Tensor] = {}
    for c, (_, _, kind) in spec["inputs"].items():
        t = _to_tensor(vals[c], spec["dtypes"][c], device, c)
        if kind == "array":
            ext_g[c] = with_sink(t.reshape(-1))
        else:
            ext_s[c] = t.reshape(())
    return ext_g, ext_s


def _walk(staged, nodes, spec, ext_g, ext_s, device, host_reads=None):
    """Run the nodes in capture (= topological) order on fresh copies of
    their inputs -- ``ext_g`` is never written -- threading producer
    outputs into consumer bindings.  Returns each node's raw globals.
    With ``host_reads`` (a list), appends each node's count of host flag
    reads as it finishes, so its length names the node running."""
    raw: Dict[int, Dict[str, torch.Tensor]] = {}
    for (_, run), n, binds in zip(staged, nodes, spec["node_bindings"]):
        g, s = {}, {}
        for pname, b in binds:
            if b[0] == "ref":
                g[pname] = with_sink(raw[b[1]][b[2]][:-1])
            elif b[0] == "ext":
                g[pname] = ext_g[b[1]].clone()
            else:
                s[pname] = ext_s[b[1]]
        before = _execute.host_syncs
        raw[n.idx] = run(g, s, device)
        if host_reads is not None:
            host_reads.append(_execute.host_syncs - before)
    return raw


def _terminal(raw, nodes, spec) -> Dict[str, torch.Tensor]:
    flat = {}
    out = {}
    for c, (i, nm) in spec["outputs"].items():
        if i not in flat:
            flat[i] = flat_outputs(nodes[i].req.ck, raw[i])
        out[c] = flat[i][nm]
    return out


def _build_graph(disp, nodes: List[GraphNode], spec: Dict[str, Any], device):
    """Stage every node's runner, then build the executable: a
    :class:`CudaGraphReplay` on the card, the node walk itself on the
    host.  Returns ``(exe, raw_fn)``, ``raw_fn`` the eager walk (the
    replay -> eager rung of the degradation ladder).  A node that fails
    to stage fails the instantiation with its own typed error."""
    staged = []
    for n in nodes:
        fault = _faults.consume("stage", n.label)
        if fault is not None:
            raise fault
        try:
            staged.append(disp.stage_fn(n.req))
        except Exception as e:
            raise _streams.classify(e, site="stage", what=f"graph node {n.idx} (kernel '{n.label}')")

    def raw_fn(vals: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        ext_g, ext_s = _materialize_inputs(vals, spec, device)
        return _terminal(_walk(staged, nodes, spec, ext_g, ext_s, device), nodes, spec)

    if device.type != "cuda":
        return raw_fn, raw_fn
    first = {}
    for c, (nidx, pname, kind) in spec["inputs"].items():
        req = nodes[nidx].req
        first[c] = req.globals_[pname] if kind == "array" else req.scalars[pname]
    return CudaGraphReplay(staged, nodes, spec, device, first), raw_fn


def _refuse_host_collectives(nodes) -> None:
    """Raise ``CoxUnsupported`` for a sharded node whose merge runs on a
    gloo group: gloo moves a CUDA tensor through the host, which a CUDA
    graph cannot capture.  A one-rank NCCL group captures."""
    import torch.distributed as dist

    for n in nodes:
        mesh = n.req.mesh
        if mesh is not None and dist.get_backend(mesh.get_group(n.req.axis)) == "gloo":
            raise CoxUnsupported(
                f"graph node {n.idx} (kernel '{n.label}') is a sharded launch on a "
                f"gloo group, whose collective reduces CUDA tensors through the "
                f"host; a CUDA graph cannot capture it -- launch it eagerly, or "
                f"shard over an NCCL group"
            )


def _refuse_host_reads(nodes, reads, err=None) -> None:
    """Raise ``CoxUnsupported`` for the first node that read back to the
    host in a warm-up pass (``reads``: each node's count)."""
    for n, k in zip(nodes, reads):
        if k:
            how = f"a synchronizing torch op: {err}" if err is not None else f"{k} flag read(s)"
            raise CoxUnsupported(
                f"graph node {n.idx} (kernel '{n.label}') reads back to the host in "
                f"its launch ({how}; the executor's peels and lane-divergent masked "
                f"loops read flags: execute._host_bool / _host_flags); a CUDA graph "
                f"cannot capture a device-to-host read -- launch this kernel "
                f"eagerly on a stream"
            ) from err


class CudaGraphReplay:
    """The captured nodes as one ``torch.cuda.CUDAGraph`` with static
    input and output buffers (see the module docstring).  ``graph`` is
    the ``CUDAGraph``; calling the object with the canonical inputs'
    values replays it and returns clones of the terminal outputs."""

    def __init__(self, staged, nodes, spec, device, vals: Dict[str, Any]):
        self.device = device
        self._spec = spec
        self._nodes = nodes
        self.static_g, self.static_s = _materialize_inputs(vals, spec, device)
        self.last_writer = None  # the GraphExec whose values the statics hold
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        # two warm-up passes: the first fills each runner's cached
        # constants (made by copies from the host) and counts the
        # executor's flag reads; the second runs with torch's sync check
        # raising, so a read hidden in a torch op is found here, where it
        # is a refusal, and not in the capture, where it would invalidate
        # the graph
        reads: List[int] = []
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(side):
                _walk(staged, nodes, spec, self.static_g, self.static_s, device, reads)
                _refuse_host_reads(nodes, reads)
                reads = []
                torch.cuda.set_sync_debug_mode("error")
                try:
                    _walk(staged, nodes, spec, self.static_g, self.static_s, device, reads)
                except RuntimeError as e:
                    _refuse_host_reads(nodes, reads + [1], e)
                    raise
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                raw = _walk(staged, nodes, spec, self.static_g, self.static_s, device)
                self.static_out = _terminal(raw, nodes, spec)
        except Exception as e:
            labels = [n.label for n in nodes]
            raise CoxUnsupported(
                f"CUDA graph capture of {labels} on {device} failed: "
                f"{type(e).__name__}: {e}"
            ) from e

    def __call__(self, vals: Dict[str, Any], names=None) -> Dict[str, torch.Tensor]:
        """Copy ``vals`` (only ``names`` of them, when given) into the
        static inputs, replay, and return clones of the outputs."""
        dtypes = self._spec["dtypes"]
        for c in self.static_g if names is None else names:
            if c in self.static_g:
                dst = self.static_g[c][:-1]
                src = _to_tensor(vals[c], dtypes[c], self.device, c).reshape(-1)
                if src.numel() != dst.numel():
                    raise CoxUnsupported(
                        f"graph input {c!r} rebound with {src.numel()} elements; "
                        f"the captured graph's static buffer holds {dst.numel()} "
                        f"-- capture again for another shape"
                    )
                dst.copy_(src)
            else:
                self.static_s[c].copy_(_to_tensor(vals[c], dtypes[c], self.device, c).reshape(()))
        self.graph.replay()
        return {c: v.clone() for c, v in self.static_out.items()}


class GraphExec:
    """An instantiated graph (CUDA ``cudaGraphExec_t``): the shared
    staged executable plus *this* instantiation's input bindings.

    ``replay(**bindings)`` updates named inputs (the bare param name when
    unambiguous, ``{param}_n{node}`` to address one node's binding -- a
    bare name naming several bindings updates all of them) and runs the
    executable.  Un-rebound inputs keep their values; rebindings persist
    across replays."""

    def __init__(
        self, graph: Graph, disp, exe, raw_fn, spec: Dict[str, Any], *, device=None, placed=None
    ):
        self._graph = graph
        self._disp = disp
        self._exe = exe
        self._raw_fn = raw_fn  # the eager walk (fallback rung)
        self._device = device
        self._placed = placed  # the pool entry of a pinned or placed capture
        self._aliases = spec["aliases"]
        self._outputs = spec["outputs"]
        self._vals = {}
        for c, (nidx, pname, kind) in spec["inputs"].items():
            req = graph.nodes[nidx].req
            self._vals[c] = req.globals_[pname] if kind == "array" else req.scalars[pname]
        self._out_shapes = {
            c: tuple(graph.nodes[i].req.shapes[nm]) for c, (i, nm) in spec["outputs"].items()
        }
        self._dirty = set(self._vals)

    @property
    def graph(self) -> Graph:
        return self._graph

    @property
    def device(self):
        """The device replays run on: the pool entry of a pinned or placed
        capturing stream, else the physical device."""
        return self._placed if self._placed is not None else self._device

    @property
    def cuda_graph(self) -> Optional["torch.cuda.CUDAGraph"]:
        """The ``torch.cuda.CUDAGraph`` a replay launches on the card
        (``None`` on the host)."""
        return getattr(self._exe, "graph", None)

    @property
    def input_names(self) -> Tuple[str, ...]:
        return tuple(self._vals)

    @property
    def output_names(self) -> Tuple[str, ...]:
        return tuple(self._outputs)

    def _run_exe(self) -> Dict[str, torch.Tensor]:
        exe = self._exe
        if not isinstance(exe, CudaGraphReplay):
            return exe(self._vals)
        # the static buffers are shared by every GraphExec of the same
        # staged graph: copy everything when another one wrote them last
        names = None if exe.last_writer is not self else self._dirty
        exe.last_writer = None  # a failed copy leaves the statics unknown
        out = exe(self._vals, names)
        exe.last_writer = self
        self._dirty = set()
        return out

    def replay(self, **bindings) -> Dict[str, Any]:
        for name, val in bindings.items():
            if name in self._vals:
                self._vals[name] = val
                self._dirty.add(name)
            elif name in self._aliases:
                for c in self._aliases[name]:
                    if c in self._vals:
                        self._vals[c] = val
                        self._dirty.add(c)
            else:
                raise KeyError(
                    f"graph {self._graph.name!r} has no input {name!r}; "
                    f"inputs: {sorted(self._vals)}"
                )
        gname = self._graph.name
        placed = self._placed
        if placed is not None:
            # a graph placed on a pool entry replays there: a poisoned
            # entry fails the replay with its sticky error
            with self._disp._lock:
                sticky = self._disp._sticky_for(placed)
            if sticky is not None:
                raise sticky
        fault = _faults.consume("dispatch", gname)
        try:
            if fault is not None:
                raise fault
            flat = self._run_exe()
        except Exception as e:
            err = _streams.classify(e, site="dispatch", what=f"graph '{gname}'")
            if _errors.is_sticky(err) or isinstance(err, (CoxUnsupported, CoxTypeError)):
                raise err  # user/device errors: no fallback
            # graph replay -> eager: the last ladder rung, the same node
            # walk run eagerly (bitwise the same), logged as a degradation
            disp = self._disp
            event = {
                "kernel": gname,
                "seq": -1,
                "from": "graph-replay",
                "to": "eager",
                "error": repr(err),
            }
            with disp._lock:
                disp.degradations += 1
                disp.degradation_log.append(event)
            flat = self._raw_fn(dict(self._vals))
        with self._disp._lock:
            self._disp._bump_dev(placed, "dispatches")
        return {c: v.reshape(self._out_shapes[c]) for c, v in flat.items()}

    __call__ = replay
