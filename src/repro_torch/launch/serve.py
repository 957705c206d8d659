"""Serving driver: batched greedy decoding with a continuous slot pool
(port of ``src/repro/launch/serve.py``).

Requests enter a fixed-size batch of decode slots; a finished sequence
frees its slot for the next queued request (continuous batching).  Every
step, prefill included, is the same decode step on the whole batch, so on
a CUDA device each step launches the hand-written norm kernel
(``rmsnorm``, or ``layernorm`` for granite's ``norm="ln"``) and
``flash_decode``:

- dense (qwen, granite), MoE (deepseek-moe, granite-moe) and VLM (llava)
  models: the norm 2 x n_layers + 1 times and flash_decode n_layers
  times (the MoE router's top-k and the expert products are plain torch,
  as in the reference);
- an SSM model (mamba2): the norm 2 x n_layers + 1 times (its recurrent
  step has no kernel of its own);
- a hybrid model (zamba2): the norm 2 x n_layers + 2 x A + 1 times and
  flash_decode A times, A the shared block's applications;
- an encoder-decoder model (seamless): ``layernorm`` 3 x n_layers + 1
  times and flash_decode 2 x n_layers times, over each layer's self cache
  and over its cross memory of ``ENC_LEN_DECODE`` rows (``specs.py``).

As in the reference, a reused slot's SSM state and a hybrid slot's K/V
ring are not reset: the next request starts from the previous one's
(ROADMAP C); the VLM family serves text only (the reference's server
takes no frontend embeddings); and the encoder-decoder family's server
never runs the encoder: its cross memory is the cache's zero
initialisation, so every token cross-attends to zeros (ROADMAP C.3).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --batch 4 --ctx 512 --requests 4 --tokens 16

Per-request kernel work rides **cox streams** (``postproc``): each decode
slot owns a stream, and a finished request's postprocess kernel (a token
histogram, the stand-in for dedup/stats/safety passes) is enqueued on
its slot's stream and left in flight while the server keeps decoding;
one synchronize at the end collects everything.  ``graph`` captures the
per-token statistics pipeline (three dependent COX kernels a decode
step) once into a ``cox.Graph`` -- a ``torch.cuda.CUDAGraph`` on the
card -- and replays it every step beside a shadow eager pipeline, whose
statistics must be bitwise the replay's.  ``chaos`` is the
fault-injection drill: the first postprocess launch is forced to fail,
and the faulting slot must be isolated while every other slot completes.

The server runs on the CUDA card unless it is given ``device="cpu"``
(``--device cpu``), and raises where there is no card; the streams and
graphs run where the server does.  ``--autotune`` sets ``COX_AUTOTUNE=1``,
so every all-auto COX launch (the postprocess histograms) takes its knobs
from the measured winner cache (``core/autotune.py``), and the summary
line gains the tuner's counters.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs import registry
from ..configs.base import ModelConfig, ShapeConfig
from ..core import cox
from ..core.runtime import resolve_device
from ..models import carry
from ..models.params import init_params
from ..parallel import steps as steps_mod
from . import specs as S


@cox.kernel
def _token_hist(c, hist: cox.Array(cox.i32), toks: cox.Array(cox.i32), n: cox.i32, nbins: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, toks[i] % nbins, 1)


# the per-token pipeline kernels (graph=True captures this 3-launch DAG
# once and replays it every decode step): masked histogram accumulate ->
# running total -> per-bin stats over the settled counts
@cox.kernel
def _tok_hist_add(c, hist: cox.Array(cox.i32), toks: cox.Array(cox.i32), n: cox.i32, nbins: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        if toks[i] >= 0:  # -1 marks an idle decode slot
            c.atomic_add(hist, toks[i] % nbins, 1)


@cox.kernel
def _tok_hist_total(c, tot: cox.Array(cox.i32), hist: cox.Array(cox.i32), nbins: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < nbins:
        c.atomic_add(tot, 0, hist[i])


@cox.kernel
def _tok_hist_stats(
    c, sq: cox.Array(cox.i32), hist: cox.Array(cox.i32), tot: cox.Array(cox.i32), nbins: cox.i32
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < nbins:
        sq[i] = hist[i] * hist[i] + tot[0]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TokenPipeline:
    """Per-decode-step token statistics as a 3-kernel DAG on one cox
    stream: histogram accumulate (carried across steps) -> total ->
    per-bin stats.  ``graph=True`` captures the DAG once and replays it
    every step, the step's tokens and the carried histogram rebound;
    ``graph=False`` issues the three launches eagerly.  Both are bitwise
    the same by the replay-equals-eager contract.

    The stream has priority -1: the pipeline gates the decode loop's
    cadence, so among ready launches it goes before the postprocess
    pool's.  It takes the step's tokens as the host array the decode
    step already made, so the only ordering it needs is its own
    stream's.  Graph replays run on the current stream."""

    def __init__(self, batch: int, nbins: int = 64, *, graph: bool = False, device=None):
        self.batch = batch
        self.nbins = nbins
        self.use_graph = graph
        self.device = resolve_device(device)
        self.stream = cox.Stream(name="tok-pipeline", priority=-1, device=self.device)
        self.hist = np.zeros(nbins, np.int32)
        self.last: Dict[str, Any] = {}
        self._graph: Optional[cox.Graph] = None
        self.steps = 0

    def _launch_dag(self, toks: np.ndarray):
        """Issue the 3-kernel DAG on the stream (capturing or eager)."""
        block = 64
        s, nb = self.stream, self.nbins
        h0 = s.launch(
            _tok_hist_add,
            grid=-(-self.batch // block),
            block=block,
            args=(self.hist, toks, self.batch, nb),
        )
        h1 = s.launch(
            _tok_hist_total,
            grid=-(-nb // block),
            block=block,
            args=(np.zeros(1, np.int32), h0.outputs["hist"], nb),
        )
        return s.launch(
            _tok_hist_stats,
            grid=-(-nb // block),
            block=block,
            args=(np.zeros(nb, np.int32), h1.outputs["hist"], h1.outputs["tot"], nb),
        )

    def step(self, tokens: np.ndarray, active: np.ndarray) -> None:
        """Fold one decode step's tokens (idle slots masked to -1) into
        the running statistics."""
        toks = np.where(active, tokens, -1).astype(np.int32)
        self.steps += 1
        if self.use_graph:
            if self._graph is None:  # capture once, replay every token
                self._graph = cox.Graph(name="tok-pipeline")
                with self._graph.capture(self.stream):
                    self._launch_dag(toks)
                res = self._graph.replay()
            else:
                res = self._graph.replay(toks=toks, hist=self.hist)
            self.hist = res["hist"]  # carried through node 2's pass-through
            self.last = {"tot": res["tot"], "sq": res["sq"]}
            return
        out = self._launch_dag(toks).arrays()  # no host block
        self.hist = out["hist"]
        self.last = {"tot": out["tot"], "sq": out["sq"]}

    @property
    def graph_exec(self):
        """The pipeline's instantiated :class:`cox.GraphExec` (graph mode,
        after the first step), else ``None``."""
        return self._graph._exec if self._graph is not None else None

    def collect(self) -> Dict[str, np.ndarray]:
        """The final statistics on the host (one sync)."""
        return {"hist": _host(self.hist), **{k: _host(v) for k, v in self.last.items()}}


class RequestKernelPool:
    """Per-request kernel postprocessing on per-slot cox streams.

    ``submit`` enqueues the request's kernel on its slot's stream and
    returns at once; the serving loop never blocks on postprocessing.
    ``collect`` synchronizes every launch once, at the end.  A faulting
    slot is **isolated**, not fatal: its typed error surfaces at that
    handle's own sync, the failed request is retired, the slot's stream
    is reset so it stays usable, and the other slots complete.  The
    streams have priority 1 (bulk work, after the token pipeline).

    The histogram launches leave their knobs on auto, as the reference's
    do, so ``COX_AUTOTUNE`` tunes them.  ``pin_scan=True`` (the fault
    drill) pins the serial scan (``backend='scan'``,
    ``warp_exec='serial'``): at serving length a request's tokens fill 8
    blocks, where the auto knobs pick the ``vmap`` backend, and its
    degradation ladder would absorb the drill's one injected fault (vmap
    -> scan, bitwise the same), so the drill would fail no slot.
    Explicit knobs never degrade.  The reference's drill runs where auto
    already picks scan."""

    def __init__(self, n_slots: int, nbins: int = 64, *, device=None, pin_scan: bool = False):
        self.nbins = nbins
        self.device = resolve_device(device)
        self.knobs = {"backend": "scan", "warp_exec": "serial"} if pin_scan else {}
        self.streams = [
            cox.Stream(name=f"req-slot{i}", priority=1, device=self.device)
            for i in range(n_slots)
        ]
        self.handles: List[cox.LaunchHandle] = []
        self._meta: List[tuple] = []  # (slot, n_tokens) per handle
        self.ok_tokens = 0  # tokens binned by completed slots
        self.health: Dict[str, Any] = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "failed_slots": [],
            "errors": [],
        }

    def submit(self, slot: int, tokens: List[int]) -> None:
        toks = np.asarray(tokens, np.int32)
        n = int(toks.size)
        if n == 0:
            return
        block = 64
        h = self.streams[slot].launch(
            _token_hist,
            grid=-(-n // block),
            block=block,
            args=(np.zeros(self.nbins, np.int32), toks, n, self.nbins),
            **self.knobs,
        )
        self.handles.append(h)
        self._meta.append((slot, n))
        self.health["submitted"] += 1

    def collect(self) -> List[np.ndarray]:
        """Wait for every launch and return each completed request's
        histogram (in completion order), isolating faulting slots."""
        hists: List[np.ndarray] = []
        for (slot, n), h in zip(self._meta, self.handles):
            try:
                hists.append(_host(h.result()["hist"]))
                self.health["completed"] += 1
                self.ok_tokens += n
            except cox.CoxError as e:
                self.health["failed"] += 1
                self.health["failed_slots"].append(slot)
                self.health["errors"].append(repr(e))
                self.streams[slot].reset()
        return hists


class BatchedServer:
    """A pool of ``batch`` decode slots over a ``ctx``-long KV cache.

    ``arch`` is a registry name, or a ``ModelConfig`` (a registry config
    with, say, its depth cut).  ``params`` takes weights carried in
    (``models.carry``); without it the weights are drawn from ``seed`` on
    the device.  ``init_s`` is the
    seconds that drawing (or placing) the weights took; ``steps`` counts
    decode steps run (prefill included) and ``step_s`` holds the host-clock
    seconds of each ``decode`` step, each ending when its next tokens
    reach the host.

    With ``mesh=`` (a ``DeviceMesh`` over "data" and "model", every rank
    constructing and stepping the server alike) every family serves under
    ``strategy``: the weights and the cache (K/V on sequence slabs, the
    SSM state on its heads, the conv tail on its channels, the cross
    memory on slabs) are DTensors at the reference's placements, and each
    step, prefill included, writes each rank's shards in place."""

    def __init__(
        self,
        arch: Union[str, ModelConfig],
        *,
        batch: int = 4,
        ctx: int = 128,
        seed: int = 0,
        params=None,
        device=None,
        mesh=None,
        strategy: str = "tp",
    ):
        self.cfg = registry.get(arch) if isinstance(arch, str) else arch
        self.shape = ShapeConfig(f"serve_{ctx}", ctx, batch, "decode")
        self.mesh, self.rules = mesh, None
        if mesh is None:
            self.device = resolve_device(device)
            self.step_fn, self.specs = steps_mod.make_serve_step(self.cfg)
        else:
            from ..parallel.spmd import mesh_device

            self.device = mesh_device(mesh)
            self.step_fn, bundle = steps_mod.make_serve_step(self.cfg, mesh=mesh, strategy=strategy)
            self.cfg, self.specs, self.rules = bundle["cfg"], bundle["specs"], bundle["rules"]
        t0 = time.perf_counter()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.specs, gen, self.device, rules=self.rules)
        elif mesh is not None:
            params = carry.shard_params(params, bundle)
        self.params = params
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_s = time.perf_counter() - t0
        self.batch = batch
        self.ctx = ctx
        self.steps = 0
        self.step_s: List[float] = []
        self.reset()

    def reset(self):
        tree = S.cache_spec_tree(self.cfg, self.shape)
        self.cache = init_params(tree, None, self.device, rules=self.rules)
        self.pos = np.zeros((self.batch,), np.int32)
        self.tokens = np.zeros((self.batch,), np.int32)
        self.active = np.zeros((self.batch,), bool)
        self.outputs: List[List[int]] = [[] for _ in range(self.batch)]

    def _run(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int32)).to(self.device)
        p = torch.from_numpy(np.ascontiguousarray(pos, np.int32)).to(self.device)
        nxt, self.cache = self.step_fn(self.params, self.cache, toks, p)
        self.steps += 1
        return nxt

    def prefill_prompt(self, slot: int, prompt: List[int]):
        """Feed a prompt through the decode path, one step per token.

        Every slot steps: the others with their current (stale) token, and
        the positions of all active slots advance (``mask = active``), as
        in the reference's scanned prefill."""
        self.pos[slot] = 0
        self.outputs[slot] = []
        self.active[slot] = True
        T = len(prompt)
        if T == 0:
            return self
        tok_mat = np.tile(self.tokens.astype(np.int32), (T, 1))
        tok_mat[:, slot] = np.asarray(prompt, np.int32)
        mask = self.active.astype(np.int32)
        pos = self.pos.copy()
        for t in range(T):
            self._run(tok_mat[t], pos)
            pos = pos + mask
        self.pos = pos
        self.tokens[slot] = prompt[-1]
        return self

    def _step_all(self) -> np.ndarray:
        t0 = time.perf_counter()
        nxt = self._run(self.tokens, self.pos).cpu().numpy()
        self.step_s.append(time.perf_counter() - t0)
        for i in range(self.batch):
            if self.active[i]:
                self.pos[i] += 1
        return nxt

    def decode(
        self,
        max_tokens: int,
        eos: Optional[int] = None,
        pipelines: Optional[List[TokenPipeline]] = None,
    ):
        for _ in range(max_tokens):
            nxt = self._step_all()
            was_active = self.active.copy()
            for i in range(self.batch):
                if not self.active[i]:
                    continue
                t = int(nxt[i])
                self.outputs[i].append(t)
                self.tokens[i] = t
                if eos is not None and t == eos:
                    self.active[i] = False
                if self.pos[i] >= self.ctx - 1:
                    self.active[i] = False
            for p in pipelines or ():
                p.step(nxt, was_active)
            if not self.active.any():
                break
        return self.outputs


def serve_requests(
    arch: Union[str, ModelConfig],
    *,
    batch: int,
    ctx: int,
    n_requests: int,
    max_tokens: int,
    seed: int = 0,
    postproc: bool = False,
    graph: bool = False,
    chaos: bool = False,
    device=None,
    mesh=None,
) -> Dict[str, Any]:
    """Continuous batching over a queue of synthetic prompt requests (8
    tokens each, drawn from ``seed`` with numpy, as in the reference);
    ``arch`` as :class:`BatchedServer` takes it.

    ``postproc=True`` issues every finished request's token histogram on
    its slot's cox stream, collected with one sync at the end.
    ``graph=True`` captures the per-token stats pipeline once and replays
    it every decode step, beside a shadow eager pipeline whose statistics
    must be bitwise the replay's.  ``chaos=True`` (which needs
    ``postproc``) forces the first postprocess launch to fail: the
    faulting slot is isolated and every other slot completes with its
    totals intact.  The reference's asserts hold each of these.
    ``mesh=`` (every rank calling alike) serves from
    ``BatchedServer(mesh=)`` under its default "tp".

    Returns the reference's counts (``completed``, ``tokens``, ``wall_s``,
    ``tok_per_s``, ``dispatch_health`` and the ``postproc`` and ``graph``
    blocks) and the server's ``init_s``, ``steps`` and ``step_s``."""
    if chaos and not postproc:
        raise ValueError("chaos=True requires postproc=True (it faults the postprocess pool)")
    rng = np.random.default_rng(seed)
    server = BatchedServer(arch, batch=batch, ctx=ctx, seed=seed, device=device, mesh=mesh)
    pool = RequestKernelPool(batch, device=server.device, pin_scan=chaos) if postproc else None
    pipelines: List[TokenPipeline] = []
    if graph:
        pipelines = [
            TokenPipeline(batch, graph=True, device=server.device),
            TokenPipeline(batch, graph=False, device=server.device),
        ]
    queue = [list(rng.integers(1, server.cfg.vocab, size=8)) for _ in range(n_requests)]
    done: List[List[int]] = []
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if chaos:
            # deterministically fail the first postprocess dispatch
            stack.enter_context(cox.faults.inject("_token_hist", site="dispatch", index=0, times=1))
        while queue or server.active.any():
            for slot in range(batch):
                if not server.active[slot] and queue:
                    server.prefill_prompt(slot, queue.pop(0))
            server.decode(max_tokens, pipelines=pipelines)
            for slot in range(batch):
                if not server.active[slot] and server.outputs[slot]:
                    done.append(server.outputs[slot])
                    if pool is not None:
                        pool.submit(slot, server.outputs[slot])
                    server.outputs[slot] = []
        out: Dict[str, Any] = {}
        if pool is not None:
            hists = pool.collect()  # one sync for all streams
            out["postproc"] = {
                "requests": len(hists),
                "hist_tokens": int(sum(int(h.sum()) for h in hists)),
                "failed": pool.health["failed"],
                "health": dict(pool.health),
            }
    dt = time.time() - t0
    total_tokens = sum(len(o) for o in done)
    out.update(
        {
            "completed": len(done),
            "tokens": total_tokens,
            "wall_s": dt,
            "tok_per_s": total_tokens / max(dt, 1e-9),
            "init_s": server.init_s,
            "steps": server.steps,
            "step_s": list(server.step_s),
        }
    )
    out["dispatch_health"] = cox.get_dispatcher().health()
    if pool is not None:
        # the completed histograms were binned from exactly the tokens
        # their requests emitted: a faulted slot subtracts only its own
        assert out["postproc"]["hist_tokens"] == pool.ok_tokens
        if not chaos:
            assert pool.health["failed"] == 0
            assert out["postproc"]["hist_tokens"] == total_tokens
            # a clean run never leans on the fault-tolerance machinery
            dh = out["dispatch_health"]
            assert dh["degradations"] == 0 and dh["sticky"] is None, dh
        else:
            # one injected fault; the faulting slot's stream is poisoned,
            # so every request it had in flight fails as a dependency of
            # it, and every other slot completes untouched
            h = pool.health
            assert h["failed"] >= 1 and set(h["failed_slots"]) == {0}, h
            assert h["completed"] == h["submitted"] - h["failed"], h
            roots = [e for e in h["errors"] if not e.startswith("CoxDependencyError")]
            assert len(roots) == 1 and "injected" in roots[0], h
            # ...and the per-device counters keep the fault on one device
            dev_fail = [d for d, c in out["dispatch_health"]["devices"].items() if c.get("failures", 0)]
            assert len(dev_fail) == 1, out["dispatch_health"]
    if graph:
        g_stats, e_stats = (p.collect() for p in pipelines)
        for k in g_stats:  # replay == eager, bitwise
            assert np.array_equal(g_stats[k], e_stats[k]), k
        assert int(g_stats["hist"].sum()) == total_tokens
        out["graph"] = {
            "steps": pipelines[0].steps,
            "hist_tokens": int(g_stats["hist"].sum()),
            "replayed": pipelines[0]._graph is not None,
            "cuda_graph": pipelines[0].graph_exec is not None
            and pipelines[0].graph_exec.cuda_graph is not None,
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument(
        "--postproc",
        action="store_true",
        help="per-request postprocess kernels on per-slot cox streams (one final sync)",
    )
    ap.add_argument(
        "--graph",
        action="store_true",
        help="capture the per-token stats pipeline once as a cox.Graph and replay it "
        "every decode step (held bitwise against eager launches)",
    )
    ap.add_argument(
        "--chaos",
        action="store_true",
        help="fault-injection drill: force the first postprocess launch to fail and "
        "check the other slots complete with correct totals (needs --postproc)",
    )
    ap.add_argument(
        "--autotune",
        action="store_true",
        help="measure knob candidates for every all-auto COX launch (winners kept in "
        "the on-disk autotune cache; a warm cache issues zero measurement launches)",
    )
    args = ap.parse_args(argv)
    if args.autotune:
        os.environ.setdefault("COX_AUTOTUNE", "1")
    out = serve_requests(
        args.arch,
        batch=args.batch,
        ctx=args.ctx,
        n_requests=args.requests,
        max_tokens=args.tokens,
        postproc=args.postproc,
        graph=args.graph,
        chaos=args.chaos,
        device=args.device,
    )
    msg = (
        f"served {out['completed']} requests, {out['tokens']} tokens, "
        f"{out['tok_per_s']:.1f} tok/s on {args.device or 'cuda'}"
    )
    if args.postproc:
        pp = out["postproc"]
        msg += (
            f" (+{pp['requests']} postproc kernels, {pp['hist_tokens']} tokens binned, "
            f"{pp['failed']} faulted)"
        )
    if args.graph:
        g = out["graph"]
        msg += (
            f" (graph replay: {g['steps']} steps, {g['hist_tokens']} tokens binned, "
            f"bitwise == eager, CUDA graph: {g['cuda_graph']})"
        )
    dh = out["dispatch_health"]
    devs = dh.get("devices", {})
    if devs:
        cells = ", ".join(
            f"{name}: {c['dispatches']}d/{c['failures']}f/{c['degradations']}g"
            for name, c in sorted(devs.items())
        )
        msg += f" [devices: {cells}]"
    # the tuner's cache: memory and disk hits against measured misses, and
    # the measurement launches (zero on a warm cache)
    at = dh.get("autotune", {})
    if at:
        msg += (
            f" [autotune: {at.get('hits', 0)}h/{at.get('disk_hits', 0)}dh/"
            f"{at.get('misses', 0)}m, {at.get('measurements', 0)} measured]"
        )
    msg += (
        f" [dispatch health: {dh['failures']} failures, {dh['retries']} retries, "
        f"{dh['degradations']} degradations, sticky {dh['sticky']}]"
    )
    print(msg)
    return out


if __name__ == "__main__":
    main()
