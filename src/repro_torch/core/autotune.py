"""Measured knob autotuning with a persistent on-disk winner cache (port
of the reference's ``autotune.py``).

The ``flat.choose_*`` heuristics are good defaults, but the best
schedule of a COX launch depends on the kernel.  This module measures a
small candidate set -- chunk in ``CHUNK_CANDIDATES`` x backend x
warp_exec x schedule, pruned by the cost model (chunked cells whose
table + wave footprint exceeds ``costmodel.footprint_budget`` are
replaced by grid-stride cells sized by ``costmodel.resident_slots``; the
old chunk clamp survives only as a last resort for an explicitly pinned
``schedule='chunked'``) -- and persists the winners in
``~/.cache/cox/autotune_torch.json``, so a fleet warms once, not once a
boot.

Contract with the resolver (``runtime.ResolvedLaunch``):

* only knobs the caller left on ``'auto'`` are tuned -- an explicit
  ``backend=``/``warp_exec=``/``chunk=<int>`` is never overridden;
* the heuristic pick is always in the candidate set, so a tuned launch
  is never slower than the untuned one beyond measurement noise;
* every measured winner is bitwise-equivalent by the backend-
  equivalence contract (all candidates compute scan/serial semantics).

What differs from the reference, which measures XLA programs on a CPU:

* a cell's time is the host's wall clock around one launch, with
  ``torch.cuda.synchronize()`` before and after it on the card: COX
  launches are host-bound (the executor issues many small ops and reads
  flags back), so host time is the quantity a winner minimises;
* a cell the backends refuse (``CoxUnsupported``) drops out; any other
  error propagates -- a CUDA fault poisons the context, and swallowing
  it would hide the device;
* the fingerprint in every key names the card class (its name, the CUDA
  and torch versions, the device count), so a winner tuned on one card
  is measured again on another;
* the default file is the port's own: the two packages' keys never
  match, and a version stamp of one in a shared file would wipe the
  other's winners;
* a launch issued while a graph captures (a ``cox.Graph`` or a
  ``torch.cuda`` graph) is not tuned: a synchronize inside a capture
  raises.  It keeps its heuristic knobs, as in the reference.

Cache keying and robustness: entries are keyed like the launch cache
(compile token + geometry + knob tunability + arg-shape signature) plus
the fingerprint, the file is version-stamped (``AUTOTUNE_VERSION`` --
stale stamps invalidate wholesale), writes are atomic (temp file +
``os.replace``, with a read-merge so concurrent writers union instead of
clobber), and a corrupt or truncated file is read as empty.
``COX_AUTOTUNE_CACHE`` overrides the path (``off`` disables disk);
``COX_AUTOTUNE=1`` turns tuning on for every all-auto launch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import costmodel as _costmodel
from .types import ArraySpec, CoxUnsupported, GraphRef

AUTOTUNE_VERSION = 2  # v2: records/keys carry the launch schedule
ENV_CACHE = "COX_AUTOTUNE_CACHE"  # cache file path, or 'off' to disable
ENV_ENABLE = "COX_AUTOTUNE"  # '1' tunes every all-auto launch
DEFAULT_CACHE = "~/.cache/cox/autotune_torch.json"
CHUNK_CANDIDATES = (4, 8, 16, 32)
MEASURE_WARMUP = 1  # un-timed warm launches per cell
MEASURE_REPS = 2  # timed launches per cell (min taken)

_lock = threading.RLock()
_memory: Dict[str, dict] = {}  # key -> winner record
_disk_seeded_from: Optional[str] = None  # path _memory was seeded from
_stats = {
    "hits": 0,  # resolved from the in-memory cache
    "disk_hits": 0,  # resolved from the on-disk cache (fresh process)
    "misses": 0,  # had to measure
    "measurements": 0,  # measurement launches issued (warmup + timed)
    "tuned": 0,  # launches whose knobs came from a measured winner
    "disk_writes": 0,
    "load_errors": 0,  # corrupt/stale cache files tolerated
}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """True when ``COX_AUTOTUNE`` asks every all-auto launch to tune."""
    return os.environ.get(ENV_ENABLE, "").strip().lower() in ("1", "true", "on", "yes")


def cache_path() -> Optional[str]:
    """The on-disk winner-cache path, or ``None`` when disk persistence
    is off (``COX_AUTOTUNE_CACHE=off``)."""
    p = os.environ.get(ENV_CACHE)
    if p is not None:
        p = p.strip()
        if p.lower() in ("off", "0", "none", ""):
            return None
        return os.path.expanduser(p)
    return os.path.expanduser(DEFAULT_CACHE)


def cpu_fingerprint(device=None) -> str:
    """Keys winners to the machine class: the host's architecture, OS and
    core count, and for a launch on the card the card's name, the CUDA
    and torch versions and the device count.  Knobs tuned on one machine
    shape transfer within a homogeneous fleet and are measured again
    elsewhere."""
    host = "%s-%s-%dcpu" % (platform.machine(), platform.system(), os.cpu_count() or 1)
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type != "cuda":
        return "%s-cpu-x1" % host
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return "%s-cuda-%s-cu%s-torch%s-x%d" % (
        host,
        torch.cuda.get_device_name(idx).replace(" ", "_"),
        torch.version.cuda,
        torch.__version__,
        torch.cuda.device_count(),
    )


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def entries() -> Dict[str, dict]:
    """Copy of the in-memory winner cache (bench/test introspection)."""
    with _lock:
        return {k: dict(v) for k, v in _memory.items()}


def reset(memory_only: bool = False) -> None:
    """Clear counters and the in-memory cache (tests; ``memory_only``
    simulates a fresh process that still sees the disk cache)."""
    global _disk_seeded_from
    with _lock:
        _memory.clear()
        _disk_seeded_from = None
        if not memory_only:
            for k in _stats:
                _stats[k] = 0


# ---------------------------------------------------------------------------
# the persistent cache (atomic, versioned, corruption-tolerant)
# ---------------------------------------------------------------------------


def _load_disk(path: str) -> Dict[str, dict]:
    """Read the winner file; any defect (missing, truncated, not JSON,
    wrong shape, stale version stamp) yields ``{}`` -- the heuristics
    remain the fallback, a bad cache can never crash a launch."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("version") != AUTOTUNE_VERSION:
            raise ValueError("stale or malformed autotune cache")
        ents = doc.get("entries")
        if not isinstance(ents, dict):
            raise ValueError("malformed autotune cache entries")
        return {k: v for k, v in ents.items() if isinstance(v, dict)}
    except FileNotFoundError:
        return {}
    except Exception:
        with _lock:
            _stats["load_errors"] += 1
        return {}


def _save_disk(path: str, records: Dict[str, dict]) -> None:
    """Merge ``records`` into the file atomically: re-read, union, write
    a temp file in the same directory, ``os.replace``.  Concurrent
    writers may lose a race but readers always see a complete file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    merged = _load_disk(path)
    merged.update(records)
    doc = {"version": AUTOTUNE_VERSION, "entries": merged}
    fd, tmp = tempfile.mkstemp(prefix=".autotune-", suffix=".json", dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    with _lock:
        _stats["disk_writes"] += 1


def _seed_from_disk() -> None:
    """Populate the in-memory cache from disk once per (process, path).
    Caller holds ``_lock``."""
    global _disk_seeded_from
    path = cache_path()
    if path is None or _disk_seeded_from == path:
        return
    for k, v in _load_disk(path).items():
        _memory.setdefault(k, v)
    _disk_seeded_from = path


def cache_key(
    token: tuple,
    ck,
    rl,
    shapes: Dict[str, tuple],
    *,
    simd: bool,
    tunable: Tuple[bool, bool, bool, bool],
    device=None,
) -> str:
    """Launch-cache-style key + the fingerprint of ``device``'s machine
    class.  The *tunable* mask (backend, warp_exec, chunk, schedule) is
    part of the key: a launch with an explicit backend tunes a smaller
    space and must not collide with the all-auto winner."""
    shape_sig = ",".join(
        "%s:%s" % (k, "x".join(map(str, v))) for k, v in sorted(shapes.items())
    )
    return "|".join(
        [
            ck.kernel.name,
            repr(token),
            str(ck.n_phases),
            "g%s" % (rl.grid.astuple(),),
            "b%s" % (rl.block.astuple(),),
            "simd%d" % int(simd),
            "t%d%d%d%d" % tuple(int(t) for t in tunable),
            shape_sig,
            cpu_fingerprint(device),
        ]
    )


# ---------------------------------------------------------------------------
# candidate enumeration + measurement
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Candidate:
    backend: str
    warp_exec: str
    chunk: int
    schedule: str = "chunked"
    n_resident: Optional[int] = None

    @property
    def label(self) -> str:
        if self.schedule == "grid_stride":
            return "%s/%s/gs%d" % (self.backend, self.warp_exec, self.n_resident or 1)
        return "%s/%s/c%d" % (self.backend, self.warp_exec, self.chunk)

    @property
    def key(self) -> tuple:
        return (self.backend, self.warp_exec, self.chunk, self.schedule, self.n_resident)


def _chunk_candidates(
    ck, rl, shapes, *, warp_exec: str, tunable_chunk: bool, allow_empty: bool = False
) -> List[int]:
    """Chunked-schedule chunk values worth measuring for a vmap-family
    backend, pruned by the footprint model (wave copies **plus** the
    materialized O(grid) bid table).  ``allow_empty=True`` lets an
    all-over-budget set come back empty -- the caller swaps in
    grid-stride cells instead.  When the schedule is pinned 'chunked'
    (``allow_empty=False``) the old clamp survives as a last resort:
    shrink the wave until its copies fit (the table term cannot shrink,
    so this only bounds wave memory)."""
    grid = rl.grid.total
    if not tunable_chunk:
        return [rl.chunk]
    cands = sorted({c for c in CHUNK_CANDIDATES if c <= grid} | {rl.chunk})
    budget = _costmodel.footprint_budget()
    fitting = [
        c
        for c in cands
        if _costmodel.chunk_footprint(
            ck, shapes, chunk=c, n_warps=rl.n_warps, warp_exec=warp_exec, grid=grid
        )
        <= budget
    ]
    if not fitting and not allow_empty:
        c = min(cands)
        while (
            c > 1
            and _costmodel.chunk_footprint(
                ck, shapes, chunk=c, n_warps=rl.n_warps, warp_exec=warp_exec
            )
            > budget
        ):
            c //= 2
        fitting = [max(1, c)]
    return fitting


def _stride_candidates(ck, rl, shapes, *, warp_exec: str) -> List[int]:
    """Grid-stride wave widths worth measuring: the cost-model-sized
    width (``costmodel.resident_slots``) plus the resolver's pick when
    it already strided -- a two-cell-max set, since stride footprint is
    grid-independent and the sizer already found the widest fit."""
    grid = rl.grid.total
    widths = {
        _costmodel.resident_slots(
            ck, shapes, grid=grid, n_warps=rl.n_warps, warp_exec=warp_exec
        )
    }
    if rl.schedule == "grid_stride" and rl.n_resident:
        widths.add(min(int(rl.n_resident), grid))
    return sorted(widths)


def _candidates(ck, rl, shapes, *, tunable: Tuple[bool, bool, bool, bool]) -> List[Candidate]:
    tune_backend, tune_warp, tune_chunk, tune_sched = tunable
    grid = rl.grid.total
    from . import flat as _flat

    atomic_old = _flat.captures_atomic_old(ck.kernel)
    backends = [rl.backend]
    if tune_backend and grid > 1 and not atomic_old and rl.backend in ("scan", "vmap"):
        backends = sorted({rl.backend, "scan", "vmap"})
    warps = [rl.warp_exec]
    if tune_warp and rl.n_warps > 1 and not atomic_old:
        warps = sorted({rl.warp_exec, "serial", "batched"})
    out: List[Candidate] = []
    for b in backends:
        for w in warps:
            if b == "scan":
                # chunk only changes the vmap wave width; scan ignores
                # it, so scan cells collapse to the resolved schedule
                out.append(Candidate(b, w, rl.chunk, rl.schedule, rl.n_resident))
                continue
            if not tune_sched and rl.schedule == "grid_stride":
                # schedule pinned strided (explicit/cooperative): vary
                # backend/warp only, keep the wave width
                out.append(Candidate(b, w, rl.chunk, "grid_stride", rl.n_resident))
                continue
            chunks = _chunk_candidates(
                ck, rl, shapes, warp_exec=w, tunable_chunk=tune_chunk, allow_empty=tune_sched
            )
            for c in chunks:
                out.append(Candidate(b, w, c, "chunked", None))
            if tune_sched and (not chunks or rl.schedule == "grid_stride"):
                # the chunk table blows the budget (or the resolver
                # already strided): grid-stride cells replace the old
                # blind chunk clamp
                for r in _stride_candidates(ck, rl, shapes, warp_exec=w):
                    out.append(Candidate(b, w, r, "grid_stride", r))
    # de-dup preserving order (heuristic cell may coincide with a grid one)
    seen = set()
    uniq = []
    for cand in out:
        if cand.key not in seen:
            seen.add(cand.key)
            uniq.append(cand)
    return uniq


def _zero_globals(ck, shapes: Dict[str, tuple], device) -> Dict[str, torch.Tensor]:
    """Zero-filled flat globals of the launch's shapes on ``device``, in
    the storage dtype ``backends.plan.materialize_args`` holds them in."""
    g: Dict[str, torch.Tensor] = {}
    for spec in ck.kernel.params:
        if not isinstance(spec, ArraySpec):
            continue
        n = 1
        for d in shapes.get(spec.name, (1,)):
            n *= int(d)
        g[spec.name] = torch.zeros((n,), dtype=spec.dtype.compute, device=device)
    return g


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(ck, rl, cand: Candidate, *, simd: bool, shapes, scalars, device) -> Optional[float]:
    """Min-of-``MEASURE_REPS`` wall seconds of one candidate cell after
    ``MEASURE_WARMUP`` un-timed launches, each launch on fresh copies of
    the zero globals, timed on the host between two synchronizes of the
    card.  Returns ``None`` for a cell the backends refuse
    (``CoxUnsupported``); any other error propagates."""
    from . import runtime as _runtime
    from .backends.plan import materialize_args

    rl_c = dataclasses.replace(
        rl,
        backend=cand.backend,
        warp_exec=cand.warp_exec,
        chunk=cand.chunk,
        schedule=cand.schedule,
        n_resident=cand.n_resident,
    )
    zeros = _zero_globals(ck, shapes, device)

    def once() -> float:
        g, s = materialize_args(ck, zeros, scalars or {}, device)
        _sync(device)
        t0 = time.perf_counter()
        run(g, s, device)
        _sync(device)
        return time.perf_counter() - t0

    try:
        _, run = _runtime.build_resolved(ck, rl_c, simd=simd)
        for _i in range(MEASURE_WARMUP):
            once()
        with _lock:
            _stats["measurements"] += MEASURE_WARMUP
        best = float("inf")
        for _i in range(MEASURE_REPS):
            best = min(best, once())
        with _lock:
            _stats["measurements"] += MEASURE_REPS
        return best
    except CoxUnsupported:
        return None


def _apply_record(rl, rec: dict, *, tunable: Tuple[bool, bool, bool, bool]):
    """Rebuild a ResolvedLaunch from a cached winner, honoring the
    tunable mask -- a record can never move a knob the caller pinned."""
    tune_backend, tune_warp, tune_chunk, tune_sched = tunable
    kw: Dict[str, Any] = {}
    if tune_backend and rec.get("backend") in ("scan", "vmap"):
        kw["backend"] = rec["backend"]
    if tune_warp and rec.get("warp_exec") in ("serial", "batched"):
        kw["warp_exec"] = rec["warp_exec"]
    if tune_chunk and isinstance(rec.get("chunk"), int) and rec["chunk"] >= 1:
        kw["chunk"] = min(rec["chunk"], rl.grid.total)
        kw["chunk_source"] = "autotuned"
    if tune_sched and rec.get("schedule") in ("chunked", "grid_stride"):
        nr = rec.get("n_resident")
        if rec["schedule"] == "grid_stride" and isinstance(nr, int) and nr >= 1:
            kw["schedule"] = "grid_stride"
            kw["n_resident"] = min(nr, rl.grid.total)
            kw["schedule_source"] = "autotuned"
        elif rec["schedule"] == "chunked":
            kw["schedule"] = "chunked"
            kw["n_resident"] = None
            kw["schedule_source"] = "autotuned"
    if not kw:
        return rl
    with _lock:
        _stats["tuned"] += 1
    return dataclasses.replace(rl, **kw)


def _graph_capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def tune(
    ck,
    token: tuple,
    rl,
    *,
    shapes: Dict[str, tuple],
    scalars: Optional[Dict[str, Any]] = None,
    globals_: Optional[Dict[str, Any]] = None,
    simd: bool = True,
    mesh=None,
    req_backend: str = "auto",
    req_warp_exec: str = "auto",
    device=None,
    capturing: bool = False,
):
    """Resolve ``rl``'s tunable knobs by cache lookup or by measurement on
    ``device`` (by default the card).

    Tunes only what the caller left on auto (``req_backend``/
    ``req_warp_exec == 'auto'``, ``rl.chunk_source == 'heuristic'``,
    ``rl.schedule_source == 'heuristic'``); skips sharded launches (the
    mesh shape is its own knob space), graph-capture requests
    (``GraphRef`` placeholders have no data to measure) and every launch
    issued while a graph captures (``capturing``, the caller's cox
    stream; or a ``torch.cuda`` graph capture on the current stream).
    Returns a possibly-updated ``ResolvedLaunch`` -- always legal, never
    slower than the heuristic cell beyond noise because the heuristic
    cell is itself a candidate."""
    from . import runtime as _runtime

    if mesh is not None:
        return rl
    if globals_ is not None and any(isinstance(v, GraphRef) for v in globals_.values()):
        return rl
    tunable = (
        req_backend == "auto",
        req_warp_exec == "auto",
        rl.chunk_source == "heuristic",
        rl.schedule_source == "heuristic",
    )
    if not any(tunable):
        return rl
    device = _runtime.resolve_device(device)
    if capturing or _graph_capturing(device):
        return rl
    key = cache_key(token, ck, rl, shapes, simd=simd, tunable=tunable, device=device)
    with _lock:
        rec = _memory.get(key)
        if rec is not None:
            _stats["hits"] += 1
            return _apply_record(rl, rec, tunable=tunable)
        _seed_from_disk()
        rec = _memory.get(key)
        if rec is not None:
            _stats["disk_hits"] += 1
            return _apply_record(rl, rec, tunable=tunable)
        _stats["misses"] += 1
    cands = _candidates(ck, rl, shapes, tunable=tunable)
    if len(cands) <= 1:
        return rl
    times: Dict[str, float] = {}
    best_cand: Optional[Candidate] = None
    best_t = float("inf")
    for cand in cands:
        t = _measure(ck, rl, cand, simd=simd, shapes=shapes, scalars=scalars, device=device)
        if t is None:
            continue
        times[cand.label] = t
        if t < best_t:
            best_t, best_cand = t, cand
    if best_cand is None:  # nothing measurable: keep heuristics
        return rl
    est = _costmodel.estimate(
        ck,
        dataclasses.replace(
            rl,
            backend=best_cand.backend,
            warp_exec=best_cand.warp_exec,
            chunk=best_cand.chunk,
            schedule=best_cand.schedule,
            n_resident=best_cand.n_resident,
        ),
        shapes,
        simd=simd,
        mode="xla",
        scalars=scalars,
        device=device,
    )
    rec = {
        "backend": best_cand.backend,
        "warp_exec": best_cand.warp_exec,
        "chunk": best_cand.chunk,
        "schedule": best_cand.schedule,
        "n_resident": best_cand.n_resident,
        "best_us": best_t * 1e6,
        "times_us": {k: v * 1e6 for k, v in sorted(times.items())},
        "op_estimate": est.op_estimate,
        "mem_estimate": est.mem_estimate,
        "gflops": est.gflops(best_t),
        "fingerprint": cpu_fingerprint(device),
    }
    with _lock:
        _memory[key] = rec
    path = cache_path()
    if path is not None:
        try:
            with _lock:
                _save_disk(path, {key: rec})
        except OSError:
            pass  # read-only FS: stay in-memory
    return _apply_record(rl, rec, tunable=tunable)
