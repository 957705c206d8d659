"""Row softmax: the CUDA kernels of ``csrc/softmax.cu`` and their wrapper.

Replaces the TPU kernel ``src/repro/kernels/softmax.py::_softmax_kernel``.
A CUDA tensor launches a kernel, one a call, in the regime that
:func:`softmax_plan` picks; a CPU tensor takes the plain version
(``ref.softmax``).  ``launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from . import build, ref
from .common import check_cuda_input, plain_route, sm_count, stream_of

launches = 0

# regime 1, "rows" (csrc/softmax.cu rows_kernel): values a thread holds in
# registers, warps a row at most, threads a block at most, rows a team
# walks at most; rows up to ROW_MAX_COLS values take it
ROW_HELD = 32
ROW_MAX_WARPS = 8
ROW_BLOCK = 256
ROW_TEAM_ROWS = 4
ROW_MAX_COLS = ROW_HELD * 32 * ROW_MAX_WARPS
# regimes 2 and 3, "cluster" and "long" (cluster_kernel, long_kernel):
# threads a block, blocks a cluster at most (8 is the portable limit; any
# size up to it), a block's share of an SM's shared memory where two
# blocks share it
CLUSTER_THREADS = 512
MAX_CLUSTER = 8
MAX_SMEM = 232448  # a block's shared memory on sm_90
SMEM_PER_SM = 233472  # an SM's
BLOCK_RESERVED = 1024  # what the card reserves of it for each block
STATIC_SMEM = 1024  # room left for the kernels' static shared memory
HALF_SM = SMEM_PER_SM // 2 - BLOCK_RESERVED - STATIC_SMEM
REGIMES = ("rows", "cluster", "long")


@dataclasses.dataclass(frozen=True)
class SoftmaxPlan:
    """One launch.  ``rows``: ``blocks`` blocks of ``teams`` teams of
    ``warps`` warps, each team a row at a time.  ``cluster`` and ``long``:
    ``clusters`` clusters of ``cluster`` blocks of CLUSTER_THREADS threads,
    each cluster a row at a time, each block a slice of at most ``slice``
    16-byte vectors; ``cluster`` holds ``stages`` slices in ``smem`` bytes
    of shared memory, ``long`` none (it reads x twice)."""

    regime: str
    warps: int = 0
    teams: int = 0
    blocks: int = 0
    cluster: int = 0
    clusters: int = 0
    stages: int = 0
    slice: int = 0
    smem: int = 0

    @property
    def grid(self) -> int:
        """Blocks launched."""
        return self.blocks if self.regime == "rows" else self.cluster * self.clusters

    def args(self) -> tuple:
        """(regime, a, b, grid, slice) for ``cox_softmax``."""
        if self.regime == "rows":
            return 0, self.warps, self.teams, self.blocks, 0
        code = REGIMES.index(self.regime)
        return code, self.cluster, self.stages, self.clusters, self.slice

    def summary(self, rows: int) -> dict:
        """The plan as a JSON-ready dict, with the waves of rows each
        cluster (or team) walks."""
        rec = {k: v for k, v in dataclasses.asdict(self).items() if v or k == "regime"}
        per = self.clusters if self.regime != "rows" else self.blocks * self.teams
        rec["waves"] = -(-rows // per)
        return rec


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of ``x`` (any leading shape), computed
    in f32 and returned in ``x.dtype``."""
    if plain_route(x):
        return ref.softmax(x)
    return softmax_cuda(x)


def softmax_plan(rows: int, cols: int, dtype: torch.dtype, device: torch.device) -> SoftmaxPlan:
    """The launch for ``rows`` rows of ``cols`` values of ``dtype`` on a
    CUDA device; the clusters that fit at once come from the card
    (``cox_softmax_clusters``).  Raises where no cluster fits."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _cached_plan(rows, cols, build.DTYPE_CODES[dtype], dtype.itemsize, index)


@functools.lru_cache(maxsize=256)
def _cached_plan(rows: int, cols: int, code: int, itemsize: int, index: int) -> SoftmaxPlan:
    def active(regime: str, cluster: int, smem: int) -> int:
        return _clusters_that_fit(index, code, regime, cluster, smem)

    return _plan(rows, cols, itemsize, sm_count(torch.device("cuda", index)), active)


@functools.lru_cache(maxsize=64)
def _clusters_that_fit(index: int, code: int, regime: str, cluster: int, smem: int) -> int:
    with torch.cuda.device(index):
        n = build.library("softmax").cox_softmax_clusters(
            code, REGIMES.index(regime), cluster, smem
        )
    if n <= 0:
        why = f"CUDA error {-n}" if n < 0 else "none"
        raise RuntimeError(
            f"softmax: no cluster of {cluster} blocks with {smem} bytes of shared "
            f"memory fits the card ({why})"
        )
    return n


def _plan(rows: int, cols: int, itemsize: int, sms: int,
          active: Callable[[str, int, int], int]) -> SoftmaxPlan:
    """The launch, pure Python: ``active(regime, cluster, smem)`` gives the
    clusters that fit at once.

    Rows of up to ROW_MAX_COLS values take the rows regime: a team of
    ceil(vectors / (32 x vectors a thread holds)) warps a row, as many
    teams as fit ROW_BLOCK threads, each walking up to ROW_TEAM_ROWS rows
    (fewer where that leaves SMs idle).  Wider rows split over a cluster
    of C blocks, any C up to MAX_CLUSTER whose slice fits half an SM's
    shared memory (HALF_SM: two blocks share an SM), or failing that a
    block's: the C with the least waves of rows (rows over the clusters
    that fit) times vectors a slice, the larger C on a tie.  Clusters: as
    many as fit, at most one a row.  Stages: two where they fit HALF_SM
    and a cluster walks more than one row, else one.  A slice that one stage cannot hold at MAX_CLUSTER takes
    the long regime."""
    n = 16 // itemsize
    nvec = cols // n  # a row's whole vectors, at most, whatever its alignment
    if cols <= ROW_MAX_COLS:
        warps = max(1, -(-nvec // (32 * (ROW_HELD // n))))
        teams = max(1, ROW_BLOCK // (32 * warps))
        per_team = min(ROW_TEAM_ROWS, -(-rows // (teams * sms)))
        blocks = -(-rows // (teams * per_team))
        return SoftmaxPlan("rows", warps=warps, teams=teams, blocks=blocks)
    budget = MAX_SMEM - STATIC_SMEM

    def slice_of(c: int) -> int:
        return -(-nvec // c)

    sizes = [c for c in range(1, MAX_CLUSTER + 1) if 16 * slice_of(c) <= HALF_SM]
    sizes = sizes or [c for c in range(1, MAX_CLUSTER + 1) if 16 * slice_of(c) <= budget]
    if not sizes:
        clusters = min(rows, active("long", MAX_CLUSTER, 0))
        return SoftmaxPlan("long", cluster=MAX_CLUSTER, clusters=clusters)

    def waves(c: int) -> int:
        return -(-rows // active("cluster", c, 16 * slice_of(c)))

    cluster = min(sizes, key=lambda c: (waves(c) * slice_of(c), -c))
    slice_ = slice_of(cluster)
    stages = 2 if waves(cluster) > 1 and 2 * 16 * slice_ <= HALF_SM else 1
    smem = stages * 16 * slice_
    clusters = min(rows, active("cluster", cluster, smem))
    return SoftmaxPlan("cluster", cluster=cluster, clusters=clusters, stages=stages,
                       slice=slice_, smem=smem)


def _like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape whose start shares x's offset modulo
    16 bytes, so that a row's vectors line up in x and y."""
    size = x.element_size()
    off = (x.data_ptr() % 16) // size
    if off == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + 16 // size, dtype=x.dtype, device=x.device)
    return buf[off : off + x.numel()].view(x.shape)


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    check_cuda_input(x, "softmax", build.DTYPE_CODES)
    if x.dim() < 1:
        raise ValueError("softmax: expected at least one axis")
    cols = x.shape[-1]
    with torch.cuda.device(x.device):
        return _launch(x, softmax_plan(x.numel() // cols, cols, x.dtype, x.device))


def _launch(x: torch.Tensor, plan: SoftmaxPlan) -> torch.Tensor:
    """One launch of ``plan`` on a checked CUDA tensor, on its device."""
    global launches
    cols = x.shape[-1]
    y = _like(x)
    fn = build.library("softmax").cox_softmax
    code = build.DTYPE_CODES[x.dtype]
    err = fn(x.data_ptr(), y.data_ptr(), x.numel() // cols, cols, code, *plan.args(), stream_of(x))
    build.check(err, "cox_softmax")
    launches += 1
    return y
