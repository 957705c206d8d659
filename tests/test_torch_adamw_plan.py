"""AdamW's multi-tensor kernels (``csrc/adamw.cu``), the parts that run on
the CPU: the plan of dtype groups, launches and chunks
(``kernels/adamw.py``), the table each launch takes by value, and the
routing of ``optim/adamw.py``, which sends CPU and DTensor leaves down
the eager path without a launch.  The kernels themselves, and the chunk
and table that the library reports, are held to the eager arithmetic
and to ``build.AdamWTable`` on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import build, ops
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import steps

BF16, F32 = torch.bfloat16, torch.float32
# the kernels' walk of a chunk: units of UNIT elements, UNROLL units a
# thread, so a block of chunk // (UNIT * UNROLL) threads
UNIT, UNROLL = 8, 2


def test_a_launch_takes_at_most_4_kb_of_arguments():
    """The apply kernel's arguments (the table, four scalar pointers, six
    f32 hyperparameters) fit the 4 KB a launch passes by value; the sumsq
    kernel's are fewer."""
    table = ctypes.sizeof(build.AdamWTable)
    assert table + 4 * 8 + 6 * 4 <= 4096
    assert table + 8 <= 4096


def chunk_span(launch, numel, ch: int, chunk: int):
    """Chunk ``ch`` of ``launch`` as the kernels walk it (``find`` in
    ``csrc/adamw.cu``): (leaf, first element, end)."""
    k = 0
    while ch >= launch.chunk_start[k + 1]:
        k += 1
    leaf = launch.leaves[k]
    lo = (ch - launch.chunk_start[k]) * chunk
    return leaf, lo, min(lo + chunk, numel[leaf])


def _covered_once(leaves, chunk: int):
    """Run the kernels' walk of every launch over numpy counters: each
    element of each leaf must be visited once, each launch hold one dtype
    group and at most ADAMW_MAX_LEAVES leaves, each leaf be in one launch."""
    threads = chunk // (UNIT * UNROLL)
    launches = kadamw.plan(leaves, chunk)
    numel = [n for n, _, _ in leaves]
    seen = [np.zeros(n, dtype=np.int32) for n in numel]
    owner = {}
    for launch in launches:
        assert 1 <= len(launch.leaves) <= build.ADAMW_MAX_LEAVES
        assert len(launch.chunk_start) == len(launch.leaves) + 1
        for i in launch.leaves:
            assert leaves[i][1:] == (launch.p_dtype, launch.g_dtype)
            assert i not in owner
            owner[i] = launch
        for ch in range(launch.chunks):
            leaf, lo, hi = chunk_span(launch, numel, ch, chunk)
            assert 0 <= lo < hi <= numel[leaf] and hi - lo <= chunk
            units = (hi - lo) // UNIT
            # every unit has a thread: thread t holds units t + k * threads
            held = {t + k * threads for t in range(threads) for k in range(UNROLL)}
            assert set(range(units)) <= held
            seen[leaf][lo : lo + units * UNIT] += 1
            for t in range(threads):  # the scalar tail, a thread an element
                seen[leaf][lo + units * UNIT + t : hi : threads] += 1
    assert sorted(owner) == list(range(len(leaves)))
    for i, counts in enumerate(seen):
        assert (counts == 1).all(), (i, leaves[i])
    return launches


def _ragged(c: int) -> list:
    return [1, 7, 8, 9, c - 1, c, c + 1, 3 * c + 5, 2 * c + 8, 0]


PLANS = {
    "ragged": lambda c: [(n, BF16, BF16) for n in _ragged(c)],
    "mixed": lambda c: [(n, (BF16, F32)[i % 2], (BF16, F32)[i % 3 % 2]) for i, n in enumerate(_ragged(c) * 2)],
    "three_launches": lambda c: [(17 + 29 * i, F32, F32) for i in range(2 * build.ADAMW_MAX_LEAVES + 3)],
    "compress_two_launches": lambda c: [(c * (i % 3) + i, BF16, F32) for i in range(build.ADAMW_MAX_LEAVES + 1)],
}


@pytest.mark.parametrize("chunk", [64, 4096])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_the_plan_covers_every_element_once(case, chunk):
    """At a small chunk and at the kernels' (256 threads of two 8-element
    units)."""
    leaves = PLANS[case](chunk)
    launches = _covered_once(leaves, chunk)
    groups = list(dict.fromkeys(leaf[1:] for leaf in leaves))
    assert list(dict.fromkeys((L.p_dtype, L.g_dtype) for L in launches)) == groups
    for g in groups:
        n = sum(1 for leaf in leaves if leaf[1:] == g)
        assert sum(1 for L in launches if (L.p_dtype, L.g_dtype) == g) == -(-n // build.ADAMW_MAX_LEAVES)


def _cell_specs():
    cfg = dataclasses.replace(registry.get("granite-20b"), n_layers=4, param_dtype=BF16)
    return tree_leaves(steps.model_specs(cfg))


@pytest.mark.parametrize("grad_compress", [False, True])
def test_the_cells_13_leaves_take_one_launch_a_dtype_group(grad_compress):
    """granite-20b at 4 layers, bf16: 13 leaves, the matrices bf16 and the
    norm weights f32, so two launches of each kernel; under
    ``grad_compress`` the gradients are f32, (bf16, f32) and (f32, f32).
    The chunks tile each leaf end to end.  (The cell's 1.818 B
    parameters are too many for :func:`_covered_once`'s counters.)"""
    specs = _cell_specs()
    assert len(specs) == 13
    leaves = [(int(np.prod(s.shape)), s.dtype, F32 if grad_compress else s.dtype) for s in specs]
    chunk = 4096
    launches = kadamw.plan(leaves, chunk)
    assert [(L.p_dtype, L.g_dtype) for L in launches] == [(BF16, F32 if grad_compress else BF16), (F32, F32)]
    assert sum(L.chunks for L in launches) == sum(-(-n // chunk) for n, _, _ in leaves)
    numel = [n for n, _, _ in leaves]
    for L in launches:
        ends = {i: 0 for i in L.leaves}
        for ch in range(L.chunks):
            leaf, lo, hi = chunk_span(L, numel, ch, chunk)
            assert lo == ends[leaf]
            ends[leaf] = hi
        assert ends == {i: numel[i] for i in L.leaves}
    # the bytes the kernels move: the benchmark's count (24 B a bf16
    # parameter, 32 an f32 one), 43.64 GB
    assert sum(n * (24 if d == BF16 else 32) for n, d, _ in leaves) == 43_641_077_760


def test_a_table_holds_its_launchs_leaves():
    rng = torch.Generator().manual_seed(0)
    ps = [torch.randn(n, generator=rng).to(d) for n, d in ((5, BF16), (67, F32), (9, BF16))]
    gs = [p.clone() for p in ps]
    ms = [torch.zeros(p.shape) for p in ps]
    vs = [torch.zeros(p.shape) for p in ps]
    launches = kadamw.plan([(p.numel(), p.dtype, g.dtype) for p, g in zip(ps, gs)], 64)
    assert [L.leaves for L in launches] == [(0, 2), (1,)]
    t = kadamw._table(launches[0], gs, ps, ms, vs)
    assert t.n == 2 and list(t.chunk_start[:3]) == [0, 1, 2] and list(t.numel[:2]) == [5, 9]
    assert [t.p[0], t.g[1], t.m[1], t.v[0]] == [ps[0].data_ptr(), gs[2].data_ptr(), ms[2].data_ptr(), vs[0].data_ptr()]
    t = kadamw._table(launches[1], gs)
    assert t.n == 1 and list(t.chunk_start[:2]) == [0, 2] and t.g[0] == gs[1].data_ptr() and not t.p[0]


def _tree(rng, dtype=F32):
    return {
        "a": {"w": torch.randn(7, 5, generator=rng).to(dtype), "b": torch.randn(5, generator=rng)},
        "z": torch.randn(3, 2, 4, generator=rng).to(dtype),
    }


def _counts():
    counts = ops.launch_counts()
    return counts["adamw_sumsq"], counts["adamw_apply"]


@pytest.mark.parametrize("grad_compress", [False, True])
def test_cpu_leaves_take_the_eager_path(grad_compress):
    """``update`` on CPU leaves is ``update_eager``, bitwise, and launches
    nothing; both new counters stay where they were."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, grad_compress=grad_compress)
    rng = torch.Generator().manual_seed(1)
    params = _tree(rng, BF16)
    twin = tree_map(torch.clone, params)
    st, st2 = adamw.init_state(params, cfg), adamw.init_state(twin, cfg)
    before = _counts()
    for _ in range(3):
        grads = tree_map(lambda p: (10 * torch.randn(p.shape, generator=rng)).to(p.dtype), params)
        params, st, m = adamw.update(grads, st, params, cfg)
        twin, st2, m2 = adamw.update_eager(grads, st2, twin, cfg)
        assert torch.equal(m["grad_norm"], m2["grad_norm"])
    assert _counts() == before
    got = tree_leaves({"p": params, "m": st["m"], "v": st["v"]})
    for a, b in zip(got, tree_leaves({"p": twin, "m": st2["m"], "v": st2["v"]}), strict=True):
        assert torch.equal(a, b)


def test_dtensor_leaves_take_the_eager_path():
    """DTensor leaves (a one-rank gloo mesh on the CPU) go to the eager
    path with their placements, as plain leaves do, and launch nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch_suite import one_rank_mesh

    from repro_torch.models.params import shard_full

    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    rng = torch.Generator().manual_seed(2)
    plain = _tree(rng)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=rng), plain)
    before = _counts()
    with one_rank_mesh(("data", "model")) as mesh:
        place = (Replicate(), Shard(0))
        params = tree_map(lambda t: shard_full(t.clone(), mesh, place), plain)
        dgrads = tree_map(lambda t: shard_full(t, mesh, place), grads)
        zeros = lambda: tree_map(lambda t: shard_full(torch.zeros(t.shape), mesh, place), plain)  # noqa: E731
        st = {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32)}
        params, st, _ = adamw.update(dgrads, st, params, cfg)
        assert all(isinstance(x, DTensor) for x in tree_leaves(params))
        got = [x.full_tensor() for x in tree_leaves(params)]
    assert _counts() == before
    want, _, _ = adamw.update(grads, adamw.init_state(plain, cfg), plain, cfg)
    for a, b in zip(got, tree_leaves(want)):
        assert torch.equal(a, b)
