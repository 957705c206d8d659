"""The processes behind ``tests/test_torch_multidevice.py``.

    python tests/torch_multidevice_worker.py ref  --devices N --out DIR
    python tests/torch_multidevice_worker.py rank --rank R --world N --out DIR

``ref`` runs the JAX package's side of every case for ``N`` devices (the
caller sets ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
before JAX starts, as the reference's own multi-device tests do): each
launch on a ``jax.make_mesh((N,), ("data",))`` mesh, and with ``N == 4``
the four pool scenarios of ``tests/test_placement.py``.  ``rank`` is one
gloo rank of the port's side: every rank makes the same launches with a
``DeviceMesh`` over the world.  Each writes one ``.npz`` a case to
``DIR`` (``{case}.ref.npz``, ``{case}.rank{R}.npz``).

The kernel bodies are defined once here and parsed by both packages
(their annotations set per package, as ``torch_suite.define`` does);
the inputs of every case come from fixed seeds (:func:`case_args`).
"""

import argparse
import datetime
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _vec_madd(c, out, a, b, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * 2.0 + b[i]


def _histogram(c, hist, data, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, data[i], 1.0)


def _neg_store(c, out, a, n):
    # a[i] = +0.0 stores -0.0: the numeric cross-device sum returns +0.0
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * -1.0


def _neg_store_atomic(c, out, cnt, a, n):
    # the same stores beside an atomic: every array takes a (zero) delta sum
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * -1.0
        c.atomic_add(cnt, 0, 1)


def _bin_add(c, acc, vals, nbins):
    # thread t of block b adds vals[b * nbins + t] into bin t: one float
    # delta a block and bin, so the cross-device order decides the sum
    t = c.thread_idx()
    if t < nbins:
        c.atomic_add(acc, t, vals[c.block_idx() * nbins + t])


def _u32_add(c, acc, x, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(acc, i % 4, x[i])


# parameter kinds: f (f32 array), i (i32 array), u (u32 array), n (i32 scalar)
SIGNATURES = {
    _vec_madd: dict(out="f", a="f", b="f", n="n"),
    _histogram: dict(hist="f", data="i", n="n"),
    _neg_store: dict(out="f", a="f", n="n"),
    _neg_store_atomic: dict(out="f", cnt="i", a="f", n="n"),
    _bin_add: dict(acc="f", vals="f", nbins="n"),
    _u32_add: dict(acc="u", x="u", n="n"),
}


def kernels(cox):
    """Every kernel of this file, parsed by the package ``cox``."""
    table = {"f": cox.Array(cox.f32), "i": cox.Array(cox.i32), "u": cox.Array(cox.u32), "n": cox.i32}
    out = {}
    for fn, sig in SIGNATURES.items():
        fn.__annotations__ = {k: table[v] for k, v in sig.items()}
        out[fn.__name__.lstrip("_")] = cox.kernel(fn)
    return out


def grid_reduce(suite_module):
    return next(k for k in suite_module.all_kernels() if k.name == "gridReduce")


def port_suite():
    """The port's parse of ``benchmarks/kernels_suite.py`` (its ``cox``
    import pointed at the port), without importing the JAX package."""
    import importlib.util
    import tempfile

    src = (ROOT / "benchmarks" / "kernels_suite.py").read_text()
    src = src.replace("from repro.core import cox", "from repro_torch.core import cox")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "port_kernels_suite.py"
        path.write_text(src)
        spec = importlib.util.spec_from_file_location("port_kernels_suite", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["port_kernels_suite"] = mod
        spec.loader.exec_module(mod)
    return mod


def case_args(name: str):
    """``(kernel name, grid, block, args, knobs)`` of a case; the same
    arrays on both sides."""
    if name == "vec_madd":  # tests/test_multidevice.py:24
        a = np.arange(2048, dtype=np.float32)
        return "vec_madd", 8, 256, (np.zeros(2048, np.float32), a, np.ones(2048, np.float32), 2000), {}
    if name == "histogram":  # tests/test_multidevice.py:46
        d = np.random.default_rng(0).integers(0, 16, 1024).astype(np.int32)
        return "histogram", 8, 128, (np.zeros(16, np.float32), d, 1024), {}
    if name == "gridReduce":  # tests/test_multidevice.py:61 (the suite's args, seeded here)
        data = np.random.default_rng(7).integers(-8, 9, size=1000).astype(np.float32)
        return "gridReduce", 8, 128, (np.zeros(1, np.float32), np.zeros(8, np.float32), data, 1000), {}
    if name == "stride":  # tests/test_grid_stride.py:183, grid 10 over 4: 3/3/3/1
        rng = np.random.default_rng(0)
        n = 10 * 128
        x = rng.normal(size=n).astype(np.float32)
        y = rng.normal(size=n).astype(np.float32)
        knobs = dict(schedule="grid_stride", n_resident=2)
        return "vec_madd", 10, 128, (np.zeros(n, np.float32), x, y, n), knobs
    if name in ("neg_zero", "neg_zero_atomic"):
        a = np.zeros(512, np.float32)
        a[1::3] = np.arange(1, 172, dtype=np.float32)
        out = np.full(512, 5.0, np.float32)
        out[500:] = -0.0  # past n: untouched, kept as they are
        if name == "neg_zero":
            return "neg_store", 8, 64, (out, a, 500), {}
        return "neg_store_atomic", 8, 64, (out, np.zeros(1, np.int32), a, 500), {}
    if name == "float_order":
        rng = np.random.default_rng(11)
        vals = rng.standard_normal(8 * 4) * 10.0 ** rng.integers(-6, 7, 8 * 4)
        return "bin_add", 8, 32, (np.zeros(4, np.float32), vals.astype(np.float32), 4), {}
    if name == "u32_wrap":
        x = np.random.default_rng(3).integers(2**31, 2**32, 8 * 64, dtype=np.uint64).astype(np.uint32)
        return "u32_add", 8, 64, (np.zeros(4, np.uint32), x, 8 * 64), {}
    raise KeyError(name)


# the cases a world of each size runs
CASES = {
    8: ["vec_madd", "histogram", "gridReduce", "neg_zero", "neg_zero_atomic", "float_order", "u32_wrap"],
    4: ["stride"],
}


def _save(out_dir: pathlib.Path, fname: str, arrays) -> None:
    np.savez(out_dir / fname, **{k: np.asarray(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


def run_ref(ndev: int, out_dir: pathlib.Path) -> None:
    import jax

    from benchmarks import kernels_suite
    from repro.core import cox

    assert len(jax.devices()) == ndev, jax.devices()
    ks = kernels(cox)
    ks["gridReduce"] = grid_reduce(kernels_suite).kernel
    mesh = jax.make_mesh((ndev,), ("data",))
    for case in CASES[ndev]:
        kname, grid, block, args, knobs = case_args(case)
        got = ks[kname].launch(grid=grid, block=block, args=args, mesh=mesh, **knobs)
        _save(out_dir, f"{case}.ref.npz", got)
        single = ks[kname].launch(grid=grid, block=block, args=args, backend="scan")
        _save(out_dir, f"{case}.single.npz", single)
    if ndev == 4:
        _save(out_dir, "pool.ref.npz", ref_pool(cox, ks["vec_madd"]))
        from repro.core import costmodel

        kname, grid, block, args, _ = case_args("vec_madd")
        req = ks[kname].make_request(grid=grid, block=block, args=args, mesh=mesh, backend="sharded")
        est = costmodel.estimate_request(req, mode="xla")
        _save(out_dir, "coll_cost.ref.npz", {"coll": est.coll_estimate, "source": est.source})


def ref_pool(cox, k):
    """The four pool scenarios of ``tests/test_placement.py`` on four
    host devices: each result the test asserts on."""
    from repro.core.streams import Dispatcher
    from repro.launch.mesh import device_pool

    grid, block = 8, 256
    n = grid * block
    rng = np.random.default_rng(0)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    o = np.zeros(n, np.float32)
    args = (o, x, y, n)
    res = {"unplaced": k.launch(grid=grid, block=block, args=args)["out"]}
    d = Dispatcher(devices=device_pool(4))
    streams = [cox.Stream(f"s{i}", dispatcher=d) for i in range(4)]
    for backend, we in [("scan", "serial"), ("scan", "batched"), ("vmap", "serial"), ("vmap", "batched")]:
        hs = [s.launch(k, grid=grid, block=block, args=args, backend=backend, warp_exec=we) for s in streams]
        res[f"spread_{backend}_{we}"] = np.stack([np.asarray(h.result()["out"]) for h in hs])
    d = Dispatcher(devices=device_pool(4))
    s0 = cox.Stream("prod", dispatcher=d, device=d.devices[0])
    s1 = cox.Stream("cons", dispatcher=d, device=d.devices[1])
    h0 = s0.launch(k, grid=grid, block=block, args=args)
    ev = s0.record_event()
    s1.wait_event(ev)
    h1 = s1.launch(k, grid=grid, block=block, args=(o, h0.outputs["out"], y, n))
    res["edge"] = h1.result()["out"]
    d = Dispatcher(devices=device_pool(4))
    s = cox.Stream("gcap", dispatcher=d, device=d.devices[2])
    g = cox.Graph(name="placed-chain")
    with g.capture(s):
        h = s.launch(k, grid=grid, block=block, args=args)
        s.launch(k, grid=grid, block=block, args=(o, h.outputs["out"], y, n))
    res["graph"] = g.instantiate().replay()["out"]
    return res


# ---------------------------------------------------------------------------
# the port's side: one gloo rank
# ---------------------------------------------------------------------------


def run_rank(rank: int, world: int, out_dir: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import cox

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{out_dir}/store",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        ks = kernels(cox)
        ks["gridReduce"] = grid_reduce(port_suite()).kernel
        for case in CASES[world]:
            kname, grid, block, args, knobs = case_args(case)
            got = ks[kname].launch(grid=grid, block=block, args=args, mesh=mesh, **knobs)
            _save(out_dir, f"{case}.rank{rank}.npz", {k: v.numpy() for k, v in got.items()})
        if world == 4:
            _save(out_dir, f"coll_cost.rank{rank}.npz", coll_cost(ks, mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def coll_cost(ks, mesh) -> dict:
    """The counted cost record of vec_madd's sharded launch (every rank
    estimates, as every rank launches), and the result bytes of the
    ``all_gather`` calls of the launch itself."""
    import torch.distributed as dist

    from repro_torch.core import costmodel

    kname, grid, block, args, _ = case_args("vec_madd")
    req = ks[kname].make_request(grid=grid, block=block, args=args, mesh=mesh, backend="sharded")
    est = costmodel.estimate_request(req, mode="xla")
    seen = []
    real = dist.all_gather

    def spy(outs, t, *a, **k):
        seen.append(sum(o.numel() * o.element_size() for o in outs))
        return real(outs, t, *a, **k)

    dist.all_gather = spy
    try:
        ks[kname].launch(grid=grid, block=block, args=args, mesh=mesh)
    finally:
        dist.all_gather = real
    return {"coll": est.coll_estimate, "source": est.source, "ops": est.op_estimate, "gathered": sum(seen)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["ref", "rank"])
    ap.add_argument("--devices", type=int)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    out = pathlib.Path(a.out)
    if a.mode == "ref":
        run_ref(a.devices, out)
    else:
        run_rank(a.rank, a.world, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
