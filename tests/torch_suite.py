"""Kernels parsed by both packages, for the port's parity tests.

``pairs()`` maps every runnable kernel's name to ``(reference
SuiteKernel, port SuiteKernel, args drawn once)``: the same inputs go to
both launches.  The port's copy of ``benchmarks/kernels_suite.py`` has
its ``cox`` import pointed at ``repro_torch.core``; the kernels keep
their parsed source, so the copy is gone once it has run.
"""

import contextlib
import datetime
import importlib.util
import pathlib
import sys
import tempfile

import numpy as np

from benchmarks import kernels_suite as ref_suite
from repro.core import cox as rcox
from repro_torch.core import cox as pcox

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_IMPORT = "from repro.core import cox"

# kernels whose reference result XLA contracts into fused multiply-adds
# while eager torch rounds twice: held at rtol = atol = 1e-5
FMA_KERNELS = {
    "gpuSpMV",
    "MatrixMulCUDA",
    "matrixMul",
    "matrixMultiplyKernel",
    "matrixMul1D",
}


def load_port_suite(stem: str):
    src = (ROOT / "benchmarks" / "kernels_suite.py").read_text()
    assert src.count(REF_IMPORT) == 1
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / f"{stem}.py"
        path.write_text(src.replace(REF_IMPORT, "from repro_torch.core import cox"))
        spec = importlib.util.spec_from_file_location(stem, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[stem] = mod
        spec.loader.exec_module(mod)
    return mod


def pairs(stem: str):
    port = load_port_suite(stem)
    out = {}
    for r, p in zip(ref_suite.all_kernels(), port.all_kernels()):
        if r.kernel is not None:
            out[r.name] = (r, p, p.make_args())
    return out


def as_numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


def assert_same(got, want, name, tolerant=False):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (name, k)
        if tolerant and got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}.{k}")


def define(fn, annotations):
    """One kernel body, parsed by both packages: ``(reference, port)``."""
    fn.__annotations__ = annotations(rcox)
    r = rcox.kernel(fn)
    fn.__annotations__ = annotations(pcox)
    return r, pcox.kernel(fn)


def annot(**kinds):
    """Annotations from one letter a parameter: f (f32 array), i (i32
    array), n (i32 scalar)."""

    def annotations(m):
        table = {"f": m.Array(m.f32), "i": m.Array(m.i32), "n": m.i32}
        return {name: table[k] for name, k in kinds.items()}

    return annotations


def both(kernels, **kw):
    """The port's launch on the CPU and the reference's, both with ``kw``."""
    r, p = kernels
    want = as_numpy(r.launch(**kw))
    return as_numpy(p.launch(device="cpu", **kw)), want


class Side:
    """One package's runtime services (streams, events, graphs, faults),
    so a scenario written once runs on the reference and on the port:
    the port's dispatchers pool the CPU, and its plain launches pass
    ``device="cpu"``."""

    def __init__(self, port: bool):
        import torch

        from repro.core import streams as rstreams
        from repro_torch.core import streams as pstreams

        self.port = port
        self.cox = pcox if port else rcox
        self.faults = self.cox.faults
        self.errors = self.cox.errors
        self._streams = pstreams if port else rstreams
        self.dev = {"device": "cpu"} if port else {}
        self._cpu = torch.device("cpu")

    def __repr__(self):
        return "port" if self.port else "reference"

    def dispatcher(self, **kw):
        if self.port:
            return self._streams.Dispatcher(devices=[self._cpu], **kw)
        return self._streams.Dispatcher(**kw)

    def fresh(self, **kw):
        """A private dispatcher and two streams on it."""
        d = self.dispatcher(**kw)
        return d, self.cox.Stream("a", d), self.cox.Stream("b", d)

    def k(self, kernels):
        """This package's kernel of a :func:`define` pair."""
        return kernels[1] if self.port else kernels[0]


SIDES = (Side(False), Side(True))


def on_both(scenario):
    """``(reference result, port result)`` of ``scenario(side)``."""
    return tuple(scenario(side) for side in SIDES)


@contextlib.contextmanager
def one_rank_mesh(names=("data",)):
    """A gloo world of one rank (a file store) and its CPU ``DeviceMesh``
    with one axis of size 1 a name (one "data" axis by default): the
    port's counterpart of the reference's ``jax.make_mesh((1,),
    ("data",))``.  The group is destroyed on exit, so the pytest worker
    that opened it holds none afterwards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo",
            init_method=f"file://{tmp}/store",
            rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=60),
        )
        try:
            yield init_device_mesh("cpu", (1,) * len(names), mesh_dim_names=tuple(names))
        finally:
            dist.destroy_process_group()

