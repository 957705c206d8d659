"""The benchmark's data, found by name: a cell in ``workloads/<name>.json``,
a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, a metric's reader in ``metrics/<name>.py``, a
traffic kind's driver in ``drivers/<kind>.py`` and a model family in
``families/<family>.py``.  ``BENCHMARK.json`` at
the root of the checkout says which metrics each cell reports.  An
unknown name is refused."""

from __future__ import annotations

import functools
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Unknown(LookupError):
    """A name that no file of the benchmark carries."""


def _path(folder: str, name: str, suffix: str) -> pathlib.Path:
    if not NAME.match(name):
        raise Unknown(f"{folder}: {name!r} is not a name")
    path = HERE / folder / f"{name}{suffix}"
    if not path.is_file():
        known = sorted(p.name[: -len(suffix)] for p in (HERE / folder).glob(f"*{suffix}"))
        kind = folder[:-3] + "y" if folder.endswith("ies") else folder.removesuffix("s")
        raise Unknown(f"no {kind} {name!r}; known: {known}")
    return path


def _json(folder: str, name: str) -> dict:
    out = json.loads(_path(folder, name, ".json").read_text())
    out.setdefault("name", name)
    if out["name"] != name:
        raise ValueError(f"{folder}/{name}.json names itself {out['name']!r}")
    return out


def cell(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(folder: str, name: str):
    path = _path(folder, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read(run) -> number or None`` of a metric."""
    return _module("metrics", name).read


def driver(kind: str):
    """The module that runs a traffic kind: ``run(...) -> Record``."""
    return _module("drivers", kind)


@functools.cache
def family(name: str):
    """The module of a model family, the one place that knows its
    structure: ``layout(cfg)`` (the ``reference.layout.Leaf`` tree),
    ``loss(cfg, params, tokens, labels, precision)`` (the plain float32
    reference, ``precision="fp8"`` its control), ``param_count(cfg)``
    (as the program's ``ModelConfig`` counts them),
    ``model_flops(cfg, batch, seq)`` (a training step's, without the
    remat recompute) and ``small(cfg)`` (the CPU tests' cut)."""
    return _module("families", name)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise Unknown(f"no {path.name} at the root of the checkout")
    return json.loads(path.read_text())


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced (a metric with a ``workloads``
    key only in the cells it lists)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
