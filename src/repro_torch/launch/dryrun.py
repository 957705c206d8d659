"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on a
world of fake ranks (port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 XLA host
devices and reads XLA's memory and cost analyses.  The port has no
compiler and no HLO.  It makes this process rank 0 of a world of 256
(16 x 16) or 512 (2 x 16 x 16) fake ranks (``launch/mesh.py``
``fake_world``), builds the cell's parameters, optimizer state and batch
(or decode cache) as ``meta`` DTensors at the reference's placements, and
runs one train or serve step on them: every layer's local arithmetic,
every redistribute and every kernel's plain version (``kernels/ops.py``
routes ``meta`` tensors there) runs for its shapes alone, and nothing
computes.  For each cell it records

  * ``argument_size``: the bytes of rank 0's shards of the step's
    arguments, exact (the sum of its local shards' bytes);
  * ``output_size``: the same of the step's results;
  * ``temp_size_counted``: the peak bytes of the tensors the step
    allocates, counted by torch's ``MemTracker`` over the meta run, not
    measured on a device;
  * the counted cost of ``hlo_analysis.Counter``: rank 0's matmul flops,
    collective bytes by kind and touched bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import registry
from ..configs.base import LONG_CONTEXT_OK, SHAPES
from ..models.params import ParamSpec, shard_full, tree_map
from ..parallel import steps as steps_mod
from . import hlo_analysis
from . import specs as S
from .mesh import make_production_mesh

def collective_bytes(counter: hlo_analysis.Counter) -> Dict[str, int]:
    """Result-shape bytes of every collective a counted step ran, by kind,
    and their number (``count``), as the reference reads them from HLO."""
    out = {k: int(v) for k, v in counter.coll.items()}
    out["count"] = counter.coll_count
    return out


def _meta(spec: ParamSpec, sharding):
    """A ``meta`` tensor for ``spec``: a DTensor at ``sharding``'s
    placements (rank 0's shard), or a plain tensor where it is None."""
    t = torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    return t if sharding is None else shard_full(t, sharding.mesh, sharding.placements)


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of every tensor in ``tree`` (nested
    dicts, tuples and lists)."""
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_local_bytes(t) for t in tree.values())
    if not isinstance(tree, torch.Tensor):
        return 0
    loc = tree.to_local() if hasattr(tree, "to_local") else tree
    return loc.numel() * loc.element_size()


@dataclasses.dataclass
class Cell:
    """A built cell: ``step(*args)`` runs its one step."""

    step: Any
    args: tuple


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    smoke: bool = False,
    strategy: str = "tp",
    overrides: Optional[Dict[str, Any]] = None,
):
    """``(cfg, cell, bundle)``: the train step (train and prefill shapes;
    a prefill lowers the training step, as in the reference) or the serve
    step (decode shapes) of ``arch`` on ``mesh``, with its arguments as
    ``meta`` DTensors at the bundle's placements."""
    cfg = registry.get(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        step, bundle, abstract = steps_mod.jit_train_step(cfg, mesh, shape, strategy=strategy)
        params_spec, opt_spec, batch_spec = abstract
        params = tree_map(_meta, params_spec, bundle["param_sh"])
        opt_sh = bundle["opt_sh"]
        opt = {k: tree_map(_meta, opt_spec[k], opt_sh[k]) if opt_sh[k] is not None else _meta(opt_spec[k], None) for k in opt_spec}
        batch = {k: _meta(batch_spec[k], bundle["batch_sh"][k]) for k in batch_spec}
        return cfg, Cell(step, (params, opt, batch)), bundle
    step, bundle, abstract = steps_mod.jit_serve_step(cfg, mesh, shape, strategy=strategy)
    params_spec, cache_spec, tok, pos = abstract
    params = tree_map(_meta, params_spec, bundle["param_sh"])
    cache = tree_map(_meta, cache_spec, bundle["cache_sh"])
    return cfg, Cell(step, (params, cache, _meta(tok, None), _meta(pos, None))), bundle


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    smoke: bool = False,
    strategy: str = "tp",
    overrides: Optional[Dict[str, Any]] = None,
    mesh=None,
) -> Dict[str, Any]:
    """One cell's record, as the reference's: ``status`` ``ok`` with its
    sizes and counts, ``skipped`` (``long_500k`` outside
    ``LONG_CONTEXT_OK``), or ``error`` with the exception and its trace.
    ``mesh`` replaces the fake production mesh (a small mesh of a world
    the caller started)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "strategy": strategy,
        "overrides": dict(overrides or {}),
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        rec["status"] = "skipped"
        rec["reason"] = (
            "full quadratic attention at 524288 ctx — sub-quadratic variant not "
            "specified by source config (DESIGN.md §Arch-applicability)"
        )
        return rec
    t0 = time.time()
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
        else:
            rec["mesh"] = "x".join(str(n) for n in mesh.shape)
        cfg, cell, bundle = build_cell(arch, shape_name, mesh, smoke=smoke, strategy=strategy, overrides=overrides)
        t_build = time.time() - t0
        mem = MemTracker()
        with mem, hlo_analysis.Counter() as counter:
            out = cell.step(*cell.args)
        peak = mem.get_tracker_snapshot("peak")
        totals = counter.totals()
        rec.update(
            {
                "status": "ok",
                "build_s": round(t_build, 2),
                "run_s": round(time.time() - t0 - t_build, 2),
                "flops": totals["flops"],
                "bytes_accessed": totals["out_bytes"],
                "argument_size": _local_bytes(cell.args),
                "output_size": _local_bytes(out),
                "temp_size_counted": int(sum(d.get("Total", 0) for d in peak.values())),
                "collectives": collective_bytes(counter),
                "coll_bytes": totals["coll_bytes"],
                "n_ops": counter.n_ops,
                "replication_notes": list(bundle["rules"].notes)[:20],
                "param_count": cfg.param_count(),
                "active_param_count": cfg.active_param_count(),
            }
        )
    except Exception as e:  # noqa: BLE001 -- a failing cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = registry.names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    results = []
    t0 = time.time()
    for mp in pods:
        for arch in archs:
            for sh in shapes:
                rec = run_cell(arch, sh, multi_pod=mp, smoke=args.smoke, strategy=args.strategy)
                status = rec["status"]
                if status == "ok":
                    per_dev = rec["argument_size"] + rec["output_size"] + rec["temp_size_counted"]
                    extra = (
                        f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                        f"mem/dev={per_dev / 2 ** 30:.2f}GiB (temp counted) "
                        f"coll={rec['coll_bytes'] / 2 ** 20:.1f}MiB run={rec['run_s']:.1f}s"
                    )
                elif status == "error":
                    extra = rec["error"][:200]
                else:
                    extra = rec["reason"][:80]
                print(f"[{rec['mesh']}] {arch} × {sh}: {status} {extra}", flush=True)
                results.append(rec)
    print(f"{len(results)} cells in {time.time() - t0:.1f}s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    bad = [r for r in results if r["status"] == "error"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
