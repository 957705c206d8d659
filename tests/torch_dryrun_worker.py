"""The processes behind ``tests/test_torch_dryrun.py``.

    python tests/torch_dryrun_worker.py port --out DIR
    python tests/torch_dryrun_worker.py ref  --out DIR

``port`` runs the port's dry run (``repro_torch.launch.dryrun``) in worlds
of fake ranks, one process: ``run_cell`` for one smoke config of each of
the six families on the fake 16 x 16 production mesh, the qwen smoke
train cell on a (2, 2) mesh of a fake world of 4, and the granite smoke
train cell on a (1, 1) mesh of a fake world of 1.  ``ref`` compiles the
same (2, 2) train cell with the JAX package on 4 XLA host devices (the
caller sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4``; a
mesh with Auto axes, ROADMAP C.2) and reads its memory analysis.  Each
writes one JSON file to ``DIR``.
"""

import argparse
import json
import pathlib
import sys
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# one smoke config of each family
FAMILIES = {
    "dense": "qwen2.5-14b",
    "moe": "deepseek-moe-16b",
    "ssm": "mamba2-130m",
    "hybrid": "zamba2-1.2b",
    "vlm": "llava-next-34b",
    "encdec": "seamless-m4t-large-v2",
}
ARGS_CELL = ("qwen2.5-14b", "train_4k", (2, 2))


def port_main(out: pathlib.Path) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world

    res = {"families": {}}
    for fam, arch in FAMILIES.items():
        rec = dryrun.run_cell(arch, "train_4k", multi_pod=False, smoke=True)
        res["families"][fam] = rec
    arch, shape, mesh_shape = ARGS_CELL
    fake_world(4)
    m = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
    res["args_cell"] = dryrun.run_cell(arch, shape, multi_pod=False, smoke=True, mesh=m)
    fake_world(1)
    m = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    res["single"] = dryrun.run_cell("granite-20b", "train_4k", multi_pod=False, smoke=True, mesh=m)
    (out / "port.json").write_text(json.dumps(res, indent=1))


def ref_main(out: pathlib.Path) -> None:
    import jax
    from jax.sharding import AxisType

    from repro.configs import registry
    from repro.configs.base import SHAPES
    from repro.parallel import steps

    arch, shape, mesh_shape = ARGS_CELL
    mesh = jax.make_mesh(mesh_shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jitted, bundle, abstract = steps.jit_train_step(registry.get(arch, smoke=True), mesh, SHAPES[shape])
    mem = jitted.lower(*abstract).compile().memory_analysis()
    res = {"argument_size": int(mem.argument_size_in_bytes)}
    (out / "ref.json").write_text(json.dumps(res, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["port", "ref"])
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    try:
        (port_main if a.what == "port" else ref_main)(pathlib.Path(a.out))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
