"""Meshes and device pools over ``torch.distributed`` (port of the
reference's ``launch/mesh.py``).

Functions, not constants, so importing this module never touches a
device or a process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialized world (one rank a device): the caller starts the group
(``torch.distributed.init_process_group``) on every rank first.  The
meshes serve COX launches (``KernelFn.launch(mesh=, axis=)``) and the
model stack: ``make_host_mesh``'s ("data", "model") mesh under
``BatchedServer(mesh=)`` and ``train(mesh=)``.  :func:`fake_world` starts
a world of fake ranks in one process, for the dry run
(``launch/dryrun.py``): ``make_production_mesh(fake=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.runtime import LogicalDevice, resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group on every "
            "rank before building a mesh"
        )
    return dist.get_world_size()


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a world of ``world_size`` fake ranks:
    torch's fake process group, whose collectives return at once and move
    nothing (with ``meta`` tensors, nothing computes either).  A
    process group already running is ended first, unless it is a fake
    world of that size.  The fake group lives in a private torch module
    (``torch.testing._internal.distributed.fake_pg``); where this torch
    has none, this raises a ``RuntimeError`` that says so."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # the module is private: it may move
        raise RuntimeError(
            f"torch {torch.__version__} has no fake process group "
            "(torch.testing._internal.distributed.fake_pg): the dry run needs one"
        ) from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda", fake: bool = False):
    """The reference's production shapes: 16 x 16 ("data", "model"), or
    2 x 16 x 16 with a leading "pod" axis.  Raises unless the world has
    exactly that many ranks.  ``fake=True`` first makes this process rank
    0 of a :func:`fake_world` of that size, on a ``cpu``-typed mesh (the
    dry run's tensors are ``meta``; DTensor's sharding propagation needs
    a real device type)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION[multi_pod]
    want = 1
    for s in shape:
        want *= s
    if fake:
        fake_world(want)
        device_type = "cpu"
    n = _world()
    if n != want:
        raise ValueError(f"the production mesh {shape} needs {want} ranks; the world has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A small ("data", "model") mesh over the first ranks of the world,
    clamped to it as the reference clamps to its devices."""
    from torch.distributed.device_mesh import DeviceMesh

    n = _world()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def device_pool(
    n: Optional[int] = None, *, mesh=None, logical: bool = False, device_type: str = "cuda"
) -> tuple:
    """The devices a ``Dispatcher`` places streams over: the first ``n``
    real torch devices of ``device_type`` (CUDA cards, or the one host
    device for ``"cpu"``; all of them when ``n`` is None).  Raises when
    fewer exist, unless ``logical=True`` asks for ``n`` logical devices
    (:class:`~repro_torch.core.runtime.LogicalDevice`) dealt over the
    real ones: a pool of four on one card.  Given a ``mesh``, the pool is
    this rank's device of it, since a rank owns one device of the mesh
    (the reference, one process over all its devices, returns them
    all)."""
    if mesh is not None:
        from ..core.backends.sharded import mesh_device

        return (mesh_device(mesh),)
    if device_type == "cuda":
        resolve_device("cuda")  # raises without a card
        real = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif device_type == "cpu":
        real = [torch.device("cpu")]
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    n = len(real) if n is None else int(n)
    if logical:
        return tuple(LogicalDevice(i, real[i % len(real)]) for i in range(n))
    if n > len(real):
        raise ValueError(
            f"device_pool({n}): only {len(real)} {device_type} device(s) exist -- "
            f"pass logical=True for {n} logical devices that share them"
        )
    return tuple(real[:n])
