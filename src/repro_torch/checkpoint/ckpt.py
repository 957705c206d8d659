"""Checkpointing with atomic commit and async save (port of
``src/repro/checkpoint/ckpt.py``).

Layout (one directory per step), the reference's:

    <dir>/step_000100.tmp/...      while writing
    <dir>/step_000100/manifest.json
    <dir>/step_000100/<leaf-path>.npy
    <dir>/LATEST                   atomic pointer file

A leaf's file name is its path of dict keys joined by ``"__"``; the
manifest records each leaf's dtype name and shape; bf16 is stored as a
``uint16`` view with the dtype ``"bfloat16"`` (npy has no bf16).  So a
directory written by either package restores in the other.

* commit is atomic: write to ``.tmp``, fsync the manifest, rename, then
  swap ``LATEST`` -- a crash mid-save never corrupts the restore point;
* ``save`` snapshots every leaf into an owned host copy before it
  returns (the trainer updates its tensors in place), then writes on a
  background thread unless ``blocking`` (``wait()`` joins);
* every leaf is checked on load against its manifest shape and against
  the shape and dtype of ``like``.

On a mesh a tree's DTensor leaves are saved in the logical, unsharded
layout (each leaf's ``full_tensor()``, a collective every rank joins): rank
0 writes, synchronously, and every rank waits at a barrier.  ``restore``
takes ``shardings`` for elastic re-placement, as the reference's does: a
tree of ``spmd.Sharding`` (None for a plain leaf) onto which every rank
places its slices of the full arrays, on any mesh whatever the mesh that
saved them.  ``log`` records each save's and restore's bytes and
seconds.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.runtime import resolve_device


def _leaf_path(path: Tuple) -> str:
    return "__".join(str(p) for p in path) or "root"


def _flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs of nested dicts, keys in sorted order (as
    ``jax.tree_util`` orders a dict's)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _rebuild(like, vals: dict, path: Tuple = ()) -> Any:
    """The tree of ``like``'s structure with ``vals[path]`` at each leaf."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], vals, path + (k,)) for k in like}
    return vals[path]


def _is_dt(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """An owned host copy of ``x`` and its dtype's name; bf16 as its
    ``uint16`` bits."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.log: List[dict] = []

    # ----------------------------- save -----------------------------

    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot (an owned host copy of every leaf) then write; async
        unless blocking.  ``tree`` may be changed as soon as this
        returns."""
        t0 = time.perf_counter()
        pairs = _flatten(tree)
        if any(_is_dt(x) for _, x in pairs):
            import torch.distributed as dist

            # every rank joins each leaf's gather; rank 0 alone keeps a copy
            rank0 = dist.get_rank() == 0
            snap = []
            for p, x in pairs:
                full = x.full_tensor() if _is_dt(x) else x
                if rank0:
                    snap.append((_leaf_path(p), _to_numpy(full)))
                del full
            self.wait()
            if rank0:
                self._write(step, snap, {"op": "save", "step": step})
            dist.barrier()
            blocking = None
        else:
            snap = [(_leaf_path(p), _to_numpy(x)) for p, x in pairs]
        rec = {
            "op": "save",
            "step": step,
            "bytes": sum(a.nbytes for _, (a, _) in snap),
            "snapshot_s": time.perf_counter() - t0,
        }
        self.wait()
        self.log.append(rec)
        if blocking is None:  # written above, on rank 0
            rec["write_s"] = time.perf_counter() - t0 - rec["snapshot_s"]
        elif blocking:
            self._write(step, snap, rec)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, snap, rec), daemon=True
            )
            self._thread.start()

    def _write(self, step: int, snap, rec: dict):
        t0 = time.perf_counter()
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for key, (arr, dtype) in snap:
            np.save(os.path.join(tmp, key + ".npy"), arr)
            manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        rec["write_s"] = time.perf_counter() - t0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.dir) if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ----------------------------- load -----------------------------

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, step: int, like: Any, device=None, shardings=None) -> Any:
        """Restore into the structure of ``like``, nested dicts whose leaves
        have a ``shape`` and a ``dtype`` (tensors or ``ParamSpec``), on
        ``device`` (the card unless told otherwise).  With ``shardings`` (a
        tree like ``like`` of ``spmd.Sharding``, None for a plain leaf)
        every leaf is placed as a DTensor on its mesh, on this rank's
        device of the mesh."""
        if shardings is not None:
            from ..models.params import shard_full
            from ..parallel.spmd import mesh_device

            meshes = [s.mesh for _, s in _flatten(shardings) if s is not None]
            device = mesh_device(meshes[0]) if meshes else device
            sh = dict(_flatten(shardings))
        device = resolve_device(device)
        t0 = time.perf_counter()
        name = f"step_{step:08d}"
        base = os.path.join(self.dir, name)
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        vals, nbytes = {}, 0
        for path, x in _flatten(like):
            key = _leaf_path(path)
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {name} is missing leaf {key}")
            arr = np.load(os.path.join(base, key + ".npy"))
            if list(arr.shape) != list(meta["shape"]):
                raise ValueError(f"corrupt leaf {key}: {arr.shape} vs {meta['shape']}")
            val = _from_numpy(arr, meta["dtype"])
            if tuple(val.shape) != tuple(x.shape):
                raise ValueError(
                    f"leaf {key}: checkpoint {tuple(val.shape)} vs model "
                    f"{tuple(x.shape)} (arch mismatch)"
                )
            if val.dtype != x.dtype:
                raise ValueError(
                    f"leaf {key}: checkpoint {meta['dtype']} vs model "
                    f"{str(x.dtype).removeprefix('torch.')}"
                )
            nbytes += arr.nbytes
            val = val.to(device)
            if shardings is not None and sh.get(path) is not None:
                val = shard_full(val, sh[path].mesh, sh[path].placements)
            vals[path] = val
        self.log.append(
            {"op": "restore", "step": step, "bytes": nbytes, "s": time.perf_counter() - t0}
        )
        return _rebuild(like, vals)
