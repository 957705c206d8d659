"""The program under test, ``repro_torch`` (``src/`` of the checkout), as
the benchmark drives it; the one module of the harness that imports it.

From the program the benchmark takes its train step (``make_train_step``
and the two parts it composes, ``loss_and_grads`` and ``adamw.update``),
its kernel build and its launch counters; the weights and the batches are
the benchmark's.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _import():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import build, ops
    from repro_torch.optim import adamw
    from repro_torch.parallel import steps

    return ModelConfig, build, ops, adamw, steps


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: each key of
    the file that names one of its fields, the dtype by its name."""
    ModelConfig = _import()[0]
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"param_dtype"}
    kw = {k: v for k, v in cfg.items() if k in fields}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["param_dtype"]]
    return ModelConfig(param_dtype=dtype, **kw)


def adamw_config(cfg: dict):
    return _import()[3].AdamWConfig(**cfg["adamw"])


def check_layout(mcfg, tree) -> None:
    """Raise unless the program's parameter layout is the benchmark's
    (``reference.layout``): the same leaves, shapes and dtypes."""
    specs = _import()[4].model_specs(mcfg)

    def walk(spec, ours, path=""):
        if isinstance(ours, dict):
            if not isinstance(spec, dict) or set(spec) != set(ours):
                raise ValueError(f"layout at {path or 'root'}: program {sorted(spec)} vs {sorted(ours)}")
            for k in ours:
                walk(spec[k], ours[k], f"{path}.{k}" if path else k)
            return
        if tuple(spec.shape) != tuple(ours.shape) or spec.dtype != ours.dtype:
            raise ValueError(f"layout of {path}: program {spec.shape} {spec.dtype}, ours {ours.shape} {ours.dtype}")

    walk(specs, tree)


def build_kernels() -> dict:
    """Build (or load from ``build/repro_torch/`` in the checkout) every
    CUDA library of the program, all ``nvcc`` runs at once."""
    return _import()[1].build_all()


def launch_counts() -> dict:
    return _import()[2].launch_counts()


@dataclasses.dataclass
class TrainStep:
    """The program's one-device train step and its two parts."""

    mcfg: object
    opt_cfg: object
    step: object  # make_train_step's step(params, opt, batch), or a faulty one

    def init_opt(self, params):
        return _import()[3].init_state(params, self.opt_cfg)

    def loss_and_grads(self, params, batch):
        return _import()[4].loss_and_grads(self.mcfg, params, batch)

    def update(self, grads, opt, params):
        return _import()[3].update(grads, opt, params, self.opt_cfg)


def train_step(cfg: dict, fault: str = "") -> TrainStep:
    """``make_train_step(cfg, opt_cfg)``'s step, as ``launch/train.py``
    runs it on one device.  ``fault`` plants a fault under it, for the
    benchmark's own tests and readings (never in a benchmark run):
    ``"frozen"`` (the step returns its state unchanged), ``"half_batch"``
    (the second half of the batch left out, the mean over the rest) or
    ``"grad_doubled"`` (the gradient of the last leaf, in sorted order,
    doubled where it is produced: the MLP's output projection in both
    families) or ``"update_doubled"`` (the step's answer altered where it
    is produced: that leaf moved twice as far as its update)."""
    _, _, _, adamw, steps = _import()
    mcfg, opt_cfg = model_config(cfg), adamw_config(cfg)
    step, _ = steps.make_train_step(mcfg, opt_cfg)
    if fault == "frozen":

        def step(params, opt, batch):  # noqa: F811
            loss, grads = steps.loss_and_grads(mcfg, params, batch)
            return params, opt, {"loss": loss, "grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    elif fault == "half_batch":
        whole = step

        def step(params, opt, batch):  # noqa: F811
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return whole(params, opt, half)

    elif fault == "grad_doubled":

        def step(params, opt, batch):  # noqa: F811
            loss, grads = steps.loss_and_grads(mcfg, params, batch)
            grads = _double_last(grads)
            params, opt, metrics = adamw.update(grads, opt, params, opt_cfg)
            return params, opt, dict(metrics, loss=loss)

    elif fault == "update_doubled":
        whole = step

        def step(params, opt, batch):  # noqa: F811
            leaf = _last(params)
            before = leaf.detach().clone()
            params, opt, metrics = whole(params, opt, batch)
            leaf.copy_((2 * leaf.float() - before.float()).to(leaf.dtype))
            return params, opt, metrics

    elif fault:
        raise ValueError(f"unknown fault {fault!r}")
    return TrainStep(mcfg, opt_cfg, step)


def _last(tree):
    return _last(tree[sorted(tree)[-1]]) if isinstance(tree, dict) else tree


def _double_last(tree):
    if isinstance(tree, dict):
        k = sorted(tree)[-1]
        return {**tree, k: _double_last(tree[k])}
    return tree * 2
