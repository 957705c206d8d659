"""The trainer: the AdamW train loop on one card, with checkpoint and
restart, the straggler watchdog and failure injection (port of
``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b-smoke \\
        --steps 3 --batch 2 --seq 128 --device cpu [--ckpt-dir DIR --ckpt-every 25]

Training runs on the CUDA card unless it is given ``device="cpu"``
(``--device cpu``), and raises where there is no card.  On a card every
step of a dense, MoE or VLM model launches the hand-written
``flash_attention`` and norm kernels (``rmsnorm``, or ``layernorm`` for
granite's ``norm="ln"``) and their backward kernels; every step of an
SSM model (mamba2) the ``ssd_scan`` and ``rmsnorm`` kernels and theirs;
every step of a hybrid model (zamba2) all six: ``ssd_scan``,
``flash_attention`` and ``rmsnorm`` and their backwards; every step of an
encoder-decoder model (seamless) ``flash_attention`` non-causal in the
encoder and the cross-attention and causal in the decoder, and
``layernorm``, and their backwards.  Every step on a card updates the
parameters with AdamW's ``adamw_sumsq`` and ``adamw_apply`` kernels, one
launch of each a (parameter dtype, gradient dtype) group; on a mesh
(DTensor leaves) AdamW is eager.  A VLM or encoder-decoder batch
carries its ``frontend`` embeddings (``data/pipeline.py``).  With
``ckpt_dir=`` the parameters and the optimizer state go to
``checkpoint/ckpt.py``'s ``CheckpointManager``, and ``retry_loop``
restarts a failed run from the latest checkpoint.

With ``mesh=`` (a ``DeviceMesh`` over "data" and "model", every rank
calling ``train`` alike) the run is the reference's sharded trainer:
parameters, ZeRO-1 moments and batches are DTensors at the placements of
``strategy`` (``"tp"`` or ``"fsdp"``), every rank builds the same global
batch and keeps its slice, and a restart restores the latest checkpoint
onto the mesh's shardings.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Union

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..configs import registry
from ..configs.base import ModelConfig, ShapeConfig
from ..core.runtime import resolve_device
from ..data.pipeline import DataConfig, TokenSource
from ..ft.watchdog import FailureInjector, StepWatchdog, retry_loop
from ..models import carry
from ..models.params import init_params, shard_full, tree_map
from ..optim import adamw
from ..parallel import steps as steps_mod


def place_batch(batch, shardings, device):
    """A batch of ``TokenSource.batch_at`` on ``device``: plain tensors, or,
    given each leaf's ``spmd.Sharding``, DTensors of which every rank keeps
    its slice (every rank builds the same global batch from the seed;
    nothing is scattered from one rank)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v).to(device)
        if shardings is not None:
            t = shard_full(t, shardings[k].mesh, shardings[k].placements)
        out[k] = t
    return out


def train(
    arch: Union[str, ModelConfig],
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 25,
    data_cfg: Optional[DataConfig] = None,
    seed: int = 0,
    log_every: int = 10,
    injector: Optional[FailureInjector] = None,
    deadline_s: float = 300.0,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    params=None,
    device=None,
    mesh=None,
    strategy: str = "tp",
) -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps of ``batch`` sequences of ``seq``
    tokens from the deterministic token source; weights are drawn from
    ``seed`` on the device with a ``torch.Generator``, or start from
    ``params`` (weights carried in, as ``BatchedServer`` takes them; each
    run starts from a copy, so the caller's tensors are not changed).

    ``arch`` is a registry name, or a ``ModelConfig`` (a registry config
    with, say, its depth cut).  With ``ckpt_dir`` the parameters and the
    optimizer state are saved every ``ckpt_every`` steps and at the end,
    and a failure restarts from the latest checkpoint (``retry_loop``);
    the losses of replayed steps are appended again, as in the reference.
    Returns the reference's ``final_step``, ``losses`` and ``params``, and
    ``opt`` (the optimizer state), ``grad_norms``, ``step_s`` (host-clock
    seconds of each step, ending when its loss reaches the host),
    ``init_s`` (seconds to draw the weights and the optimizer state the
    first time) and ``ckpt_log`` (each save's and restore's bytes and
    seconds)."""
    cfg = registry.get(arch) if isinstance(arch, str) else arch
    shape = ShapeConfig(f"train_{seq}", seq, batch, "train")
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps)
    rules = bundle = None
    if mesh is None:
        device = resolve_device(device)
        step_fn, specs = steps_mod.make_train_step(cfg, opt_cfg)
    else:
        from ..parallel.spmd import mesh_device

        device = mesh_device(mesh)
        step_fn, bundle, _ = steps_mod.jit_train_step(cfg, mesh, shape, opt_cfg, strategy=strategy)
        cfg, specs, rules = bundle["cfg"], bundle["specs"], bundle["rules"]
    source = TokenSource(cfg, shape, data_cfg or DataConfig(seed=seed))
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    losses: list = []
    grad_norms: list = []
    step_s: list = []
    state: Dict[str, Any] = {}

    def init_state():
        t0 = time.perf_counter()
        if params is None:  # train()'s argument: draw the weights from the seed
            gen = torch.Generator(device=device).manual_seed(seed)
            weights = init_params(specs, gen, device, rules=rules)
        else:
            weights = tree_map(lambda t: t.to(device, copy=True), params)
            if bundle is not None:
                weights = carry.shard_params(weights, bundle)
        opt = adamw.init_state(weights, opt_cfg, bundle and bundle["opt_sh"]["m"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        state.setdefault("init_s", time.perf_counter() - t0)
        return weights, opt

    def run_from(start_step: int) -> int:
        params = opt = None
        if start_step > 0 and mgr is not None and mgr.latest_step() is not None:
            ck = mgr.latest_step()
            like = {"params": specs, "opt": steps_mod.opt_like(specs, opt_cfg)}
            sh = bundle and {"params": bundle["param_sh"], "opt": bundle["opt_sh"]}
            blob = mgr.restore(ck, like, device, shardings=sh)
            params, opt = blob["params"], blob["opt"]
            start_step = ck + 1
        if params is None:
            params, opt = init_state()
            start_step = 0

        wd = StepWatchdog(deadline_s)
        for step in range(start_step, steps):
            if injector is not None:
                injector.maybe_fail(step)
            batch_dev = place_batch(source.batch_at(step), bundle and bundle["batch_sh"], device)
            wd.start(step)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch_dev)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - t0)
            wd.stop()
            wd.check()
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if step % log_every == 0 or step == steps - 1:
                print(
                    f"[train {cfg.name}] step {step} loss {loss:.4f} "
                    f"gnorm {grad_norms[-1]:.3f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"dt {step_s[-1]:.2f}s",
                    flush=True,
                )
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save(step, {"params": params, "opt": opt})
        if mgr is not None:
            mgr.save(steps - 1, {"params": params, "opt": opt}, blocking=True)
        state["params"], state["opt"] = params, opt
        return steps - 1

    if mgr is not None:
        final = retry_loop(run_from, ckpt_mgr=mgr)
    else:
        final = run_from(0)
    return {
        "final_step": final,
        "losses": losses,
        "params": state.get("params"),
        "opt": state.get("opt"),
        "grad_norms": grad_norms,
        "step_s": step_s,
        "init_s": state.get("init_s"),
        "ckpt_log": mgr.log if mgr is not None else [],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        seed=args.seed,
        device=args.device,
    )
    print(
        f"done: final_step={out['final_step']} "
        f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}"
    )


if __name__ == "__main__":
    main()
