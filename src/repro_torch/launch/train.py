"""The trainer: the AdamW train loop on one card, with the straggler
watchdog and failure injection (port of ``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b-smoke \\
        --steps 3 --batch 2 --seq 128 --device cpu

Training runs on the CUDA card unless it is given ``device="cpu"``
(``--device cpu``), and raises where there is no card.  On a card every
step of a dense, MoE or VLM model launches the hand-written
``flash_attention`` and norm kernels (``rmsnorm``, or ``layernorm`` for
granite's ``norm="ln"``) and their backward kernels; every step of an
SSM model (mamba2) the ``ssd_scan`` and ``rmsnorm`` kernels and theirs;
every step of a hybrid model (zamba2) all six: ``ssd_scan``,
``flash_attention`` and ``rmsnorm`` and their backwards.  A VLM batch
carries its ``frontend`` embeddings (``data/pipeline.py``).  Checkpointing and
restart (``ckpt_dir=``, ``retry_loop``) need ``checkpoint/ckpt.py``, which is not ported yet
(ROADMAP A.8): ``ckpt_dir=`` raises ``CoxUnsupported``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Union

import torch

from ..configs import registry
from ..configs.base import ModelConfig, ShapeConfig
from ..core.runtime import resolve_device
from ..core.types import CoxUnsupported
from ..data.pipeline import DataConfig, TokenSource
from ..ft.watchdog import FailureInjector, StepWatchdog
from ..models.params import init_params
from ..optim import adamw
from ..parallel import steps as steps_mod


def train(
    arch: Union[str, ModelConfig],
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    ckpt_dir: Optional[str] = None,
    data_cfg: Optional[DataConfig] = None,
    seed: int = 0,
    log_every: int = 10,
    injector: Optional[FailureInjector] = None,
    deadline_s: float = 300.0,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    device=None,
) -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps of ``batch`` sequences of ``seq``
    tokens from the deterministic token source; weights are drawn from
    ``seed`` on the device with a ``torch.Generator``.

    ``arch`` is a registry name, or a ``ModelConfig`` (a registry config
    with, say, its depth cut).  Returns the reference's ``final_step``,
    ``losses`` and ``params``, and ``grad_norms``, ``step_s`` (host-clock
    seconds of each step, ending when its loss reaches the host) and
    ``init_s`` (seconds to draw the weights and the optimizer state)."""
    if ckpt_dir is not None:
        raise CoxUnsupported(
            "ckpt_dir= is not ported to repro_torch yet: ROADMAP queue item A.8 "
            "(checkpoint/ckpt.py and the resume drills)"
        )
    device = resolve_device(device)
    cfg = registry.get(arch) if isinstance(arch, str) else arch
    shape = ShapeConfig(f"train_{seq}", seq, batch, "train")
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps)
    step_fn, specs = steps_mod.make_train_step(cfg, opt_cfg)
    source = TokenSource(cfg, shape, data_cfg or DataConfig(seed=seed))

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(specs, gen, device)
    opt = adamw.init_state(params, opt_cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0

    losses: list = []
    grad_norms: list = []
    step_s: list = []
    wd = StepWatchdog(deadline_s)
    for step in range(steps):
        if injector is not None:
            injector.maybe_fail(step)
        batch_dev = {
            k: torch.from_numpy(v).to(device) for k, v in source.batch_at(step).items()
        }
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
    return {
        "final_step": steps - 1,
        "losses": losses,
        "params": params,
        "grad_norms": grad_norms,
        "step_s": step_s,
        "init_s": init_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        seed=args.seed,
        device=args.device,
    )
    print(
        f"done: final_step={out['final_step']} "
        f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}"
    )


if __name__ == "__main__":
    main()
