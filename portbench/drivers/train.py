"""The training driver: one object, the program's train step with its
weights and optimizer state, driven from the seed.

1. Set-up: build the kernels, draw the weights, and run the first
   ``check_steps`` steps through the window's own call and feed; their
   losses, the first gradient (from the moments after step 1) and the
   parameters' change are the program's readings.  These steps also warm
   up every shape the window uses.
2. The window: steps until ``seconds`` have passed, each ending when its
   loss reaches the host, as ``launch/train.py``'s loop runs them.
3. Traced runs only: ``trace_steps`` more steps under ``torch.profiler``,
   each split into the two parts ``make_train_step`` composes
   (``loss_and_grads``, then ``adamw.update``), in spans of the benchmark
   with a synchronisation at the end of each part.
4. The program's state freed, the reference trains from the same weights
   on the same batches, and the comparison decides ``correct``.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from .. import compare, program, weights
from ..arith.flops import train_model_flops
from ..arith.trace import SPAN_PREFIX, STEP_SPAN, Trace
from ..record import Record
from ..reference import train as reference
from ..reference.layout import get, layout, leaves
from ..generator import TrainBatches

CHECK_STEPS = 3


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def program_readings(prog: "Program") -> compare.Readings:
    """The program's compared first steps, run through the window's call
    and feed: their losses, the first gradient by leaf (from the moments
    after step 1, which hold (1 - b1) times the clipped gradient) and
    each leaf's change."""
    paths = [p for p, _ in leaves(layout(prog.config))]
    opt_cfg, state = prog.step.opt_cfg, prog.state
    losses, grad_norms = [], {}
    for i in range(CHECK_STEPS):
        loss, metrics = prog.one(i)
        losses.append(loss)
        if i == 0:
            gnorm = float(metrics["grad_norm"])
            scale = min(opt_cfg.clip_norm / max(gnorm, 1e-12), 1.0) if opt_cfg.clip_norm else 1.0
            grad_norms = {p: _norm(get(state["opt"]["m"], p)) / (1 - opt_cfg.b1) / scale for p in paths}
    change = {}
    for p in paths:
        start = weights.draw(prog.config, prog.seed, p, prog.dev)
        change[p] = _norm(get(state["params"], p).float() - start.float())
        del start
    return compare.Readings(losses, grad_norms, change)


def reference_readings(config: dict, seed: int, dev, batch_at, precision: str = "f32") -> compare.Readings:
    """The reference's readings from the same weights and batches."""
    batches = [(b["tokens"], b["labels"]) for b in map(batch_at, range(CHECK_STEPS))]
    with reference.TF32Off():
        out = reference.run(config, config["adamw"], lambda p: weights.draw(config, seed, p, dev), batches, precision)
    return compare.Readings(*out)


class Program:
    """The program's train step with its weights and optimizer state,
    drawn from the seed; ``one(i)`` runs step i on batch i."""

    def __init__(self, config: dict, mix: dict, seed: int, dev, fault: str = ""):
        self.step = program.train_step(config, fault)
        program.check_layout(self.step.mcfg, layout(config))
        self.feed = TrainBatches(mix, config["vocab"], seed)
        self.config, self.seed, self.dev = config, seed, dev
        params = weights.make(config, seed, dev)
        self.state = {"params": params, "opt": self.step.init_opt(params)}

    def batch_at(self, i: int) -> dict:
        tokens, labels = self.feed.batch(i)
        return {"tokens": torch.from_numpy(tokens).to(self.dev), "labels": torch.from_numpy(labels).to(self.dev)}

    def one(self, i: int):
        st = self.state
        st["params"], st["opt"], metrics = self.step.step(st["params"], st["opt"], self.batch_at(i))
        return float(metrics["loss"]), metrics

    def free(self) -> None:
        self.state.clear()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(cell, config, mix, *, seed, seconds, trace, device, t0, fault="") -> Record:
    dev = torch.device(device)
    if dev.type == "cuda":
        program.build_kernels()
    prog = Program(config, mix, seed, dev, fault)
    # set-up: the compared steps, which also warm up every shape
    side = program_readings(prog)

    # the window
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    step_s, losses, i = [], [], CHECK_STEPS
    tw = time.perf_counter()
    while True:
        ts = time.perf_counter()
        losses.append(prog.one(i)[0])
        step_s.append(time.perf_counter() - ts)
        i += 1
        if time.perf_counter() - tw >= seconds:
            break
    window_s = time.perf_counter() - tw
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tr, traced_launches = None, {}
    if trace:
        tr, traced_launches, traced_losses = _traced(prog, i, int(cell["trace_steps"]))
        losses += traced_losses
    prog.free()

    ref = reference_readings(config, seed, dev, prog.batch_at)
    correct, checks = compare.judge(compare.numbers(side, ref), cell["limits"])
    failed = sum(1 for x in losses if not math.isfinite(x))
    return Record(
        cell=cell,
        config=config,
        mix=mix,
        setup_s=setup_s,
        window_s=window_s,
        step_s=step_s,
        tokens_per_step=prog.feed.tokens_per_step,
        flops_per_step=train_model_flops(config, prog.feed.B, prog.feed.S),
        peak_bytes=peak,
        attempted=len(losses),
        failed=failed,
        correct=correct and failed == 0,
        checks=checks,
        trace=tr,
        traced_launches=traced_launches,
    )


def _traced(prog: Program, i0: int, n: int):
    """``n`` steps under the profiler, split into their two parts."""
    step, state, dev = prog.step, prog.state, prog.dev
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    before = program.launch_counts()
    losses = []
    with profile(activities=acts) as prof:
        for i in range(i0, i0 + n):
            with record_function(STEP_SPAN):
                with record_function(SPAN_PREFIX + "feed"):
                    batch = prog.batch_at(i)
                with record_function(SPAN_PREFIX + "fwd_bwd"):
                    loss, grads = step.loss_and_grads(state["params"], batch)
                    _sync(dev)
                with record_function(SPAN_PREFIX + "adamw"):
                    state["params"], state["opt"], _ = step.update(grads, state["opt"], state["params"])
                    _sync(dev)
                with record_function(SPAN_PREFIX + "loss_read"):
                    losses.append(float(loss))
                del grads, batch
    after = program.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return Trace.from_profile(prof), launches, losses
