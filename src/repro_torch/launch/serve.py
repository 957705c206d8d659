"""Serving driver: batched greedy decoding with a continuous slot pool
(port of ``src/repro/launch/serve.py``).

Requests enter a fixed-size batch of decode slots; a finished sequence
frees its slot for the next queued request (continuous batching).  Every
step, prefill included, is the same decode step on the whole batch, so on
a CUDA device each step launches the hand-written norm kernel
(``rmsnorm``, or ``layernorm`` for granite's ``norm="ln"``) and
``flash_decode``:

- dense (qwen, granite), MoE (deepseek-moe, granite-moe) and VLM (llava)
  models: the norm 2 x n_layers + 1 times and flash_decode n_layers
  times (the MoE router's top-k and the expert products are plain torch,
  as in the reference);
- an SSM model (mamba2): the norm 2 x n_layers + 1 times (its recurrent
  step has no kernel of its own);
- a hybrid model (zamba2): the norm 2 x n_layers + 2 x A + 1 times and
  flash_decode A times, A the shared block's applications;
- an encoder-decoder model (seamless): ``layernorm`` 3 x n_layers + 1
  times and flash_decode 2 x n_layers times, over each layer's self cache
  and over its cross memory of ``ENC_LEN_DECODE`` rows (``specs.py``).

As in the reference, a reused slot's SSM state and a hybrid slot's K/V
ring are not reset: the next request starts from the previous one's
(ROADMAP C); the VLM family serves text only (the reference's server
takes no frontend embeddings); and the encoder-decoder family's server
never runs the encoder: its cross memory is the cache's zero
initialisation, so every token cross-attends to zeros (ROADMAP C.3).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --batch 4 --ctx 512 --requests 4 --tokens 16

The server runs on the CUDA card unless it is given ``device="cpu"``
(``--device cpu``), and raises where there is no card.  The reference's
per-request postprocess kernels on cox streams (``postproc``), the
captured token pipeline (``graph``), the fault drill (``chaos``) and
``--autotune`` ride the runtime services, which are not ported yet
(ROADMAP A.9): they raise ``CoxUnsupported``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs import registry
from ..configs.base import ModelConfig, ShapeConfig
from ..core.runtime import resolve_device
from ..core.types import CoxUnsupported
from ..models.params import init_params
from ..parallel import steps as steps_mod
from . import specs as S


def _unported(what: str) -> CoxUnsupported:
    return CoxUnsupported(
        f"{what} is not ported to repro_torch yet: ROADMAP queue item A.9 "
        "(runtime services: streams, graphs, faults, autotune)"
    )


class BatchedServer:
    """A pool of ``batch`` decode slots over a ``ctx``-long KV cache.

    ``arch`` is a registry name, or a ``ModelConfig`` (a registry config
    with, say, its depth cut).  ``params`` takes weights carried in
    (``models.carry``); without it the weights are drawn from ``seed`` on
    the device.  ``init_s`` is the
    seconds that drawing (or placing) the weights took; ``steps`` counts
    decode steps run (prefill included) and ``step_s`` holds the host-clock
    seconds of each ``decode`` step, each ending when its next tokens
    reach the host."""

    def __init__(
        self,
        arch: Union[str, ModelConfig],
        *,
        batch: int = 4,
        ctx: int = 128,
        seed: int = 0,
        params=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = registry.get(arch) if isinstance(arch, str) else arch
        self.shape = ShapeConfig(f"serve_{ctx}", ctx, batch, "decode")
        self.step_fn, self.specs = steps_mod.make_serve_step(self.cfg)
        t0 = time.perf_counter()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.specs, gen, self.device)
        self.params = params
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_s = time.perf_counter() - t0
        self.batch = batch
        self.ctx = ctx
        self.steps = 0
        self.step_s: List[float] = []
        self.reset()

    def reset(self):
        self.cache = init_params(S.cache_spec_tree(self.cfg, self.shape), None, self.device)
        self.pos = np.zeros((self.batch,), np.int32)
        self.tokens = np.zeros((self.batch,), np.int32)
        self.active = np.zeros((self.batch,), bool)
        self.outputs: List[List[int]] = [[] for _ in range(self.batch)]

    def _run(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int32)).to(self.device)
        p = torch.from_numpy(np.ascontiguousarray(pos, np.int32)).to(self.device)
        nxt, self.cache = self.step_fn(self.params, self.cache, toks, p)
        self.steps += 1
        return nxt

    def prefill_prompt(self, slot: int, prompt: List[int]):
        """Feed a prompt through the decode path, one step per token.

        Every slot steps: the others with their current (stale) token, and
        the positions of all active slots advance (``mask = active``), as
        in the reference's scanned prefill."""
        self.pos[slot] = 0
        self.outputs[slot] = []
        self.active[slot] = True
        T = len(prompt)
        if T == 0:
            return self
        tok_mat = np.tile(self.tokens.astype(np.int32), (T, 1))
        tok_mat[:, slot] = np.asarray(prompt, np.int32)
        mask = self.active.astype(np.int32)
        pos = self.pos.copy()
        for t in range(T):
            self._run(tok_mat[t], pos)
            pos = pos + mask
        self.pos = pos
        self.tokens[slot] = prompt[-1]
        return self

    def _step_all(self) -> np.ndarray:
        t0 = time.perf_counter()
        nxt = self._run(self.tokens, self.pos).cpu().numpy()
        self.step_s.append(time.perf_counter() - t0)
        for i in range(self.batch):
            if self.active[i]:
                self.pos[i] += 1
        return nxt

    def decode(self, max_tokens: int, eos: Optional[int] = None):
        for _ in range(max_tokens):
            nxt = self._step_all()
            for i in range(self.batch):
                if not self.active[i]:
                    continue
                t = int(nxt[i])
                self.outputs[i].append(t)
                self.tokens[i] = t
                if eos is not None and t == eos:
                    self.active[i] = False
                if self.pos[i] >= self.ctx - 1:
                    self.active[i] = False
            if not self.active.any():
                break
        return self.outputs


def serve_requests(
    arch: Union[str, ModelConfig],
    *,
    batch: int,
    ctx: int,
    n_requests: int,
    max_tokens: int,
    seed: int = 0,
    postproc: bool = False,
    graph: bool = False,
    chaos: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Continuous batching over a queue of synthetic prompt requests (8
    tokens each, drawn from ``seed`` with numpy, as in the reference);
    ``arch`` as :class:`BatchedServer` takes it.

    Returns the reference's counts (``completed``, ``tokens``, ``wall_s``,
    ``tok_per_s``) and the server's ``init_s``, ``steps`` and ``step_s``."""
    if postproc:
        raise _unported("postproc (per-request kernels on cox streams)")
    if graph:
        raise _unported("graph (the captured token pipeline)")
    if chaos:
        raise _unported("chaos (the fault-injection drill)")
    rng = np.random.default_rng(seed)
    server = BatchedServer(arch, batch=batch, ctx=ctx, seed=seed, device=device)
    queue = [list(rng.integers(1, server.cfg.vocab, size=8)) for _ in range(n_requests)]
    done: List[List[int]] = []
    t0 = time.time()
    while queue or server.active.any():
        for slot in range(batch):
            if not server.active[slot] and queue:
                server.prefill_prompt(slot, queue.pop(0))
        server.decode(max_tokens)
        for slot in range(batch):
            if not server.active[slot] and server.outputs[slot]:
                done.append(server.outputs[slot])
                server.outputs[slot] = []
    dt = time.time() - t0
    total_tokens = sum(len(o) for o in done)
    return {
        "completed": len(done),
        "tokens": total_tokens,
        "wall_s": dt,
        "tok_per_s": total_tokens / max(dt, 1e-9),
        "init_s": server.init_s,
        "steps": server.steps,
        "step_s": list(server.step_s),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    for flag in ("--postproc", "--graph", "--chaos", "--autotune"):
        ap.add_argument(flag, action="store_true", help="not ported yet (ROADMAP A.9)")
    args = ap.parse_args(argv)
    if args.autotune:
        raise _unported("--autotune")
    out = serve_requests(
        args.arch,
        batch=args.batch,
        ctx=args.ctx,
        n_requests=args.requests,
        max_tokens=args.tokens,
        postproc=args.postproc,
        graph=args.graph,
        chaos=args.chaos,
        device=args.device,
    )
    print(
        f"served {out['completed']} requests, {out['tokens']} tokens, "
        f"{out['tok_per_s']:.1f} tok/s on {args.device or 'cuda'}"
    )


if __name__ == "__main__":
    main()
