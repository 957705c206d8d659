"""The reference's first training steps, and the readings the comparison
takes from them."""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from . import adamw, model
from .layout import layout, leaves


def nest(flat: dict) -> dict:
    """A nested parameter tree from ``{dotted path: tensor}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *heads, last = path.split(".")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def run(
    cfg: dict,
    opt: dict,
    draw: Callable[[str], torch.Tensor],
    batches: List[Tuple[torch.Tensor, torch.Tensor]],
    precision: str = "f32",
):
    """Train from the drawn weights (``draw(path)`` gives a leaf as the
    benchmark drew it) on ``batches``, one step each, computing in float32
    with TF32 off (``precision="fp8"``: the control) and keeping each
    parameter in the dtype the configuration states.  Returns ``(losses, the
    first step's gradient norm by leaf, each leaf's change over all the
    steps)``."""
    tree = dict(leaves(layout(cfg)))
    paths = list(tree)
    params = {p: draw(p).float().requires_grad_(True) for p in paths}
    m = {p: torch.zeros_like(t) for p, t in params.items()}
    v = {p: torch.zeros_like(t) for p, t in params.items()}
    losses, grad_norms = [], {}
    for step, (tokens, labels) in enumerate(batches, start=1):
        with torch.enable_grad():
            loss = model.loss(cfg, nest(params), tokens, labels, precision)
            grads = dict(zip(paths, torch.autograd.grad(loss, [params[p] for p in paths])))
        losses.append(float(loss.detach()))
        if step == 1:
            grad_norms = {p: float(torch.linalg.vector_norm(g)) for p, g in grads.items()}
        stored = {p: tree[p].dtype for p in paths}
        adamw.update(opt, {p: t.detach() for p, t in params.items()}, grads, m, v, step, stored)
        del grads, loss
    del m, v
    change = {}
    for p in paths:
        change[p] = float(torch.linalg.vector_norm(params[p].detach() - draw(p).float()))
    return losses, grad_norms, change


class TF32Off:
    """Matrix products in full float32 inside the block (TF32 off), the
    settings restored after."""

    def __enter__(self):
        self.saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec = self.saved
        torch.set_float32_matmul_precision(prec)
        return False
