"""The comparison that decides ``correct`` for a training cell.

Both sides start from the same drawn weights and take the same first
batches.  From each side come the losses of its first steps, the norm of
each leaf's gradient at the first step as the optimizer gets it, and the
norm of each leaf's change over the compared steps.  Three numbers, each
held to a limit of its cell:

- ``loss``: the largest relative gap of a step's loss.
- ``grad``: by the worst leaf, the gap between the two sides' gradient
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger.
- ``change``: the same, of the parameters' change over the compared
  steps; leaves whose reference gradient is under a thousandth of the
  median leaf's move by round-off alone and are left out.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

NUMBERS = ("loss", "grad", "change")
QUIET_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median's


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], paths) -> tuple:
    med = statistics.median(want[p] for p in paths)
    worst, leaf = 0.0, ""
    for p in paths:
        gap = abs(got[p] - want[p]) / max(want[p], med, 1e-30)
        if not math.isfinite(got[p]):
            gap = math.inf
        if gap >= worst:
            worst, leaf = gap, p
    return worst, leaf


def numbers(side: Readings, ref: Readings) -> Dict[str, dict]:
    """``{name: {"value": number, "where": what it was read at}}``."""
    loss, at = 0.0, 0
    for i, (a, b) in enumerate(zip(side.losses, ref.losses)):
        gap = abs(a - b) / abs(b) if math.isfinite(a) else math.inf
        if gap >= loss:
            loss, at = gap, i + 1
    paths = sorted(ref.grad_norms)
    grad, g_leaf = _worst_leaf(side.grad_norms, ref.grad_norms, paths)
    med = statistics.median(ref.grad_norms.values())
    moving = [p for p in paths if ref.grad_norms[p] >= QUIET_LEAF * med]
    change, c_leaf = _worst_leaf(side.change_norms, ref.change_norms, moving)
    return {
        "loss": {"value": loss, "where": f"step {at}"},
        "grad": {"value": grad, "where": g_leaf},
        "change": {"value": change, "where": c_leaf},
    }


def judge(nums: Dict[str, dict], limits: Dict[str, float]) -> tuple:
    """``(correct, checks)``: every number at or under its limit (a number
    without a limit is not correct); ``checks`` maps each number to its
    value and limit."""
    checks, ok = {}, True
    for name in NUMBERS:
        value = nums[name]["value"]
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit, "where": nums[name]["where"]}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
