"""AdamW's least bytes a step at the reference's numerics
(``reference/adamw.py``), for the optimizer's roofline.

Each parameter's gradient is read twice (once for the global norm, once
for the update), the parameter read and written, and both float32 moments
read and written: ``4 * itemsize + 16`` bytes a parameter, 24 for a
bfloat16 one.  The gradient is held in the parameter's dtype, as the
program's backward returns it."""

from __future__ import annotations

import math

from ..reference.layout import layout, leaves


def adamw_bytes(config: dict) -> int:
    """Bytes an AdamW step moves at the least, over every leaf of
    ``config``'s parameter layout."""
    total = 0
    for _, leaf in leaves(layout(config)):
        itemsize = leaf.dtype.itemsize
        total += math.prod(leaf.shape) * (2 * itemsize + 2 * itemsize + 2 * 2 * 4)
    return total
