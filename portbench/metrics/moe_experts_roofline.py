"""The held experts' products' share of their roofline, in %: for every
``moe.experts`` span of the traced steps (forward and remat recompute),
the least time of its ``rows`` counter's products
(``arith.moe_flops.expert_bound_s``: bf16 operations at 989 TFLOP/s, or
the held experts' weights and the rows at 3.35 TB/s, whichever is
longer), summed, over the spans' device time (``program_spans``).  None
where the spans carry no counter (a program without them)."""

from portbench import program_spans
from portbench.arith.moe_flops import expert_bound_s
from portbench.reference.layout import DTYPES


def read(run):
    found = program_spans.steps(run)
    if not found:
        return None
    spans = [s for step in found for s in step if s["name"] == "moe.experts"]
    if not spans or any("rows" not in s.get("counters", {}) for s in spans):
        return None
    c = run.config
    size = DTYPES[c["param_dtype"]].itemsize
    bound = sum(expert_bound_s(s["counters"]["rows"], c["experts_held"], c["d_model"], c["d_expert"], size) for s in spans)
    spent = sum(s["device_ms"] for s in spans) / 1e3
    return 100 * bound / spent if spent > 0 else None
