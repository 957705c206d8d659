"""The attention kernels' share of their roofline, in %: the least time of
every call in the traced steps (``arith.flops.attention_bound_s``: the
operations over the visible causal pairs at 989 TFLOP/s, or the bytes of
q, k, v read once and the outputs written once at 3.35 TB/s, whichever
is longer), over the device time of the attention kernels.  The calls
are the program's own counts (``ops.launch_counts``); every call of a
cell has the configuration's shape."""

from portbench.arith.flops import attention_bound_s, full
from portbench.arith.trace import ATTENTION


def read(run):
    if run.trace is None:
        return None
    n_fwd = run.traced_launches.get("flash_attention", 0)
    n_bwd = run.traced_launches.get("flash_attention_bwd", 0)
    spent = run.trace.kind_s().get(ATTENTION, 0.0)
    if not (n_fwd or n_bwd) or spent <= 0:
        return None
    c = full(run.config)
    fwd, bwd = attention_bound_s(
        run.mix["batch"], run.mix["seq"], c["n_heads"], c["n_kv"], c["d_head"], True, c["window"]
    )
    return 100 * (n_fwd * fwd + n_bwd * bwd) / spent
