"""The SSD scan kernels' share of their roofline, in %: the least time of
every call in the traced steps (``arith.flops.ssd_bound_s``: the f32
products as 3xTF32 at 495 TFLOP/s and the rest at 67, or the bytes at
3.35 TB/s, whichever is longer), over the device time of the SSD
kernels.  The calls are the program's own counts (``ops.launch_counts``)."""

from portbench.arith.flops import full, ssd_bound_s
from portbench.arith.trace import SSD


def read(run):
    if run.trace is None:
        return None
    n_fwd = run.traced_launches.get("ssd_scan", 0)
    n_bwd = run.traced_launches.get("ssd_scan_bwd", 0)
    spent = run.trace.kind_s().get(SSD, 0.0)
    if not (n_fwd or n_bwd) or spent <= 0:
        return None
    c = full(run.config)
    fwd, bwd = ssd_bound_s(run.mix["batch"], run.mix["seq"], c["ssm_heads"], c["ssm_head_dim"], c["ssm_state"])
    return 100 * (n_fwd * fwd + n_bwd * bwd) / spent
