"""Device ms a traced step of the forward and backward's operations that
are neither GEMMs nor the program's own kernels (``arith.trace.kernel_kind``'s
"other": the model stack's elementwise work, reductions, copies and the
cross-entropy; AdamW's, under its own span, is not counted)."""

from portbench.arith.trace import OTHER, SPAN_PREFIX


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 1e3 * run.per_traced_step(run.trace.kind_s(SPAN_PREFIX + "fwd_bwd").get(OTHER, 0.0))
