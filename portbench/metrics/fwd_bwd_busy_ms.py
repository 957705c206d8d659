"""Device-busy ms a traced step under the benchmark's span around
``steps.loss_and_grads`` (the forward and the backward)."""

from portbench.arith.trace import SPAN_PREFIX


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 1e3 * run.per_traced_step(run.trace.busy_in_spans_s(SPAN_PREFIX + "fwd_bwd"))
