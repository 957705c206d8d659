"""The traced window's share in which no operation ran on the device, in
%: 1 - busy / window, from the profiler's device timeline."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100 * (1 - run.trace.busy_s() / run.trace.window_s())
