"""The 90th percentile of the window's step times (host clock, each
ending at its loss read), in ms."""

import statistics


def read(run):
    if len(run.step_s) < 2:
        return None
    return statistics.quantiles(run.step_s, n=10)[8] * 1e3
