"""Seconds from the start of the process to the window's first step:
imports, the kernel build (or its load from the checkout's cache), the
weights and the compared first steps, which warm up every shape."""


def read(run):
    return run.setup_s
