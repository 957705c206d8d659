"""Device ms a traced step of the program's ``model.block`` spans that
the backward runs again under remat (``recompute=True``), on the
program's own CUDA events (``program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.per_step(run, "model.block", recompute=True)
