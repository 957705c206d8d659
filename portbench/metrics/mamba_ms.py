"""Device ms a traced step of the program's ``model.mamba`` spans (each
Mamba2 mixer, in the forward and again in the backward's remat
recompute), on the program's own CUDA events (``program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.per_step(run, "model.mamba")
