"""Device ms a traced step of the program's ``model.moe`` spans (each MoE
block with its shared expert, in the forward and again in the backward's
remat recompute), on the program's own CUDA events (``program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.per_step(run, "model.moe")
