"""Device ms a traced step of the program's span ``train.backward``
(``torch.autograd.grad`` in ``steps.loss_and_grads``; under remat it
holds the layers' recompute), on the program's own CUDA events
(``program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.per_step(run, "train.backward")
