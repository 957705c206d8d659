"""Device ms a traced step of the program's span ``train.forward``
(``steps.loss_and_grads``'s forward through the loss), on the program's
own CUDA events (``program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.per_step(run, "train.forward")
