"""GiB the forward keeps for the backward: the change of the card's
``memory_allocated`` across the program's span ``train.forward``, a
traced step (``program_spans``)."""

from portbench import program_spans


def read(run):
    kept = program_spans.per_step(run, "train.forward", key="mem_delta")
    return None if kept is None else kept / 2**30
