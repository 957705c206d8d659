"""AdamW's share of its roofline, in %: its least bytes a step
(``arith.adamw_bytes``) at 3.35 TB/s over the device ms of the program's
span ``adamw.update`` a traced step (``program_spans``)."""

from portbench import program_spans
from portbench.arith.adamw_bytes import adamw_bytes
from portbench.arith.peaks import HBM_BYTES_PER_S


def read(run):
    ms = program_spans.per_step(run, "adamw.update")
    if not ms:
        return None
    return 100 * adamw_bytes(run.config) / HBM_BYTES_PER_S / (ms / 1e3)
