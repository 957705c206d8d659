"""The yardstick's arithmetic, frozen: peaks of the card, the operations
and bytes a step and a kernel call need, and the reduction of a profiler
trace.  Copied from ``chip_smoke.py`` and ``PERF.md`` section 6, so that a
change of the program cannot move them."""
