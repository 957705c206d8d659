"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(run)`` takes a :class:`portbench.record.Record` and returns the
number, or None where the run holds nothing to read (the harness then
leaves the metric out of the line)."""
