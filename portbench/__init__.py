"""The port's benchmark: the cells of ``BENCHMARK.json`` run against
``repro_torch`` on a CUDA card.  See ``portbench/README.md``."""
