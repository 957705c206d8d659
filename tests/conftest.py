"""Shared test configuration.

Registers the ``ci`` hypothesis profile (the default; the CI workflow
also pins ``HYPOTHESIS_PROFILE=ci`` explicitly) so property tests
(test_dim3, test_collectives_property, test_core_property) are
deterministic and bounded on shared runners: fixed example order
(``derandomize``), a capped example count, and no deadline — wall-clock
flakiness on busy runners must not fail the suite.  Set
``HYPOTHESIS_PROFILE=dev`` for a wider randomized local run.
Hypothesis stays optional: without it the property tests importorskip
themselves out.
"""
import os

try:
    from hypothesis import HealthCheck, settings
except ImportError:  # property tests skip themselves
    settings = None

if settings is not None:
    settings.register_profile(
        "ci",
        derandomize=True,        # fixed seed: same examples every run
        max_examples=25,         # bounded work per property
        deadline=None,           # shared runners stall; no per-example clock
        print_blob=True,
        suppress_health_check=[HealthCheck.too_slow],
    )
    settings.register_profile("dev", max_examples=100)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))


def pytest_configure(config):
    # tests that need a CUDA card; they skip (inside the test) without one
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
