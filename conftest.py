"""Tiers of the test suite that a test file's own markers do not say.

tests/test_bootstrap_depth.py runs under `-m slow`, not in tier-1
(`-m 'not slow'`).  It runs only the JAX package, and its two tests hold
one xdist worker for 900-1450 s, so that a tier-1 run with it cannot end
inside the time limit that ROADMAP.md's tier-1 line gives (`--dist
loadfile` hands the two-test file out late, after files with more
tests).  Tier-1 holds the port to the same two triggers, with the same
depths, sign degrees, inputs and gates, at ring 2^8:
tests/test_torch_bitonic_kway.py::test_bitonic_real_bootstrap_at_depth
and ::test_kway_k2_m4_real_bootstrap_at_depth.
"""

import pytest

SLOW_FILES = ("tests/test_bootstrap_depth.py",)


@pytest.hookimpl(tryfirst=True)   # before `-m` deselects by marker
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid.split("::")[0] in SLOW_FILES:
            item.add_marker(pytest.mark.slow)
