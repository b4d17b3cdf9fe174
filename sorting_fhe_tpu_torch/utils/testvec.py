"""Test-input generation: shuffled distinct reals with a guaranteed minimum
gap — port of the reference's getVectorWithMinDiff (tests/utils.h:8-51),
the separation contract the sign approximation needs.
"""

from __future__ import annotations

import numpy as np


def vector_with_min_diff(n: int, min_val: float = 0.0, max_val: float = 1.0,
                         min_diff: float | None = None,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """n shuffled distinct values in [min_val, max_val] with pairwise
    difference >= min_diff (default 1/n, as the sort tests use)."""
    rng = rng or np.random.default_rng(0)
    if min_diff is None:
        min_diff = 1.0 / n
    span = max_val - min_val
    slack = span - (n - 1) * min_diff
    assert slack >= 0, "min_diff too large for range"
    # n-1 gaps of at least min_diff, plus random extra summing <= slack
    extra = rng.uniform(0, 1, n)
    extra = extra / extra.sum() * slack * rng.uniform(0.2, 0.95)
    vals = min_val + np.concatenate([[0.0], np.cumsum(min_diff + extra[1:])])
    vals += extra[0]
    return rng.permutation(vals)
