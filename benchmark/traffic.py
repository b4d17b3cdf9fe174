"""The one generator of the traffic mixes: the inputs a client encrypts
and sends, drawn from the seed and the configuration's `data` block.

`pool_size` inputs per run: enough for a window of whole sorts at the
mix's `min_sort_s`, plus one for the warm-up sort.  Input i is drawn from
default_rng([seed, i]), so every seed sends inputs of the same size and
spacing, and the same seed the same inputs.
"""

from __future__ import annotations

import math

import numpy as np


def vector_with_min_diff(n: int, low: float, high: float, min_diff: float,
                         rng: np.random.Generator) -> np.ndarray:
    """n shuffled distinct values in [low, high], pairwise at least
    min_diff apart (the reference's getVectorWithMinDiff,
    tests/utils.h:8-51, the separation its sign approximations need)."""
    slack = (high - low) - (n - 1) * min_diff
    if slack < 0:
        raise ValueError(f"{n} values {min_diff} apart do not fit in "
                         f"[{low}, {high}]")
    extra = rng.uniform(0, 1, n)
    extra = extra / extra.sum() * slack * rng.uniform(0.2, 0.95)
    vals = low + np.concatenate([[0.0], np.cumsum(min_diff + extra[1:])])
    return rng.permutation(vals + extra[0])


def check(traffic: dict):
    """The mixes this generator drives: a closed loop of one client."""
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError(f"unsupported traffic: loop {traffic['loop']!r} "
                         f"with {traffic['clients']} clients")


def pool_size(traffic: dict, seconds: float) -> int:
    """Distinct inputs of one run: the window's sorts at the mix's fastest
    expected sort, and the warm-up's."""
    return max(1, math.ceil(seconds / traffic["min_sort_s"])) + 1


def inputs(data: dict, n: int, seed: int, count: int) -> list:
    """`count` input vectors of n values for `seed` (data: the
    configuration's `data` block)."""
    if data["kind"] != "vector_with_min_diff":
        raise ValueError(f"unknown data kind {data['kind']!r}")
    return [vector_with_min_diff(n, data["low"], data["high"],
                                 data["min_diff"],
                                 np.random.default_rng([seed, i]))
            for i in range(count)]
