"""The control of the sort cells' comparison: the program with its
indicator one composition lower.

Each configuration states the degrees of its comparisons and of the
indicator that places each value by its rank (the reference fixture's:
hybrid1 N=128 indicatorAdv (dg, df) = (4, 2), sort_algo.h:1067-1210;
MEHP24 N=128 (dg_i, df_i) = (4, 2), Mehp24SortTest.cpp:126-137).  One
composition fewer saves three levels of the chain, the step a faster
sort would take, and the JAX package's bench takes it for MEHP24
(dg_i = dg_c = 3).  `lowered_indicator()` switches it on for both sorts
until the block exits; the benchmark's own runs never do.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def lowered_indicator():
    from sorting_fhe_tpu_torch.models import direct_sort, mehp24

    orig = mehp24.indicator_adv

    def lowered(ctx, c, b, dg, df):
        return orig(ctx, c, b, dg - 1, df)

    mehp24.indicator_adv = direct_sort._indicator_adv = lowered
    try:
        yield
    finally:
        mehp24.indicator_adv = direct_sort._indicator_adv = orig
