"""MEHP24 sign/indicator kernels (Mazzone-Everts-Hahn-Peter, USENIX
Security '25, arXiv:2412.15126): the part of sorting_fhe_tpu/models/mehp24.py
that hybrid1's permutation stage calls (DirectSort.rotation_index_check_hybrid1).

Rebuild of reference/src/mehp24/mehp24_utils.cpp.  Not ported yet: the
matrix-layout ladders, the `Mehp24` class and the sorts (sort_cheb,
sort_fg, sort_fg_multi, sort_large_array_fg).
"""

from __future__ import annotations

import math

from ..core.ckks import CkksContext, Ciphertext
from ..core.poly_eval import eval_poly_linear


def log2i(x: int) -> int:
    return int(math.ceil(math.log2(x)))


# power-basis coefficient lists for the f3/g3 EvalPolyLinear iterations
# (reference mehp24_utils.cpp:248-253)
COEFF_F3 = [0, 35.0 / 16.0, 0, -35.0 / 16.0, 0, 21.0 / 16.0, 0, -5.0 / 16.0]
COEFF_F3_FINAL = [0.5, 35.0 / 32.0, 0, -35.0 / 32.0, 0, 21.0 / 32.0, 0,
                  -5.0 / 32.0]
COEFF_G3 = [0, 4589.0 / 1024.0, 0, -16577.0 / 1024.0, 0, 25614.0 / 1024.0,
            0, -12860.0 / 1024.0]


def sign_adv(ctx: CkksContext, c: Ciphertext, dg: int, df: int) -> Ciphertext:
    """dg x g3, (df-1) x f3, then f3 with (y+1)/2 folded in
    (mehp24_utils.cpp:166-184)."""
    for _ in range(dg):
        c = eval_poly_linear(ctx, c, COEFF_G3)
    for _ in range(df - 1):
        c = eval_poly_linear(ctx, c, COEFF_F3)
    return eval_poly_linear(ctx, c, COEFF_F3_FINAL)


def indicator_adv(ctx: CkksContext, c: Ciphertext, b: float, dg: int,
                  df: int) -> Ciphertext:
    """1 iff |c| < 0.5 (after scaling by 1/b) via two advanced signs
    (mehp24_utils.cpp:246-253)."""
    tmp = ctx.mult_scalar(c, 1.0 / b)
    c1 = sign_adv(ctx, ctx.add(tmp, 0.5 / b), dg, df)
    c2 = sign_adv(ctx, ctx.sub(tmp, 0.5 / b), dg, df)
    return ctx.mult(c1, ctx.rsub(1.0, c2))


def depth2degree(depth: int) -> int:
    """Chebyshev degree evaluable in the given depth
    (mehp24_utils.cpp:215-244)."""
    table = {3: 2, 4: 5, 5: 13, 6: 27, 7: 59, 8: 119, 9: 247, 10: 495,
             11: 1007, 12: 2031, 13: 4031, 14: 8127}
    return table.get(depth, -1)
