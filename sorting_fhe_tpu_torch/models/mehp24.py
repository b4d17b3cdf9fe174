"""MEHP24: ranking / order-statistics sort under CKKS
(Mazzone-Everts-Hahn-Peter, USENIX Security '25, arXiv:2412.15126).

Rebuild of reference/src/mehp24/{mehp24_utils,mehp24_sort}.{h,cpp}: an
N-vector is laid out in an N x N matrix inside one ciphertext
(slots = N^2); log-depth rotate-add ladders implement replicate / sum /
transpose over rows and columns; rank = row-sums of the pairwise
comparison matrix; an indicator selects rank == position; and the
multi-ciphertext variant computes only upper-triangle comparison blocks,
reusing C_kj = 1 - C_jk.  Large arrays split into 256-wide chunks
(sortLargeArrayFG).

A copy of sorting_fhe_tpu/models/mehp24.py: it drives the context API
only, so it runs unchanged on the torch port's CkksContext.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.ckks import CkksContext, Ciphertext
from ..core.poly_eval import eval_poly_linear, eval_chebyshev_function
from ..ops.sign import SignFunc, SignConfig, CompositeSignConfig
from ..ops.comparison import compare as sign_compare


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


def rotation_indices(matrix_size: int) -> list[int]:
    """Rotation-key index set for the matrix ladders, incl. the 256-stride
    chunking for matrixSize > 256 (mehp24_utils.cpp:186-213)."""
    sz = matrix_size
    idx: list[int] = []
    if matrix_size > 256:
        for i in range(matrix_size // 256):
            idx.append(i * 256)
            idx.append(-i * 256)
        sz = 256
    for i in range(log2i(sz)):
        idx += [1 << i, -(1 << i)]
        idx.append(-(1 << (log2i(sz) + i)))
        step = sz * (sz - 1) // (1 << (i + 1))
        idx += [step, -step]
    return idx


@dataclass
class Mehp24:
    """Matrix-op toolkit bound to a context and matrix size."""
    ctx: CkksContext
    size: int          # matrixSize (sub-vector length)

    def __post_init__(self):
        half = self.ctx.n // 2
        assert self.size * self.size <= half, "matrix does not fit slots"
        keys = sorted({k % half for k in rotation_indices(self.size) if
                       k % half})
        self.ctx.gen_rotation_keys(keys)

    # rotations: << is left (positive), >> is right (negative), matching
    # the reference's ciphertext operators (mehp24_utils.h:32-40)
    def _rotl(self, c, k):
        return self.ctx.rotate(c, k)

    def _rotr(self, c, k):
        return self.ctx.rotate(c, -k)

    def _slots(self):
        return self.size * self.size

    def _pt(self, vec, ct):
        return self.ctx.make_plaintext(vec, ct.limbs, self.ctx.delta,
                                       self._slots())

    # ---------------- matrix primitives (mehp24_utils.cpp:21-103) ---------
    def mask_row(self, c, row):
        sz = self.size
        m = np.zeros(sz * sz)
        m[sz * row: sz * row + sz] = 1.0
        # canonical-factor plaintext: the mask product lands back on the
        # scale ladder instead of drifting by Delta/S[l]
        return self.ctx.mult_plain(c, m, self._slots())

    def mask_column(self, c, col):
        sz = self.size
        m = np.zeros(sz * sz)
        m[col::sz] = 1.0
        return self.ctx.mult_plain(c, m, self._slots())

    def replicate_row(self, c):
        sz = self.size
        for i in range(log2i(sz)):
            c = self.ctx.add(c, self._rotr(c, 1 << (log2i(sz) + i)))
        return c

    def replicate_column(self, c):
        sz = self.size
        for i in range(log2i(sz)):
            c = self.ctx.add(c, self._rotr(c, 1 << i))
        return c

    def sum_rows(self, c, mask_output=False, output_row=0):
        sz = self.size
        for i in range(log2i(sz)):
            c = self.ctx.add(c, self._rotr(c, 1 << (log2i(sz) + i)))
        if mask_output:
            c = self.mask_row(c, output_row)
        return c

    def sum_columns(self, c, mask_output=False):
        sz = self.size
        for i in range(log2i(sz)):
            c = self.ctx.add(c, self._rotl(c, 1 << i))
        if mask_output:
            c = self.mask_column(c, 0)
        return c

    def transpose_row(self, c, mask_output=False):
        sz = self.size
        for i in range(1, log2i(sz) + 1):
            c = self.ctx.add(c, self._rotr(c, sz * (sz - 1) // (1 << i)))
        if mask_output:
            c = self.mask_column(c, 0)
        return c

    def transpose_column(self, c, mask_output=False):
        sz = self.size
        for i in range(1, log2i(sz) + 1):
            c = self.ctx.add(c, self._rotl(c, sz * (sz - 1) // (1 << i)))
        if mask_output:
            c = self.mask_row(c, 0)
        return c

    # ---------------- comparisons (mehp24_utils.cpp:105-261) ---------------
    def sign_adv(self, c, dg, df):
        return sign_adv(self.ctx, c, dg, df)

    def compare_adv(self, c1, c2, dg, df):
        return self.sign_adv(self.ctx.sub(c1, c2), dg, df)

    def compare_cheb(self, c1, c2, a, b, degree, error=1e-5):
        def f(x):
            return 1.0 if x > error else (0.5 if x >= -error else 0.0)
        return eval_chebyshev_function(self.ctx, f,
                                       self.ctx.sub(c1, c2), a, b, degree)

    def compare_gt_cheb(self, c1, c2, a, b, degree, error=1e-5):
        return eval_chebyshev_function(
            self.ctx, lambda x: 1.0 if x > error else 0.0,
            self.ctx.sub(c1, c2), a, b, degree)

    def equal_cheb(self, c1, c2, a, b, degree, error=1e-5):
        return eval_chebyshev_function(
            self.ctx, lambda x: 1.0 if -error <= x <= error else 0.0,
            self.ctx.sub(c1, c2), a, b, degree)

    def indicator_cheb(self, c, a1, b1, a, b, degree):
        return eval_chebyshev_function(
            self.ctx, lambda x: 0.0 if (x < a1 or x > b1) else 1.0,
            c, a, b, degree)

    def indicator_adv(self, c, b, dg, df):
        # sign_adv already folds (y+1)/2, so these are 0/1 comparisons
        return indicator_adv(self.ctx, c, b, dg, df)

    def indicator_adv_shifted(self, c, b, dg, df):
        ctx = self.ctx
        c1 = ctx.add(ctx.mult_scalar(c, 2.0 / (b + 1)), 2.0 / (b + 1) - 1.0)
        c2 = ctx.add(ctx.mult_scalar(c, -2.0 / (b + 1)), 2.0 / (b + 1) + 1.0)
        return ctx.mult(self.sign_adv(c1, dg, df), self.sign_adv(c2, dg, df))


# ---------------- sorts (mehp24_sort.cpp) ----------------

def sort_cheb(ctx: CkksContext, c: Ciphertext, n: int,
              left: float, right: float, degree_c: int,
              degree_i: int) -> Ciphertext:
    """Single-ciphertext sort with Chebyshev comparisons
    (mehp24_sort.cpp:23-46).  Result: sorted values in matrix column 0."""
    m = Mehp24(ctx, n)
    VR = m.replicate_row(c)
    VC = m.replicate_column(m.transpose_row(c, True))
    C = m.compare_cheb(VR, VC, left, right, degree_c)
    R = m.sum_rows(C)
    sub = np.repeat(-np.arange(n, dtype=np.float64) - 0.5, n)
    Rm = ctx.add(R, ctx.make_plaintext(sub, R.limbs, R.scale, n * n))
    M = m.indicator_cheb(Rm, -0.5, 0.5, -1.0 * n, 1.0 * n, degree_i)
    S = m.sum_columns(ctx.mult(M, VR))
    return S


def _compare_fn(ctx: CkksContext, m: "Mehp24", dg_c: int, df_c: int,
                sign_func: SignFunc | None, sign_cfg: SignConfig | None):
    """Comparison kernel selector: f3/g3 iterations by default, or the
    generic sign evaluator when a SignFunc config is given — the
    equivalents of the two sortFG overloads
    (reference/src/mehp24/mehp24_sort.h:37-45)."""
    if sign_func is None:
        return lambda a, b: m.compare_adv(a, b, dg_c, df_c)
    # default-construct like the reference's SignConfig() (sign.h:25):
    # SignConfig here has no compos default, so supply one explicitly
    cfg = sign_cfg or SignConfig(CompositeSignConfig())
    return lambda a, b: sign_compare(ctx, a, b, sign_func, cfg)


def sort_fg(ctx: CkksContext, c: Ciphertext, n: int,
            dg_c: int, df_c: int, dg_i: int, df_i: int,
            sign_func: SignFunc | None = None,
            sign_cfg: SignConfig | None = None) -> Ciphertext:
    """Single-ciphertext sortFG (mehp24_sort.cpp:219-249): f3/g3-iteration
    comparisons (or a SignFunc config via the overload args,
    mehp24_sort.h:42-45).  Sorted values land in the first n slots (row 0)."""
    m = Mehp24(ctx, n)
    cmp = _compare_fn(ctx, m, dg_c, df_c, sign_func, sign_cfg)
    VR = m.replicate_row(c)
    VC = m.replicate_column(m.transpose_row(c, True))
    C = cmp(VR, VC)
    R = m.sum_rows(C)
    sub = np.repeat(-np.arange(n, dtype=np.float64) - 0.5, n)
    Rm = ctx.add(R, ctx.make_plaintext(sub, R.limbs, R.scale, n * n))
    M = m.indicator_adv(Rm, float(n), dg_i, df_i)
    S = m.sum_columns(ctx.mult(M, VR), True)
    return m.transpose_column(S, True)


def sort_fg_multi(ctx: CkksContext, cts: list[Ciphertext], sub_len: int,
                  dg_c: int, df_c: int, dg_i: int, df_i: int,
                  sign_func: SignFunc | None = None,
                  sign_cfg: SignConfig | None = None) -> list[Ciphertext]:
    """Multi-ciphertext sortFG (mehp24_sort.cpp:284-443): upper-triangle
    comparisons only, C_kj = 1 - C_jk reuse.  SignFunc overload:
    mehp24_sort.h:53-55."""
    m = Mehp24(ctx, sub_len)
    cmp = _compare_fn(ctx, m, dg_c, df_c, sign_func, sign_cfg)
    num = len(cts)
    total = sub_len * num

    repl_r = [m.replicate_row(c) for c in cts]
    repl_c = [m.replicate_column(m.transpose_row(c, True)) for c in cts]

    Cv: list = [None] * num
    Ch: list = [None] * num
    for j in range(num):
        for k in range(j, num):
            Cjk = cmp(repl_r[j], repl_c[k])
            Cv[j] = Cjk if Cv[j] is None else ctx.add(Cv[j], Cjk)
            if j != k:
                Ckj = ctx.rsub(1.0, Cjk)
                Ch[k] = Ckj if Ch[k] is None else ctx.add(Ch[k], Ckj)

    s: list = [None] * num
    for j in range(num):
        svj = m.sum_rows(Cv[j])
        s[j] = svj
    for j in range(1, num):
        shj = m.sum_columns(Ch[j], True)
        shj = m.transpose_column(shj, True)
        shj = m.replicate_row(shj)
        s[j] = ctx.add(s[j], shj)

    sub_sorted: list = [None] * num
    for j in range(num):
        # mask rows follow matrix layout: row r gets -(j*sub_len + r) - 0.5
        sub = np.repeat(-(j * sub_len + np.arange(sub_len, dtype=np.float64))
                        - 0.5, sub_len)
        for k in range(num):
            skm = ctx.add(s[k], ctx.make_plaintext(sub, s[k].limbs,
                                                   s[k].scale,
                                                   sub_len * sub_len))
            ind = ctx.mult(m.indicator_adv(skm, float(total), dg_i, df_i),
                           repl_r[k])
            sub_sorted[j] = ind if sub_sorted[j] is None else \
                ctx.add(sub_sorted[j], ind)

    out = []
    for j in range(num):
        r = m.sum_columns(sub_sorted[j], True)
        out.append(m.transpose_column(r, True))
    return out


def split_ciphertext(ctx: CkksContext, c: Ciphertext, total_len: int,
                     sub_len: int) -> list[Ciphertext]:
    """(mehp24_utils.cpp:266-288)"""
    num = total_len // sub_len
    out = []
    for i in range(num):
        mask = np.zeros(total_len)
        mask[i * sub_len:(i + 1) * sub_len] = 1.0
        part = ctx.mult_plain(c, mask, c.slots)
        if i > 0:
            part = ctx.rotate(part, i * sub_len)
        out.append(part)
    return out


def combine_ciphertext(ctx: CkksContext, parts: list[Ciphertext],
                       sub_len: int) -> Ciphertext:
    """(mehp24_utils.cpp:291-302)"""
    result = parts[0]
    for i in range(1, len(parts)):
        result = ctx.add(result, ctx.rotate(parts[i], -i * sub_len))
    return result


def sort_large_array_fg(ctx: CkksContext, c: Ciphertext, total_len: int,
                        sub_len: int, dg_c: int, df_c: int, dg_i: int,
                        df_i: int, sign_func: SignFunc | None = None,
                        sign_cfg: SignConfig | None = None) -> Ciphertext:
    """(mehp24_sort.cpp:607-625): split -> multi-ct sortFG -> combine.
    Needs rotation keys for the +-i*sub_len strides.  SignFunc overload:
    mehp24_sort.h:63-66."""
    half = ctx.n // 2
    ctx.gen_rotation_keys(sorted({(i * sub_len) % half
                                  for i in range(1, total_len // sub_len)} |
                                 {(-i * sub_len) % half
                                  for i in range(1, total_len // sub_len)}))
    parts = split_ciphertext(ctx, c, total_len, sub_len)
    parts = [p.with_slots(sub_len * sub_len) for p in parts]
    sorted_parts = sort_fg_multi(ctx, parts, sub_len, dg_c, df_c, dg_i, df_i,
                                 sign_func, sign_cfg)
    return combine_ciphertext(ctx, sorted_parts, sub_len)
