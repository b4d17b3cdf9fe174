"""Homomorphic polynomial evaluation: Chebyshev series via
Paterson–Stockmeyer (Han–Ki), plain power-basis evaluation, and Chebyshev
function interpolation.

Covers the OpenFHE surface the reference uses:
  - EvalChebyshevSeriesPS  (sign g4, sinc kernels: sign.cpp:66-77,
    sort_algo.h:627-728)
  - EvalPolyLinear         (mehp24_utils.cpp:137-184 f3/g3 iterations)
  - EvalChebyshevFunction  (sign.cpp:610-633 naive/tanh variants)

Host drives the recursion; every node is a ciphertext op on device.
Scalar-only subtrees stay scalars (no wasted ct ops).  A copy of the JAX
package's module, but for one thing: the evaluators empty their tables of
powers before they return, which their recursive closures would otherwise
keep alive until the next garbage collection.
"""

from __future__ import annotations

import numpy as np

from .ckks import CkksContext, Ciphertext


def _trim(coeffs) -> np.ndarray:
    c = np.asarray(coeffs, dtype=np.float64)
    nz = np.nonzero(np.abs(c) > 0)[0]
    return c[: nz[-1] + 1] if len(nz) else c[:1]


def _cheb_long_div(f: np.ndarray, N: int):
    """Divide f (Chebyshev basis) by T_N: f = T_N * q + r, using
    2 T_N T_m = T_{N+m} + T_{|N-m|}."""
    f = f.copy()
    d = len(f) - 1
    q = np.zeros(d - N + 1, dtype=np.float64)
    for i in range(d, N, -1):
        c = f[i]
        if c == 0.0:
            continue
        q[i - N] += 2.0 * c
        f[i] = 0.0
        f[abs(i - 2 * N)] -= c
    q[0] += f[N]
    f[N] = 0.0
    return q, f[:N] if N > 0 else f


def _is_ct(x) -> bool:
    """Duck-typed ciphertext check (works for the plaintext mock too)."""
    return not isinstance(x, (int, float, np.floating))


class _SymEval:
    """Ciphertext-or-scalar algebra so constant subtrees cost nothing."""

    def __init__(self, ctx: CkksContext):
        self.ctx = ctx

    def add(self, a, b):
        if _is_ct(a):
            return self.ctx.add(a, b)
        if _is_ct(b):
            return self.ctx.add(b, a)
        return a + b

    def sub(self, a, b):
        if _is_ct(a):
            return self.ctx.sub(a, b)
        if _is_ct(b):
            return self.ctx.rsub(a, b)
        return a - b

    def mul(self, a, b):
        if _is_ct(a) and _is_ct(b):
            return self.ctx.mult(a, b)
        if _is_ct(b):
            a, b = b, a
        if _is_ct(a):
            # small exact integers (the PS doubling constant 2, parity
            # flips, ...) are depth-free: message *= m with no rescale —
            # mirrors OpenFHE's EvalAdd(prod, prod) doubling
            f = float(b)
            if f.is_integer() and abs(f) <= 16:
                return self.ctx.mult_int(a, int(f))
            return self.ctx.mult_scalar(a, f)
        return a * b


def _memo_deg1(se: _SymEval, cache: dict, i):
    """Fetch cache[i] normalized to noise degree 1, writing the rescaled
    value back so REUSED powers/baby-steps rescale ONCE instead of once
    per consumer (round-4 census: the per-use _ensure_deg1 inside mult
    re-rescaled shared T_i hundreds of times per sort)."""
    t = cache[i]
    if _is_ct(t) and getattr(t, "noise_deg", 1) == 2:
        t = se.ctx.rescale(t)
        cache[i] = t
    return t


def _linear_cheb_combo(se: _SymEval, coeffs: np.ndarray, T: dict):
    """sum_i coeffs[i] * T_i using precomputed T dict (T[0] == 1.0)."""
    acc = float(coeffs[0])
    for i in range(1, len(coeffs)):
        c = float(coeffs[i])
        if c == 0.0:
            continue
        acc = se.add(acc, se.mul(_memo_deg1(se, T, i), c))
    return acc


def eval_chebyshev_series_ps(ctx: CkksContext, ct: Ciphertext, coeffs,
                             a: float = -1.0, b: float = 1.0) -> Ciphertext:
    """EvalChebyshevSeriesPS: evaluate sum c_i T_i((2x - a - b)/(b - a)).

    Paterson–Stockmeyer over the Chebyshev basis: baby steps T_1..T_k,
    giant steps T_{k 2^j}, recursive long division.  Depth ≈ log2(deg)+2.
    """
    se = _SymEval(ctx)
    c = _trim(coeffs)
    d = len(c) - 1
    if a != -1.0 or b != 1.0:
        # y = (2x - (a+b)) / (b-a)
        y = ctx.mult_scalar(ct, 2.0 / (b - a))
        y = ctx.add(y, -(a + b) / (b - a))
    else:
        y = ct
    if d == 0:
        raise ValueError("constant series: nothing to evaluate")
    if d == 1:
        return se.add(se.mul(y, float(c[1])), float(c[0]))

    k = max(2, int(2 ** np.ceil(np.log2(max(2.0, np.sqrt(d / 2.0))))))
    return _ps_eval(se, y, c, k)


def _ps_eval(se: _SymEval, y: Ciphertext, c: np.ndarray, k: int):
    ctx = se.ctx
    d = len(c) - 1
    # baby steps
    T: dict = {0: 1.0, 1: y}

    def get_T(i: int):
        if i in T:
            return T[i]
        if i % 2 == 0:
            get_T(i // 2)
            h = _memo_deg1(se, T, i // 2)
            sqh = ctx.square(h) if _is_ct(h) else h * h
            T[i] = se.sub(se.mul(2.0, sqh), 1.0)
        else:
            lo, hi = (i - 1) // 2, (i + 1) // 2
            get_T(lo), get_T(hi)
            # 2 T_a T_b = T_{a+b} + T_{a-b}
            T[i] = se.sub(se.mul(2.0, se.mul(_memo_deg1(se, T, lo),
                                             _memo_deg1(se, T, hi))),
                          get_T(hi - lo))
        return T[i]

    for i in range(2, k + 1):
        get_T(i)
    # giant steps T_{k*2^j} while <= d
    giants = [k]
    while giants[-1] * 2 <= d:
        N = giants[-1] * 2
        get_T(giants[-1])
        gp = _memo_deg1(se, T, giants[-1])
        T[N] = se.sub(se.mul(2.0, ctx.square(gp)), 1.0)
        giants.append(N)

    def rec(f: np.ndarray):
        f = _trim(f)
        deg = len(f) - 1
        if deg <= k:
            return _linear_cheb_combo(se, f, T)
        # largest giant <= deg
        N = k
        for g in giants:
            if g <= deg:
                N = g
        q, r = _cheb_long_div(f, N)
        qv = rec(q)
        rv = rec(r)
        return se.add(se.mul(qv, _memo_deg1(se, T, N)), rv)

    # get_T and rec name themselves, so they and their closure cells form
    # a reference cycle that only the garbage collector frees; emptying T
    # frees the powers (a few GB of ciphertexts at ring 2^17) on return
    try:
        return rec(c)
    finally:
        T.clear()


def eval_poly_linear(ctx: CkksContext, ct: Ciphertext, coeffs) -> Ciphertext:
    """EvalPolyLinear: power-basis sum c_i x^i at depth ceil(log2 d).

    Matches OpenFHE's depth behaviour (the reference's f3/g3 depth-3
    budget per degree-7 poly, mehp24_utils.cpp:137-184): each term
    c_i x^i is an ascending chain over the power-of-two factors of i
    with the scalar folded into the LOWEST factor, so the constant
    multiply rides the first chain link instead of costing a level on
    top of the finished power.  coeffs[i] multiplies x^i."""
    se = _SymEval(ctx)
    c = _trim(coeffs)
    d = len(c) - 1
    if d == 0:
        raise ValueError("constant polynomial")
    # x^(2^j) ladder by repeated squaring: depth j
    sq: dict = {0: ct}

    def get_sq(j: int):
        if j not in sq:
            sq[j] = ctx.square(get_sq(j - 1))
        return sq[j]

    acc = float(c[0])
    for i in range(1, d + 1):
        if c[i] == 0.0:
            continue
        bits = [j for j in range(i.bit_length()) if i >> j & 1]
        for j in bits:
            get_sq(j)
        # fold the coefficient into the lowest power-of-two factor
        term = se.mul(_memo_deg1(se, sq, bits[0]), float(c[i]))
        for j in bits[1:]:
            term = ctx.mult(term, _memo_deg1(se, sq, j))
        acc = se.add(acc, term)
    sq.clear()        # get_sq's cycle holds sq (see _ps_eval)
    return acc


def chebyshev_coefficients(fn, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of fn on [a, b] at `degree`+1
    Chebyshev nodes — equivalent of lbcrypto::EvalChebyshevCoefficients
    (used by the reference's coefficient codegen, utils/generate_cheb_coeffs
    .cpp:11-51).  Matches the classic cos-transform formula."""
    m = degree + 1
    jj = np.arange(m)
    nodes = np.cos(np.pi * (jj + 0.5) / m)
    x = 0.5 * (b - a) * nodes + 0.5 * (a + b)
    fv = np.array([fn(t) for t in x], dtype=np.float64)
    # DCT-II via FFT (degree can be >10^4, O(m^2) matrix is too big):
    # c_k = (2/m) sum_j f_j cos(pi k (j+0.5)/m)
    y = np.zeros(2 * m, dtype=np.complex128)
    y[:m] = fv
    y[m:] = fv[::-1]
    F = np.fft.fft(y)[:m]
    c = (1.0 / m) * np.real(F * np.exp(-1j * np.pi * jj / (2 * m)))
    c[0] *= 0.5
    return c


def eval_chebyshev_function(ctx: CkksContext, fn, ct: Ciphertext,
                            a: float, b: float, degree: int) -> Ciphertext:
    """EvalChebyshevFunction: fit fn on [a,b] then evaluate the series."""
    c = chebyshev_coefficients(fn, a, b, degree)
    return eval_chebyshev_series_ps(ctx, ct, c, a, b)
