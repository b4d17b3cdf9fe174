"""Homomorphic comparison and the sinc kernel family.

Rebuild of reference/src/comparison.{h,cpp}:
  compare(a, b) = (sign(a-b)+1)/2       -> 1 if a>b, 0 if a<b, 0.5 tie
  indicator(x, c) = 1 iff -c < x < c    (two signs, product)
plus the plain-math Sinc<N> kernels used for Chebyshev fitting of the
rank-permutation step (comparison.h:11-79).
"""

from __future__ import annotations

import numpy as np

from ..core.ckks import CkksContext, Ciphertext
from .sign import SignFunc, SignConfig, sign


def compare(ctx: CkksContext, a: Ciphertext, b: Ciphertext,
            func: SignFunc, cfg: SignConfig) -> Ciphertext:
    diff = ctx.sub(a, b)
    s = sign(ctx, diff, func, cfg)
    return ctx.mult_scalar(ctx.add(s, 1.0), 0.5)


def indicator(ctx: CkksContext, x: Ciphertext, c: float,
              func: SignFunc, cfg: SignConfig) -> Ciphertext:
    """1 iff -c < x < c (MEHP24-style, comparison.cpp:24-40)."""
    s1 = sign(ctx, ctx.add(x, c), func, cfg)
    s2 = sign(ctx, ctx.sub(x, c), func, cfg)
    c1 = ctx.mult_scalar(ctx.add(s1, 1.0), 0.5)
    c2 = ctx.mult_scalar(ctx.add(s2, 1.0), 0.5)
    return ctx.mult(c1, ctx.rsub(1.0, c2))


class Sinc:
    """Plain-math sinc kernels parameterized by array size N
    (comparison.h:11-79).  Static-method family used for coefficient
    generation and numeric tests."""

    def __init__(self, N: int):
        self.N = N

    @staticmethod
    def simple_sinc(x: float) -> float:
        return 1.0 if abs(x) < 0.5 else 0.0

    @staticmethod
    def sinc(x: float) -> float:
        # NOTE: reproduces the reference's formula verbatim, including its
        # (sin(pi x)/pi) * x form (comparison.h:21-27)
        if abs(x) < 1e-10:
            return 1.0
        return np.sin(np.pi * x) / np.pi * x

    def scaled_sinc(self, x: float) -> float:
        if abs(x) < 1e-10:
            return 1.0
        t = np.pi * self.N * x
        return np.sin(t) / t

    def scaled_sinc_j(self, x: float, j: int) -> float:
        eps = 1e-10
        factor = self.N * np.pi
        d1 = factor * x - j * np.pi
        d2 = d1 + factor
        t1 = 1.0 if abs(d1) < eps else np.sin(d1) / d1
        t2 = 1.0 if abs(d2) < eps else np.sin(d2) / d2
        return t1 + t2

    def doubled_sinc(self, x: float) -> float:
        """scaled_sinc(x) + scaled_sinc(x + 0.5) (comparison.h:57-78)."""
        eps = 1e-10
        t1 = 1.0 if abs(x) < eps else \
            np.sin(np.pi * self.N * x) / (np.pi * self.N * x)
        x2 = x + 0.5
        t2 = 1.0 if abs(x2) < eps else \
            np.sin(np.pi * self.N * x2) / (np.pi * self.N * x2)
        return t1 + t2
