"""Sinc-kernel Chebyshev coefficient generation (offline codegen layer).

Rebuild of the reference's build-time tools utils/generate_cheb_coeffs.cpp
and utils/generate_cheb_doubled_coeffs.cpp: degree-13011 Chebyshev fits of
Sinc<2N>::scaled_sinc / doubled_sinc on [-1, 1], with the same filtering
(odd terms zeroed and |c| < 1e-6 zeroed for the plain sinc; |c| < 1e-8
zeroed for the doubled sinc; trailing zeros trimmed).

Where the reference runs C++ binaries at build time to emit headers, we
compute and cache at first use (results cached in-process and on disk).
"""

from __future__ import annotations

import os
import hashlib

import numpy as np

from ..core.poly_eval import chebyshev_coefficients
from .comparison import Sinc

SINC_POLY_DEGREE = 13011
_CACHE_DIR = os.path.join(os.path.dirname(__file__), "_coeff_cache")
_mem_cache: dict = {}


def _disk_cached(key: str, compute):
    if key in _mem_cache:
        return _mem_cache[key]
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = os.path.join(_CACHE_DIR, key + ".npy")
    if os.path.exists(path):
        out = np.load(path)
    else:
        out = compute()
        np.save(path, out)
    _mem_cache[key] = out
    return out


def sinc_coefficients(N: int, degree: int = SINC_POLY_DEGREE) -> np.ndarray:
    """selectCoefficients<N>() equivalent: Chebyshev fit of
    Sinc<2N>::scaled_sinc, odd terms zeroed, even |c|<1e-6 zeroed,
    trailing zeros trimmed (generate_cheb_coeffs.cpp:11-51)."""
    def compute():
        s = Sinc(2 * N)
        c = chebyshev_coefficients(s.scaled_sinc, -1.0, 1.0, degree)
        c[1::2] = 0.0
        even = c[0::2]
        even[np.abs(even) < 1e-6] = 0.0
        c[0::2] = even
        nz = np.nonzero(np.abs(c) >= 1e-15)[0]
        return c[: nz[-1] + 1] if len(nz) else c[:1]
    return _disk_cached(f"sinc_N{N}_d{degree}", compute)


def doubled_sinc_coefficients(N: int,
                              degree: int = SINC_POLY_DEGREE) -> np.ndarray:
    """selectDoubledSincCoefficients<N>() equivalent: fit of
    Sinc<2N>::doubled_sinc with |c|<1e-8 zeroed and trailing zeros trimmed
    (generate_cheb_doubled_coeffs.cpp:11-36)."""
    def compute():
        s = Sinc(2 * N)
        c = chebyshev_coefficients(s.doubled_sinc, -1.0, 1.0, degree)
        c[np.abs(c) < 1e-8] = 0.0
        nz = np.nonzero(np.abs(c) >= 1e-8)[0]
        return c[: nz[-1] + 1] if len(nz) else c[:1]
    return _disk_cached(f"dsinc_N{N}_d{degree}", compute)
