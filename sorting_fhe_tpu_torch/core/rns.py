"""RNS modular arithmetic on torch tensors, computed exactly in int64.

Counterpart of sorting_fhe_tpu/core/rns.py with the same conventions and
the same canonical outputs:

* primes p < 2^31, residues canonical in [0, p).  Storage is int32: a
  residue below 2^31 has the same bit pattern as the JAX package's uint32.
* Polynomial data lives in the Montgomery domain (stored value =
  v * 2^32 mod p); `mont_mul(a, b)` returns the Montgomery form of the
  product directly.
* Constants for `shoup_mul` are in the plain domain.

The JAX package builds 32x32->64 products from 16-bit digit splits because
its TPU has no 64-bit multiplier.  Here every product of two residues fits
int64 (< 2^62), so each op is an exact formula.  Inputs may be int32 or
int64; results are int64 canonical residues, and callers cast to int32
where they store.  Results equal the JAX ops bit for bit because both are
canonical (tests/test_torch_rns.py).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _i64(x):
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else x


def _u32(x):
    """Widen a tensor that holds uint32 bit patterns (possibly negative as
    int32) to its unsigned value in int64."""
    return _i64(x) & _MASK32


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p)."""
    s = _i64(a) + _i64(b)
    return torch.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    s = _i64(a) - _i64(b)
    return torch.where(s < 0, s + p, s)


def neg_mod(a, p):
    """(-a) mod p."""
    a = _i64(a)
    return torch.where(a == 0, a, p - a)


def mont_mul(a, b, p, r_inv):
    """Montgomery product a*b*2^-32 mod p.  `r_inv` = 2^-32 mod p
    (CkksParams.mont_r_inv) stands where the JAX op takes -p^-1 mod 2^32;
    the result is the same canonical residue."""
    return _i64(a) * _i64(b) % p * r_inv % p


def shoup_mul(x, w, p):
    """x * w mod p for x < 2^32, w in [0, p).  The JAX op's Shoup
    companion floor(w * 2^32 / p) is not needed: the product is exact in
    int64."""
    return _i64(x) * _i64(w) % p


def mont_reduce(t_hi, t_lo, p, r_inv):
    """REDC of the 64-bit value t_hi*2^32 + t_lo (uint32 halves):
    t * 2^-32 mod p.  `r_inv` as in mont_mul."""
    hi = _u32(t_hi) % p
    r_mod = (1 << 32) % p
    return (hi * r_mod + _u32(t_lo)) % p * r_inv % p


def barrett_reduce_u32(x, p):
    """x mod p for full-range uint32 x (no Barrett factor needed)."""
    return _u32(x) % p
