"""Plain reference: decrypt a CKKS ciphertext and judge a sort's output.

NumPy only; it imports nothing of the port.  It works out for itself
what the port derived from the seed and the configuration:

* the secret: the client's first draw, `default_rng(seed).integers(-1,
  2, n)` (a uniform ternary secret), frozen here;
* the evaluation domain: limb i of a ciphertext holds, at position j,
  the value at psi^(2 brv(j) + 1) of its polynomial mod q_i, where psi =
  g^((q_i - 1) / 2n) for g the smallest generator of (Z/q_i)^* and brv
  the log2(n)-bit reversal, times 2^32 (Montgomery form);
* the slots: slot j of a polynomial m is m(zeta^(5^j mod 2n)) / scale,
  zeta = exp(i pi / n).

The primes come from the configuration file, not from the program.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

U64 = np.uint64


def secret_coeffs(n: int, seed: int) -> np.ndarray:
    """The uniform ternary secret that the client draws first from
    default_rng(seed), int64 [n]."""
    return np.random.default_rng(seed).integers(-1, 2, size=n).astype(
        np.int64)


def _prime_factors(m: int) -> list[int]:
    out, d = [], 2
    while d * d <= m:
        if m % d == 0:
            out.append(d)
            while m % d == 0:
                m //= d
        d += 1
    return out + ([m] if m > 1 else [])


@lru_cache(maxsize=None)
def psi(p: int, n: int) -> int:
    """The primitive 2n-th root of unity mod p of the evaluation domain."""
    factors = _prime_factors(p - 1)
    g = 2
    while any(pow(g, (p - 1) // f, p) == 1 for f in factors):
        g += 1
    return pow(g, (p - 1) // (2 * n), p)


@lru_cache(maxsize=None)
def bit_reversal(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _powers(base: int, count: int, p: int) -> np.ndarray:
    """[base^0, ..., base^(count-1)] mod p, uint64."""
    out = np.ones(count, dtype=U64)
    block = 1
    while block < count:
        end = min(2 * block, count)
        out[block:end] = out[:end - block] * U64(pow(base, block, p)) % U64(p)
        block *= 2
    return out


def cyclic_ntt(a: np.ndarray, w: int, p: int) -> np.ndarray:
    """A_k = sum_i a_i w^(ik) mod p, k in natural order (radix-2,
    decimation in time); a uint64 [n], entries below p < 2^31."""
    n = len(a)
    a = a[bit_reversal(n)]
    tw_all = _powers(w, n // 2, p)
    pp = U64(p)
    m = 1
    while m < n:
        tw = tw_all[::n // (2 * m)][:m]
        a = a.reshape(-1, 2 * m)
        u, v = a[:, :m], a[:, m:] * tw % pp
        a = np.concatenate([(u + v) % pp, (u + pp - v) % pp], axis=1)
        m *= 2
    return a.reshape(n)


def to_domain(f: np.ndarray, p: int) -> np.ndarray:
    """Coefficients mod p (uint64 [n]) -> the evaluation domain's order."""
    n = len(f)
    r = psi(p, n)
    e = cyclic_ntt(f * _powers(r, n, p) % U64(p), r * r % p, p)
    return e[bit_reversal(n)]


def from_domain(v: np.ndarray, p: int) -> np.ndarray:
    """Inverse of to_domain: uint64 [n] values -> coefficients mod p."""
    n = len(v)
    r_inv = pow(psi(p, n), -1, p)
    f = cyclic_ntt(v[bit_reversal(n)], r_inv * r_inv % p, p)
    return f * _powers(r_inv, n, p) % U64(p) * U64(pow(n, -1, p)) % U64(p)


def decrypt(data: np.ndarray, primes: list[int], s: np.ndarray
            ) -> np.ndarray:
    """A ciphertext's data, uint32 [k, limbs, n] in the evaluation domain
    and Montgomery form on the first `limbs` primes, under secret s ->
    its message polynomial's coefficients, centered, as float64 [n]
    (exact integers mod the product of those primes)."""
    k, limbs, n = data.shape
    qs = primes[:limbs]
    residues = []
    for i, p in enumerate(qs):
        pp = U64(p)
        r_inv = U64(pow((1 << 32) % p, -1, p))
        s_eval = to_domain((s % p).astype(U64), p)
        acc = np.zeros(n, dtype=U64)
        s_pow = np.ones(n, dtype=U64)
        for c in range(k):
            acc = (acc + data[c, i].astype(U64) * r_inv % pp * s_pow) % pp
            s_pow = s_pow * s_eval % pp
        residues.append(from_domain(acc, p))
    Q = 1
    for p in qs:
        Q *= p
    x = np.zeros(n, dtype=object)
    for p, r in zip(qs, residues):
        Qi = Q // p
        x += (r.astype(object) * pow(Qi % p, -1, p) % p) * Qi
    x %= Q
    x = np.where(x > Q // 2, x - Q, x)
    return x.astype(np.float64)


def decode(coeffs: np.ndarray, scale: float, count: int) -> np.ndarray:
    """The first `count` slots of the polynomial `coeffs` (float64 [n])
    at `scale`: real parts of m(zeta^(5^j mod 2n)) / scale."""
    n = len(coeffs)
    G = np.fft.ifft(coeffs * np.exp(1j * np.pi * np.arange(n) / n)) * n
    e = np.array([pow(5, j, 2 * n) for j in range(count)])
    return np.real(G[(e - 1) // 2]) / scale


def sort_error(data: np.ndarray, scale: float, primes: list[int],
               s: np.ndarray, values: np.ndarray) -> float:
    """Largest absolute error of the decrypted first len(values) slots
    against the sorted values."""
    got = decode(decrypt(data, primes, s), scale, len(values))
    return float(np.abs(got - np.sort(values)).max())
