"""Host-side (client-side) polynomial arithmetic in numpy uint64.

The FHE protocol splits into a client (key generation, encode, encrypt,
decrypt — holds the secret key) and a server (blind homomorphic evaluation
on the device).  This module is the client's math: plain numpy, exact u64 modular
arithmetic (products of <2^31 values fit in u64).  It mirrors the device NTT
in ntt.py (same twiddle layout) so host- and device-generated polynomials
interoperate bit-exactly.

Reference analogue: OpenFHE's client-side key/encrypt path used by
reference/src/encryption.cpp:5-33 and tests' KeyGen/Encrypt setup.
"""

from __future__ import annotations

import numpy as np

from . import nt


class HostNtt:
    """Numpy negacyclic NTT for one prime (same ordering as device NTT)."""

    def __init__(self, p: int, n: int):
        self.p = p
        self.n = n
        tb = nt.make_ntt_tables(p, n)
        self.psi = tb["psi_brv"].astype(np.uint64)
        self.ipsi = tb["ipsi_brv"].astype(np.uint64)
        self.n_inv = int(tb["n_inv"])

    def fwd(self, a: np.ndarray) -> np.ndarray:
        p = self.p
        n = self.n
        a = a.astype(np.uint64) % p
        for s in range(n.bit_length() - 1):
            m = 1 << s
            t = n >> (s + 1)
            a = a.reshape(m, 2, t)
            w = self.psi[m:2 * m, None]
            u = a[:, 0, :]
            v = a[:, 1, :] * w % p
            a = np.stack([(u + v) % p, (u + p - v) % p], axis=1)
        return a.reshape(n)

    def inv(self, a: np.ndarray) -> np.ndarray:
        p = self.p
        n = self.n
        a = a.astype(np.uint64) % p
        for s in range(n.bit_length() - 1):
            h = n >> (s + 1)
            t = n // (2 * h)
            a = a.reshape(h, 2, t)
            w = self.ipsi[h:2 * h, None]
            u = a[:, 0, :]
            v = a[:, 1, :]
            lo = (u + v) % p
            hi = (u + p - v) % p * w % p
            a = np.stack([lo, hi], axis=1)
        return a.reshape(n) * np.uint64(self.n_inv) % p


_host_ntt_cache: dict[tuple[int, int], HostNtt] = {}


def host_ntt(p: int, n: int) -> HostNtt:
    key = (p, n)
    if key not in _host_ntt_cache:
        _host_ntt_cache[key] = HostNtt(p, n)
    return _host_ntt_cache[key]


def coeffs_to_rns(coeffs: np.ndarray, primes: list[int]) -> np.ndarray:
    """Signed integer coefficients (float64 or object ints) -> [L, n] u64.

    float64 inputs are reduced exactly via fmod (IEEE fmod is exact); object
    (python int) inputs via %.
    """
    L = len(primes)
    n = len(coeffs)
    out = np.empty((L, n), dtype=np.uint64)
    if coeffs.dtype == object:
        for i, p in enumerate(primes):
            out[i] = (coeffs % p).astype(np.uint64)
    else:
        for i, p in enumerate(primes):
            r = np.fmod(coeffs, float(p))
            r = np.where(r < 0, r + p, r)
            out[i] = r.astype(np.uint64)
    return out


def rns_to_centered_bigint(limbs: np.ndarray, primes: list[int]) -> np.ndarray:
    """[L, n] residues -> object array of centered integers in (-Q/2, Q/2]."""
    L = len(primes)
    Q = 1
    for p in primes:
        Q *= p
    acc = np.zeros(limbs.shape[-1], dtype=object)
    for i in range(L):
        qi = primes[i]
        Qi = Q // qi
        ci = nt.mod_inverse(Qi % qi, qi)
        acc += (limbs[i].astype(object) * ci % qi) * Qi
    acc %= Q
    return np.where(acc > Q // 2, acc - Q, acc)


def sample_ternary(n: int, rng: np.random.Generator,
                   hw: int | None = None) -> np.ndarray:
    """Ternary secret in {-1, 0, 1}.

    hw=None: uniform ternary (OpenFHE UNIFORM_TERNARY).
    hw=h:    sparse ternary with exactly h nonzeros (OpenFHE SPARSE_TERNARY)
             — required by bootstrapping, where the mod-raise integer I is
             bounded by the secret's Hamming weight (core/bootstrap.py)."""
    if hw is None:
        return rng.integers(-1, 2, size=n).astype(np.int64)
    s = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=hw, replace=False)
    s[idx] = rng.choice(np.array([-1, 1], dtype=np.int64), size=hw)
    return s


def sample_gaussian(n: int, sigma: float, rng: np.random.Generator) -> np.ndarray:
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def sample_uniform_rns(primes: list[int], n: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Uniform element of R_Q given directly as [L, n] residues (NTT-domain
    uniform is fine since NTT is a bijection)."""
    return np.stack([
        rng.integers(0, p, size=n, dtype=np.uint64) for p in primes])


def signed_to_rns(x: np.ndarray, primes: list[int]) -> np.ndarray:
    """Small signed integer polynomial -> [L, n] u64 residues."""
    return np.stack([(x.astype(object) % p).astype(np.uint64) for p in primes])
