"""CKKS canonical-embedding encode/decode (host-side, numpy float64).

Implements the equivalent of OpenFHE's MakeCKKSPackedPlaintext / plaintext
decode used throughout the reference (e.g. reference/src/sort_algo.h:
317,341,527 and encryption.cpp:5-33), including the `slots` semantics of
SetSlots: a vector of s <= n/2 slots is encoded replicated n/(2s) times, and
"reinterpreting" a ciphertext at a different slot count is pure metadata (the
underlying polynomial is unchanged).

The embedding uses the 5^j slot orbit: slot_j = m(zeta^{5^j mod 2n}) with
zeta = exp(i*pi/n).  Encode/decode are O(n log n) via a length-n FFT after
twisting by zeta^i.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _pow5_exponents(n: int) -> np.ndarray:
    """e_j = 5^j mod 2n for j in [0, n/2)."""
    m = 2 * n
    out = np.empty(n // 2, dtype=np.int64)
    x = 1
    for j in range(n // 2):
        out[j] = x
        x = x * 5 % m
    return out


@lru_cache(maxsize=None)
def _twist(n: int) -> np.ndarray:
    """zeta^i for i in [0, n), zeta = exp(i*pi/n)."""
    return np.exp(1j * np.pi * np.arange(n) / n)


def encode_real(values: np.ndarray, n: int, scale: float,
                slots: int | None = None) -> np.ndarray:
    """Real or complex vector -> integer coefficient polynomial (float64).

    values: length <= slots (zero padded); replicated to fill n/2 slots.
    Returns rounded signed coefficients at the given scale.  Complex slot
    vectors are supported (the coefficient polynomial is always real):
    bootstrapping's CoeffsToSlots matrices are complex (core/bootstrap.py).
    """
    half = n // 2
    slots = slots or half
    assert half % slots == 0, (slots, half)
    v = np.zeros(slots, dtype=np.complex128)
    vals = np.asarray(values)
    assert len(vals) <= slots, (len(vals), slots)
    v[:len(vals)] = vals
    full = np.tile(v, half // slots)

    e = _pow5_exponents(n)
    # spectrum G over the n odd exponents: index k holds exponent 2k+1
    G = np.zeros(n, dtype=np.complex128)
    G[(e - 1) // 2] = full
    G[(2 * n - e - 1) // 2] = np.conj(full)
    t = np.fft.fft(G) / n
    coeffs = np.real(t * np.conj(_twist(n)))
    return np.rint(coeffs * scale)


def decode_real(coeffs: np.ndarray, n: int, scale: float,
                slots: int | None = None,
                complex_out: bool = False) -> np.ndarray:
    """Integer/float coefficient polynomial -> real slot values.

    Decodes the full n/2 slots and returns the first `slots` entries (the
    SetSlots(s) view of a periodic plaintext).  complex_out keeps the
    imaginary parts (bootstrap intermediates are complex-valued).
    """
    half = n // 2
    slots = slots or half
    t = np.asarray(coeffs, dtype=np.float64) * _twist(n)
    G = np.fft.ifft(t) * n
    e = _pow5_exponents(n)
    full = G[(e - 1) // 2]
    if complex_out:
        return full[:slots] / scale
    return np.real(full[:slots]) / scale


def rotate_slots_reference(values: np.ndarray, k: int) -> np.ndarray:
    """Plaintext model of EvalRotate(ct, k): left rotation by k slots
    (index i takes the value previously at i+k), matching OpenFHE and the
    reference's np.roll(x, -k) oracle (scripts/direct_sort_rank.py)."""
    return np.roll(values, -k)


@lru_cache(maxsize=None)
def galois_element_for_rotation(n: int, k: int) -> int:
    """Galois element g with sigma_g(X) = X^g realizing a left-rotation by k
    slots in the canonical embedding (power-of-two cyclotomic, M = 2n)."""
    m = 2 * n
    return pow(5, k % (n // 2), m)


CONJ_GALOIS = -1  # sigma_{2n-1} realizes complex conjugation of slots


@lru_cache(maxsize=None)
def automorphism_index_table(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient-domain automorphism sigma_g: out[i*g mod stuff].

    Returns (src_index, sign) arrays such that
    (sigma_g a)[j] = sign[j] * a[src_index[j]] for X -> X^g on R = Z[X]/(X^n+1).
    """
    m = 2 * n
    g = g % m
    src = np.empty(n, dtype=np.int64)
    sign = np.empty(n, dtype=np.int64)
    # sigma_g maps a_i X^i -> a_i X^{i g mod m}, X^{n+k} = -X^k
    # build inverse map: output coeff j gets a_i where i*g ≡ j (mod m) or
    # i*g ≡ j + n (mod m) with sign -1.
    ginv = pow(g, -1, m)
    for j in range(n):
        i = j * ginv % m
        if i < n:
            src[j] = i
            sign[j] = 1
        else:
            src[j] = i - n
            sign[j] = -1
    return src, sign


@lru_cache(maxsize=None)
def ntt_domain_exponents(n: int) -> np.ndarray:
    """exp_tab[j] = e such that NTT output slot j (bit-reversed CT order)
    holds f(psi^e), psi a primitive 2n-th root.

    For the Longa–Naehrig iterative CT NTT with bit-reversed twiddles the
    output ordering is: slot j holds f(psi^{2*brv(j)+1}) where brv is the
    log2(n)-bit reversal.  Checked against a direct polynomial evaluation
    in tests/test_encoding.py::test_ntt_domain_exponent_convention.
    """
    from .nt import bit_reverse_indices
    rev = bit_reverse_indices(n)
    return (2 * rev + 1).astype(np.int64)


@lru_cache(maxsize=None)
def automorphism_eval_perm(n: int, g: int) -> np.ndarray:
    """Permutation perm such that, for NTT-domain values v (our bit-reversed
    ordering), the NTT of sigma_g(a) equals v[perm].

    (sigma_g f)(psi^e) = f(psi^{e g}).  Slot j of the output needs
    f(psi^{exp[j] * g}), i.e. the input slot holding that exponent.
    """
    m = 2 * n
    exps = ntt_domain_exponents(n)
    # map exponent -> slot index
    slot_of_exp = np.full(m, -1, dtype=np.int64)
    slot_of_exp[exps] = np.arange(n)
    perm = slot_of_exp[exps * (g % m) % m]
    assert (perm >= 0).all()
    return perm
