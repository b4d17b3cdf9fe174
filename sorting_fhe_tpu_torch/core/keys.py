"""Client-side key generation, encryption and decryption.

Counterpart of sorting_fhe_tpu/core/keys.py.  Sampling and decryption
are host numpy code, copied; the public key's and each encryption's NTTs
(one K1 call each) and the key-switching key assembly run on the params'
device through the port's NTT (K1 on a CUDA device), with the JAX
package's arithmetic.  Every draw from `np.random.default_rng` happens in
the same order as in the JAX package, so the same seed gives
bit-identical keys and ciphertexts.

Hybrid key-switching keys: the q-chain is split into `dnum` digits of
`alpha` primes; `alpha` special primes P extend the basis.  Key for secret
s' under s, digit j:

    ksk_j = (b_j, a_j),  b_j = -a_j s + e_j + P * W_j * s'  (mod QP)

with W_j = (Q/D_j) * [(Q/D_j)^{-1}]_{D_j} the CRT reconstruction weight of
digit j.  Keys are int32 [dnum, 2, num_rows, n] tensors in NTT + Montgomery
form, rows = q primes then special primes.

Two keygens share one per-digit assembly (`_ksk_digit`): `gen_ksk` draws
`a` and the errors on the host (the JAX package's draws, bit for bit), and
`gen_rotation_key_dev` draws them on the device from a generator seeded
per (cfg.seed, g, digit) (`_digit_seed`), so regenerating a key gives the
same bits and the rotation-key store can evict it (core/keystore.py).
The device draws are torch's, not `jax.random`'s: a device-PRNG key equals
the JAX package's only in what it decrypts, and a CPU key differs from a
CUDA key of the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nt
from .cuda_ntt import ntt_fwd
from .host_poly import (
    coeffs_to_rns, host_ntt, sample_ternary, sample_gaussian,
    rns_to_centered_bigint,
)
from .params import CkksParams
from .rns import mont_mul, add_mod, sub_mod

I32 = torch.int32
I64 = torch.int64
_M64 = (1 << 64) - 1


class _LazySNtt(dict):
    """Per-prime plain-domain NTT of the secret, computed on demand."""

    def __init__(self, coeffs: np.ndarray, n: int):
        super().__init__()
        self._coeffs = coeffs
        self._n = n

    def __missing__(self, p: int):
        r = (self._coeffs % p).astype(np.uint64)
        v = host_ntt(p, self._n).fwd(r)
        self[p] = v
        return v


class SecretKey:
    def __init__(self, params: CkksParams, rng: np.random.Generator):
        self.params = params
        self.s_coeffs = sample_ternary(params.n, rng, params.cfg.secret_hw)
        self.s_ntt = _LazySNtt(self.s_coeffs, params.n)


class KeyGenerator:
    """Generates all key material; holds the secret (client side only)."""

    def __init__(self, params: CkksParams, seed: int | None = None):
        self.params = params
        self.rng = np.random.default_rng(
            params.cfg.seed if seed is None else seed)
        self.sk = SecretKey(params, self.rng)
        self._pk = self._gen_public_key()

    # ---------------- public / encryption keys ----------------
    def _gen_public_key(self):
        """(b, a) as host uint64 [nq, n], b = -a*s + e in the plain NTT
        domain: the JAX package's draws and arithmetic, with the NTTs of s
        and e made in one K1 call on the params' device."""
        P = self.params
        n = P.n
        qs = P.q
        e = sample_gaussian(n, P.cfg.sigma, self.rng)
        a = np.stack([self.rng.integers(0, p, size=n, dtype=np.uint64)
                      for p in qs])                           # NTT domain
        p = _q_col(P)
        s_n, e_n = _ntt_prefix(_small_rows(np.stack([self.sk.s_coeffs, e]),
                                           P), P).to(I64)
        b = (p - _to_dev(a, P) * s_n % p + e_n) % p
        return b.cpu().numpy().astype(np.uint64), a

    # ---------------- key switching keys ----------------
    def _digit_indices(self) -> list[list[int]]:
        P = self.params
        nq = len(P.q)
        alpha = P.alpha
        return [list(range(j * alpha, min((j + 1) * alpha, nq)))
                for j in range(-(-nq // alpha))]

    def _ksk_weights(self) -> torch.Tensor:
        """P*W_j mod each row prime, int64 [dnum, nrows] on the device —
        independent of the switched secret s', cached across keys."""
        if hasattr(self, "_ksk_w_cache"):
            return self._ksk_w_cache
        P = self.params
        qs = P.q
        rows = qs + P.p_special
        Q = 1
        for q in qs:
            Q *= q
        digits = self._digit_indices()
        w = np.empty((len(digits), len(rows)), dtype=np.int64)
        for j, dig in enumerate(digits):
            Dj = 1
            for i in dig:
                Dj *= qs[i]
            Dhat = Q // Dj
            Wj = Dhat * nt.mod_inverse(Dhat % Dj, Dj)
            for r, p in enumerate(rows):
                w[j, r] = (P.P_int % p) * (Wj % p) % p
        self._ksk_w_cache = torch.from_numpy(w).to(P.device)
        return self._ksk_w_cache

    def _secret_ntt(self) -> torch.Tensor:
        """s in NTT + Montgomery form on every row, int32 [nrows, n] on
        the device, made once (the JAX package keeps its reduced s there)."""
        if not hasattr(self, "_s_ntt"):
            P = self.params
            s = torch.from_numpy(self.sk.s_coeffs.astype(np.int64)).to(
                P.device)
            self._s_ntt = _ntt_mont(s[None, :] % P.primes_dev[:, None], P)
        return self._s_ntt

    def _assemble(self, sp: torch.Tensor, draw) -> torch.Tensor:
        """The key for the int64 [n] secret sp (on the device), digit by
        digit: draw(j) -> (a_j int [nrows, n] uniform residues, e_j int
        [n] small signed error).  Only one digit's intermediates are live
        at a time."""
        P = self.params
        w = self._ksk_weights()
        s_ntt = self._secret_ntt()
        sp_ntt = _ntt_mont(sp[None, :] % P.primes_dev[:, None], P)
        out = torch.empty((w.shape[0], 2, len(P.all_primes), P.n),
                          dtype=I32, device=P.device)
        for j in range(w.shape[0]):
            out[j] = _ksk_digit(s_ntt, sp_ntt, *draw(j), w[j], P)
        return out

    def gen_ksk(self, s_prime_coeffs: np.ndarray) -> torch.Tensor:
        """Key switching key for s' -> s: int32 [dnum, 2, nq + nsp, n],
        NTT+Montgomery domain, assembled on the params' device.  Only the
        uniform `a` and the small error polynomials are drawn on the host
        (same order as the JAX package)."""
        P = self.params
        n = P.n
        rows = P.q + P.p_special
        dnum = len(self._digit_indices())
        dev = P.device

        # uniform a (Montgomery-domain uniform == uniform)
        a_all = np.empty((dnum, len(rows), n), dtype=np.uint32)
        for r, pr in enumerate(rows):
            a_all[:, r, :] = self.rng.integers(
                0, pr, size=(dnum, n), dtype=np.uint64).astype(np.uint32)
        e_all = np.stack([sample_gaussian(n, P.cfg.sigma, self.rng)
                          for _ in range(dnum)])       # [dnum, n] signed

        sp = torch.from_numpy(np.asarray(s_prime_coeffs, dtype=np.int64))
        return self._assemble(sp.to(dev), lambda j: (
            torch.from_numpy(a_all[j].view(np.int32)).to(dev),
            torch.from_numpy(e_all[j]).to(dev)))

    def gen_rotation_key_dev(self, g: int) -> torch.Tensor:
        """Galois key for element g with `a` and the errors drawn on the
        params' device (`_device_draw`): the same (cfg.seed, g) gives the
        same bits every time, so the key store may drop the key and make
        it again.  Only the rotated secret ([n], small) crosses from the
        host.  cfg.seed is also the secret's seed (`KeyGenerator`): a
        client that streams keys keeps it as secret as the key."""
        from .encoding import automorphism_index_table
        P = self.params
        src, sign = automorphism_index_table(P.n, g)
        s_rot = torch.from_numpy(
            (sign * self.sk.s_coeffs[src]).astype(np.int64)).to(P.device)
        return self._assemble(
            s_rot, lambda j: _device_draw(P, _digit_seed(P.cfg.seed, g, j)))

    def gen_relin_key(self) -> torch.Tensor:
        # s^2 mod (X^n + 1) has coefficients bounded by n < p/2, so a single
        # NTT prime recovers them exactly via centered lift.
        s2 = _negacyclic_square_int(self.sk.s_coeffs, self.params.q[0],
                                    self.params.n)
        return self.gen_ksk(s2)

    def gen_rotation_key(self, g: int) -> torch.Tensor:
        """Galois key for element g (sigma_g(s) -> s)."""
        from .encoding import automorphism_index_table
        src, sign = automorphism_index_table(self.params.n, g)
        s_rot = sign * self.sk.s_coeffs[src]
        return self.gen_ksk(s_rot)

    @property
    def public_key(self):
        return self._pk


def _negacyclic_square_int(s: np.ndarray, p: int, n: int) -> np.ndarray:
    """Exact s*s mod (X^n+1) for ternary s via one NTT prime + centered lift
    (coefficients are bounded by n << p/2)."""
    hp = host_ntt(p, n)
    sn = hp.fwd((s % p).astype(np.uint64))
    s2 = hp.inv(sn * sn % p).astype(np.int64)
    return np.where(s2 > p // 2, s2 - p, s2)


def _q_col(P: CkksParams) -> torch.Tensor:
    """The q primes, int64 [nq, 1] on the params' device."""
    return P.primes_dev[:P.nq].reshape(-1, 1)


def _to_dev(x: np.ndarray, P: CkksParams) -> torch.Tensor:
    """Host residues below 2^63 (uint64 or int64) -> int64 on the device."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64)).to(
        P.device)


def _small_rows(small: np.ndarray, P: CkksParams) -> torch.Tensor:
    """Host int64 [k, n] small signed polynomials -> their residues on
    every q row, int64 [k, nq, n] on the device."""
    return _to_dev(small, P)[:, None, :] % _q_col(P)


def _ntt_prefix(x: torch.Tensor, P: CkksParams) -> torch.Tensor:
    """Residues int [..., r, n] of the chain's first r rows -> their
    NTTs, int32, in one K1 call (its plain version on the CPU); the bits
    of the host NTT (host_poly.HostNtt) of each row."""
    rows = torch.arange(x.shape[-2], dtype=I32, device=P.device)
    return ntt_fwd(x.to(I32).contiguous(), P.ntt, rows)


def _ntt_mont(x: torch.Tensor, P: CkksParams) -> torch.Tensor:
    """Plain residues int64 [nrows, n], one row per chain prime -> NTT +
    Montgomery form, int32, through K1 (its plain version on the CPU)."""
    p = P.primes_dev.reshape(-1, 1)
    return _ntt_prefix(x * ((1 << 32) % p) % p, P)


def _ksk_digit(s_ntt, sp_ntt, a_j, e_j, w_j, P: CkksParams) -> torch.Tensor:
    """Digit j of a key-switching key: int32 [2, nrows, n] = (b_j, a_j),
    b_j = e_j - a_j*s + P*W_j*s' in NTT + Montgomery form.

    s_ntt/sp_ntt: int [nrows, n], s and s' in NTT + Montgomery form; a_j:
    int [nrows, n] uniform residues (taken as Montgomery form, still
    uniform); e_j: int [n] signed error, reduced and transformed here;
    w_j: int64 [nrows], P*W_j mod each row prime.  Digit j of the JAX
    package's keys.py:_ksk_kernel_body, which computes every digit at
    once with Shoup pairs for the constants."""
    p = P.primes_dev.reshape(-1, 1)
    e_ntt = _ntt_mont(e_j.to(I64)[None, :] % p, P)
    term = sp_ntt.to(I64) * w_j.reshape(-1, 1) % p
    asl = mont_mul(a_j, s_ntt, p, P.mont_r_inv.reshape(-1, 1))
    b = add_mod(sub_mod(e_ntt, asl, p), term, p)
    return torch.stack([b.to(I32), a_j.to(I32)])


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _digit_seed(seed: int, g: int, j: int) -> int:
    """The device generator's seed for digit j of the key of Galois
    element g: splitmix64 chained over seed ^ 0x5EED (the JAX package's
    PRNGKey(seed ^ 0x5EED)), then g, then j, cut to 63 bits."""
    x = _splitmix64((seed ^ 0x5EED) & _M64)
    x = _splitmix64(x ^ g)
    return _splitmix64(x ^ j) >> 1


def _device_draw(P: CkksParams, seed: int) -> tuple:
    """One digit's draws on the params' device from a fresh generator
    seeded with `seed`, in this order and at these sizes: a uniform in
    [0, 2^62) reduced mod each row's prime (bias below 2^-31; torch's
    randint takes no per-row bound), int64 [nrows, n]; then the error
    round(N(0, 1) * sigma) in float32, int64 [n]."""
    gen = torch.Generator(device=P.device)
    gen.manual_seed(seed)
    a = torch.randint(0, 1 << 62, (len(P.all_primes), P.n), generator=gen,
                      dtype=I64, device=P.device)
    a %= P.primes_dev.reshape(-1, 1)
    e = torch.randn(P.n, generator=gen, dtype=torch.float32,
                    device=P.device)
    return a, torch.round(e * P.cfg.sigma).to(I64)


class Encryptor:
    """Public-key encryptor: host draws, the NTTs and products on the
    params' device."""

    def __init__(self, params: CkksParams, public_key, rng=None):
        self.params = params
        self.pk = public_key
        self.rng = rng or np.random.default_rng(params.cfg.seed + 1)

    def encrypt_coeffs(self, coeffs: np.ndarray) -> torch.Tensor:
        """Integer coefficient poly (float64 or object) -> int32 [2, nq, n]
        NTT+Montgomery ciphertext data at full level, on the params'
        device.  The JAX package's draws and arithmetic; the NTTs of u,
        e0, e1 and the message on every q row are one K1 call."""
        P = self.params
        n = P.n
        b, a = self.pk
        u = sample_ternary(n, self.rng)
        e0 = sample_gaussian(n, P.cfg.sigma, self.rng)
        e1 = sample_gaussian(n, P.cfg.sigma, self.rng)
        p = _q_col(P)
        un, e0n, e1n, mn = _ntt_prefix(torch.cat([
            _small_rows(np.stack([u, e0, e1]), P),
            _to_dev(coeffs_to_rns(coeffs, P.q), P)[None]]), P).to(I64)
        c0 = (_to_dev(b, P) * un + e0n + mn) % p
        c1 = (_to_dev(a, P) * un + e1n) % p
        return (torch.stack([c0, c1]) * ((1 << 32) % p) % p).to(I32)


class Decryptor:
    """Secret-key decryptor (host side, client/debug only)."""

    def __init__(self, params: CkksParams, sk: SecretKey):
        self.params = params
        self.sk = sk

    def decrypt_to_coeffs(self, data: np.ndarray, num_limbs: int,
                          max_limbs: int = 3) -> np.ndarray:
        """[>=2, limbs, n] u32 NTT+Mont ciphertext -> centered big-int
        coefficient array (object dtype).  Uses only the first
        min(num_limbs, max_limbs) limbs (mod-reduction is free)."""
        P = self.params
        n = P.n
        use = min(num_limbs, max_limbs)
        limbs = np.empty((use, n), dtype=np.uint64)
        k = data.shape[0]
        for i in range(use):
            p = P.q[i]
            hp = host_ntt(p, n)
            rinv = nt.mod_inverse((1 << 32) % p, p)
            acc = data[0, i].astype(np.uint64) * rinv % p
            spow = self.sk.s_ntt[p]
            si = spow.copy()
            for comp in range(1, k):
                ci = data[comp, i].astype(np.uint64) * rinv % p
                acc = (acc + ci * si) % p
                if comp + 1 < k:
                    si = si * spow % p
            limbs[i] = hp.inv(acc)
        return rns_to_centered_bigint(limbs, P.q[:use])
