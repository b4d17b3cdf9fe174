"""CKKS crypto parameters and precomputed RNS tables.

One `CkksParams` object plays the role of OpenFHE's CryptoContext parameter
block for the reference (reference/src/sort_algo.h:87-201 sets
multiplicative depth / scaling mod size / batch size; OpenFHE derives the
prime chain).  Here we generate the chain ourselves:

* q_0 .. q_L        "ciphertext" primes: q_0 is the large base prime
                    (decryption headroom), q_1..q_L are rescaling primes
                    close to 2^scale_bits.
* p_0 .. p_{k-1}    special primes for hybrid key switching.

All primes are NTT-friendly (≡ 1 mod 2n) and < 2^31 so residues fit 32
bits (see rns.py).  The prime chain, special primes, canonical scales and
Montgomery constants are identical to sorting_fhe_tpu/core/params.py; the
port only adds `device` (where the NTT tables and constant vectors live)
and `mont_r_inv`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import nt
from .device import resolve_device
from .ntt import NttContext


@dataclass(frozen=True)
class CkksConfig:
    """User-facing knobs, analogous to CCParams<CryptoContextCKKSRNS>.

    `scale_bits` is the TOTAL log2 of the scaling factor Delta per
    multiplicative level; `comp` primes of ~scale_bits/comp bits realise it
    (composite scaling — the uint32-RNS answer to OpenFHE's 40-60 bit
    primes: a deep-precision level is a *pair* of ~26-bit primes dropped
    together at rescale).

    Fields that only steer the JAX package's compilation are kept so a
    config means the same in both packages, and ignored here:
    `ntt_backend` (this package dispatches on the tensor's device) and
    `limb_pad` (eager torch has no per-shape compile, so every op runs at
    the exact limb count).
    """
    ring_dim: int = 1 << 13
    mult_depth: int = 10
    scale_bits: int = 29          # total log2(Delta) per level
    comp: int = 1                 # primes per level (composite degree)
    base_mod_bits: int = 30       # size of each base ("first modulus") prime
    dnum: int = 3                 # hybrid key-switch digit count
    num_special_primes: int | None = None  # default: ceil(nq/dnum)
    # rotation-key device budget (MB): None keeps every generated key
    # resident (dict semantics, unless SORTING_FHE_KEY_BUDGET_MB is set);
    # a budget streams the keys (core/keystore.py), 0 with no cap
    rot_key_budget_mb: int | None = None
    seed: int = 2024
    sigma: float = 3.19           # error stddev
    batch_size: int | None = None  # default n/2 slots
    # JAX package's NTT backend choice; ignored here (see docstring)
    ntt_backend: str = "auto"
    # secret key Hamming weight: None = uniform ternary; an int enables the
    # sparse-ternary secret bootstrapping needs (core/bootstrap.py)
    secret_hw: int | None = None
    # JAX package's limb-count bucketing (pads towers to a multiple of
    # limb_pad rows); ignored here, every op runs at the exact limb count
    limb_pad: int = 1


class CkksParams:
    """Derived parameter set + device-resident tables."""

    def __init__(self, cfg: CkksConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        n = cfg.ring_dim
        self.n = n
        self.num_slots = cfg.batch_size or (n // 2)
        L = cfg.mult_depth          # number of rescaling primes
        self.L = L

        # prime chain: base primes (decryption floor able to hold
        # max_value * Delta), then L levels of `comp` rescaling primes each,
        # chosen adaptively (per-level product nearest S^2/Delta walking down
        # from the top) so the canonical scale stays anchored at Delta —
        # without this, scale deviation doubles every level and adds break.
        comp = cfg.comp
        self.comp = comp
        self.base_limbs = max(2, -(-(cfg.scale_bits + 20) // cfg.base_mod_bits))
        base = nt.find_ntt_primes(cfg.base_mod_bits, self.base_limbs, n)
        delta = float(2 ** cfg.scale_bits)
        avoid = set(base)
        qs_rev = []  # built top-down: first entries dropped first
        S = delta
        if comp == 2:
            # Pool-based PAIR picker.  Balanced sub_bits pairs exhaust the
            # sparse mid-size NTT primes on deep chains (at ring 2^17 only
            # ~10 26-bit primes exist) and the ladder recursion
            # S' = S^2/prod then diverges double-exponentially.  Instead
            # pick, per level, the remaining-pool PAIR whose product is
            # nearest S^2/Delta — unbalanced splits like 29+27 tap the
            # dense top of the pool and keep |log2(S/Delta)| ~ 2^-10
            # down the whole chain.
            # Vectorised over the pool (a Python loop over it takes tens
            # of seconds at small rings); the same float64 arithmetic and
            # the same first-minimum tie-break as the JAX package's loop
            # (for p1 ascending, for p2 at bisect - 1, bisect, bisect + 1:
            # keep a pair only if strictly nearer), so the same chain.
            pool = np.array([p for p in nt.ntt_prime_pool(n)
                             if p not in avoid], dtype=np.int64)
            logs = np.array([math.log2(p) for p in pool.tolist()])
            steps = np.array([-1, 0, 1])
            for _ in range(L):
                target = S * S / delta
                lt = math.log2(target)
                ideal = target / pool.astype(np.float64)
                # p1 ascending: past the first too-small ideal, all are
                live = ideal >= pool[0] * 0.5
                stop = len(pool) if live.all() else int(np.argmin(live))
                ideal = ideal[:stop]
                fits = ideal < (1 << 31)
                j = np.searchsorted(pool, np.floor(np.where(fits, ideal, 0))
                                    .astype(np.int64), side="left")
                cand = j[:, None] + steps                   # [stop, 3]
                valid = (fits[:, None] & (cand >= 0) & (cand < len(pool))
                         & (cand != np.arange(stop)[:, None]))
                cand = np.clip(cand, 0, len(pool) - 1)
                err = np.where(valid, np.abs(logs[:stop, None] + logs[cand]
                                             - lt), np.inf)
                k = int(np.argmin(err)) if err.size else 0
                assert err.size and np.isfinite(err.flat[k]), \
                    "NTT prime pool exhausted"
                i1, i2 = divmod(k, 3)
                i2 = int(cand[i1, i2])
                p1, p2 = int(pool[i1]), int(pool[i2])
                pool = np.delete(pool, [i1, i2])
                logs = np.delete(logs, [i1, i2])
                # smaller prime drops second (order within level arbitrary)
                level_primes = sorted((p1, p2), reverse=True)
                S = S * S / (float(p1) * float(p2))
                qs_rev.extend(level_primes)
        else:
            sub_bits = cfg.scale_bits / comp
            for _ in range(L):
                target = S * S / delta      # product this level must hit
                level_primes = []
                for j in range(comp):
                    if j < comp - 1:
                        p = nt.nearest_ntt_prime(2.0 ** sub_bits, n, avoid)
                    else:
                        rem = target
                        for pp in level_primes:
                            rem /= pp
                        p = nt.nearest_ntt_prime(rem, n, avoid)
                    avoid.add(p)
                    level_primes.append(p)
                prod = 1.0
                for pp in level_primes:
                    prod *= pp
                S = S * S / prod
                # drop order within the level is arbitrary; append in order
                qs_rev.extend(level_primes)
        self.q: list[int] = base + qs_rev[::-1]
        self.nq = len(self.q)

        alpha = -(-self.nq // cfg.dnum)      # limbs per digit
        k = cfg.num_special_primes or alpha
        self.alpha = alpha
        self.num_special = k
        # special primes: as large as possible (< 2^31) to minimize their
        # count's noise contribution
        self.p_special: list[int] = nt.find_ntt_primes(
            30, k, n, avoid=tuple(self.q))

        self.all_primes: list[int] = self.q + self.p_special
        self.ntt = NttContext(self.all_primes, n, self.device)

        # Montgomery constants per prime [num_primes].  mont_neg_p_inv is
        # the JAX package's REDC constant (uint32 bits in int32), kept for
        # parity; the int64 arithmetic here uses mont_r_inv = 2^-32 mod p.
        mont = [nt.montgomery_constants(p) for p in self.all_primes]
        self.mont_neg_p_inv = torch.from_numpy(np.array(
            [m["neg_p_inv"] for m in mont], dtype=np.uint32).view(np.int32)
        ).to(self.device)
        self.mont_r_inv = torch.tensor(
            [nt.mod_inverse((1 << 32) % p, p) for p in self.all_primes],
            dtype=torch.int64, device=self.device)
        self.primes_dev = torch.tensor(self.all_primes, dtype=torch.int64,
                                       device=self.device)

        # P = product of the special primes, for ModDown and KSK assembly
        P = 1
        for p in self.p_special:
            P *= p
        self.P_int = P

        # canonical scaling factors per level-boundary limb count
        # (FLEXIBLEAUTO-style): fresh ciphertexts live at nq limbs with
        # scale Delta; a (composite) rescale drops `comp` primes and the
        # canonical scale one level down is S' = S^2 / prod(dropped).
        S = {self.nq: delta}
        limbs = self.nq
        while limbs > self.base_limbs:
            prod = 1.0
            for i in range(limbs - comp, limbs):
                prod *= float(self.q[i])
            S[limbs - comp] = S[limbs] * S[limbs] / prod
            limbs -= comp
        self.canonical_scale = S

    # ---- host-side helpers ----
    def q_product(self, num_limbs: int) -> int:
        """Product of the first num_limbs q primes."""
        out = 1
        for i in range(num_limbs):
            out *= self.q[i]
        return out

    def describe(self) -> str:
        return (f"CKKS n=2^{self.n.bit_length()-1} L={self.L} "
                f"scale=2^{self.cfg.scale_bits} dnum={self.cfg.dnum} "
                f"|q|={len(self.q)} |p|={len(self.p_special)} "
                f"logQP={sum(p.bit_length() for p in self.all_primes)}")
