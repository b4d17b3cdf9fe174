"""CKKS bootstrapping (EvalBootstrap): mod-raise -> subring trace ->
CoeffsToSlots -> EvalMod (periodic sine) -> SlotsToCoeffs.

Counterpart of sorting_fhe_tpu/core/bootstrap.py.  The reference consumes
OpenFHE's EvalBootstrap in three places: BitonicSort boots when the level
runs out (sort_algo.h:1436-1438), the k-way network boots between stages
(k-way/EvalUtils.cpp:57-94), and compositeSign lazily boots between f/g
iterations (sign.cpp:160-185).  This module drives the context API only,
as the JAX module does, so the same calls give the same bits, except where
mod_raise's float32 correction count rounds the other way (core/ckks.py),
and it runs unchanged on a row-sharded context (parallel/evaluator.py).
The port adds the host-clock time of each phase of the last bootstrap
(`Bootstrapper.phase_s`) and `BootstrapHook.setup`, which builds a slot
width's Bootstrapper and its keys ahead of the first call.

Design (slot counts are the array size N <= 2048 rather than the full
ring):

* ModRaise: centered CRT lift of the base-modulus ciphertext to the full
  chain (ckks.mod_raise); decrypts to c + D*I with |I| <~ sqrt(hw).
* Subring trace: for sparsely packed ciphertexts (slots < n/2) the raised
  ciphertext is projected onto the 4s-th cyclotomic subring by summing the
  log2(n/2/slots) automorphisms sigma_{5^(k*s)} (raw rotations by k*slots:
  the message is period-invariant, the error is dense).  After the trace
  the whole pipeline is a 2s-dimensional CKKS instance.
* CoeffsToSlots / SlotsToCoeffs: ONE dense homomorphic linear transform
  each (BSGS baby-step/giant-step, hoisted rotations).  The subring
  embedding matrix E[j,i] = w^(5^j * i) (w a primitive 4s-th root) has the
  identity E[:, s:] = i * E[:, :s], so slots u = a_lo + i*a_hi satisfy
  z = E_lo u: C2S is inv(E_lo), S2C is E_lo, no conjugation inside the
  transform.  A dense transform costs ONE level.
* Real/imag split via conjugation + multiplication by the monomial
  X^{n/2} (slot-wise i; depth- and noise-free).
* EvalMod: Chebyshev series of (D / (2 pi Delta)) * sin(2 pi K x) on
  [-1, 1] via Paterson-Stockmeyer; K covers |I| <= K - 1 for the sparse
  secret (cfg.secret_hw, 64 -> K = 27).

Public surface mirrors OpenFHE: EvalBootstrapSetup = Bootstrapper(...),
EvalBootstrapKeyGen = .setup_keys(), EvalBootstrap = .bootstrap(ct).
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np

from .ckks import CkksContext, Ciphertext
from .poly_eval import eval_chebyshev_series_ps, chebyshev_coefficients

# Bootstrapper.phase_s keys, in the order the phases run
PHASES = ("raise", "trace", "coeffs_to_slots", "eval_mod",
          "slots_to_coeffs")


def default_K(hw: int | None) -> int:
    """Sine range: covers the mod-raise integer I (std ~ sqrt(hw/12))."""
    if hw is None:
        raise ValueError(
            "bootstrapping requires a sparse-ternary secret: set "
            "CkksConfig.secret_hw (e.g. 64); a uniform ternary secret's "
            "mod-raise error exceeds any practical sine range")
    return max(12, int(np.ceil(np.sqrt(hw / 12.0) * 10)) + 3)


def _sine_degree(K: int, tol: float = 2.0 ** -34) -> int:
    """Smallest tested Chebyshev degree fitting sin(2 pi K x) to tol."""
    f = lambda x: np.sin(2 * np.pi * K * x)
    deg = 64
    while deg <= 4096:
        c = chebyshev_coefficients(f, -1.0, 1.0, deg)
        xs = np.linspace(-1.0, 1.0, 4001)
        approx = np.polynomial.chebyshev.chebval(xs, c)
        if np.abs(approx - f(xs)).max() < tol:
            return deg
        deg *= 2
    return 4096


class Bootstrapper:
    """EvalBootstrap for ciphertexts packed at a fixed slot count."""

    def __init__(self, ctx: CkksContext, slots: int,
                 K: int | None = None, margin_bits: int = 6):
        self.ctx = ctx
        self.slots = slots
        n = ctx.n
        half = n // 2
        assert half % slots == 0 and slots >= 1
        self.r = half // slots
        self.K = K if K is not None else default_K(ctx.cfg.secret_hw)

        # Raise modulus: the smallest prefix of the chain that still holds
        # the message (scale_bits + margin).  Kept as small as possible:
        # EvalMod's output error is ~ (q0/Delta) * K * ctnoise, so every
        # extra bit of q0/Delta costs a bit of bootstrap precision.
        P = ctx.params
        l = 2
        while (np.log2(float(P.q_product(l)))
               < ctx.cfg.scale_bits + margin_bits):
            l += 1
        self.raise_limbs = l
        self.margin_bits = margin_bits

        # ---- host: subring embedding matrix and its inverse ----
        s = slots
        m4 = 4 * s
        f = np.empty(s, dtype=np.int64)
        x = 1
        for j in range(s):
            f[j] = x
            x = x * 5 % m4
        w = np.exp(2j * np.pi / m4)
        E_lo = w ** (f[:, None] * np.arange(s)[None, :] % m4)
        self._E_lo = E_lo
        self._M_dec = np.linalg.inv(E_lo)

        # BSGS split shared by both transforms
        G = 1 << int(np.ceil(np.log2(max(1.0, np.sqrt(s)))))
        self.G = min(G, s)
        self.n_giant = -(-s // self.G)

        # sine polynomial (per input-scale cache)
        self._sine_deg = _sine_degree(self.K)
        self._sine_cache: dict[float, np.ndarray] = {}
        self._q0 = float(ctx.params.q_product(self.raise_limbs))
        # host-clock seconds of each phase (PHASES) of the last bootstrap,
        # the device synchronised at each boundary
        self.phase_s: dict[str, float] = {}

    # ------------------------------------------------------------------
    def rotation_indices(self) -> list[int]:
        s = self.slots
        idx = list(range(1, self.G))
        idx += [g * self.G for g in range(1, self.n_giant)]
        j = 0
        while (1 << j) < self.r:
            idx.append(s << j)
            j += 1
        return sorted({i for i in idx if i})

    def setup_keys(self):
        """EvalBootstrapKeyGen: BSGS + trace rotation keys, conj key."""
        self.ctx.gen_rotation_keys(self.rotation_indices())
        self.ctx.gen_conj_key()
        return self

    # ------------------------------------------------------------------
    def _diags(self, M: np.ndarray) -> dict[int, np.ndarray]:
        s = self.slots
        out = {}
        jj = np.arange(s)
        for d in range(s):
            v = M[jj, (jj + d) % s]
            if np.abs(v).max() > 1e-14:
                out[d] = v
        return out

    def _eval_lt(self, ct: Ciphertext, diags: dict[int, np.ndarray]
                 ) -> Ciphertext:
        """out_j = sum_d diag_d[j] * z_{j+d} via BSGS with hoisting."""
        ctx = self.ctx
        s = self.slots
        G = self.G
        ct = ctx._ensure_deg1(ct)
        precomp = ctx.fast_rotation_precompute(ct)
        babies = {0: ct}
        needed_b = sorted({d % G for d in diags})
        for b in needed_b:
            if b:
                babies[b] = ctx.fast_rotation(ct, b, precomp)
        acc = None
        for g in range(self.n_giant):
            inner = None
            for b in needed_b:
                d = g * G + b
                if d not in diags:
                    continue
                vec = np.roll(diags[d], g * G)
                pt = ctx.make_plaintext(vec, ct.limbs, ctx.delta, s)
                term = ctx.mult(babies[b], pt)
                inner = term if inner is None else ctx.add(inner, term)
            if inner is None:
                continue
            if g:
                inner = ctx.rotate(inner, g * G)
            acc = inner if acc is None else ctx.add(acc, inner)
        return acc

    def _sine_coeffs(self, delta0: float) -> np.ndarray:
        key = round(float(np.log2(delta0)), 6)
        if key not in self._sine_cache:
            amp = self._q0 / (2 * np.pi * delta0)
            K = self.K
            c = chebyshev_coefficients(
                lambda x: amp * np.sin(2 * np.pi * K * x),
                -1.0, 1.0, self._sine_deg)
            c[np.abs(c) < 1e-13 * np.abs(c).max()] = 0.0
            self._sine_cache[key] = c
        return self._sine_cache[key]

    # ------------------------------------------------------------------
    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        """EvalBootstrap: returns a ciphertext with the same slot values
        near the top of the modulus chain."""
        ctx = self.ctx
        P = ctx.params
        assert ct.slots == self.slots, (ct.slots, self.slots)
        phases = iter(PHASES)
        self.phase_s = {}
        ctx.sync()
        t0 = time.perf_counter()

        def mark():
            nonlocal t0
            ctx.sync()
            t = time.perf_counter()
            self.phase_s[next(phases)] = t - t0
            t0 = t

        ct = ctx._ensure_deg1(ct)
        base = P.base_limbs
        if ct.limbs > base and (ct.limbs - base) % P.comp:
            # snap to the rescale ladder
            ct = ctx.level_reduce(
                ct, ct.limbs - (ct.limbs - base) % P.comp)
        if ct.limbs > base:
            ct = ctx.adjust_to(ct, base, ctx.canonical_scale(base))
        ct = ctx.level_reduce(ct, min(ct.limbs, self.raise_limbs))
        # Raise the SCALE to q0 / 2^margin with an exact integer multiply
        # (message and noise scale together: relative noise unchanged).
        # Without this, delta0 is the chain's Delta and EvalMod's sine
        # amplitude q0/(2 pi delta0) multiplies the Chebyshev fit error:
        # at the full tier the 3x30-bit base gives q0/Delta = 2^34, which
        # turns the 2^-34 fit tolerance into O(0.1) output error.
        # OpenFHE's AdjustCiphertext does the equivalent scale correction
        # before ModRaise.
        f = int(self._q0 / (1 << self.margin_bits) / ct.scale)
        if f > 1:
            ct = replace(ctx.mult_int(ct, f), scale=ct.scale * f)
        delta0 = ct.scale

        raised = ctx.mod_raise(ct)
        mark()

        # subring trace (sparse packing): message invariant, error folded
        t = raised
        j = 0
        while (1 << j) < self.r:
            t = ctx.add(t, ctx.rotate_raw(t, self.slots << j))
            j += 1
        # underlying = r*(c + q0*I); re-declare the scale so decoded slots
        # are E_lo (a_lo + i a_hi) / q0: pure bookkeeping, keeps the C2S
        # matrix entries O(1/(sK)) (encodable at Delta without precision
        # loss; folding 1/q0 into the matrix would push entries to ~2^-90)
        t = replace(t, scale=self.r * self._q0)
        mark()

        # CoeffsToSlots: u = (a_lo + i a_hi)/(2 q0 K)
        u = self._eval_lt(t, self._diags(self._M_dec / (2.0 * self.K)))

        # re-anchor the scale to the canonical ladder (the raised scale
        # r*q0 is not a chain scale; one exact integer multiply + rescale
        # restores anchoring at full precision before the sine evaluation)
        u = ctx._ensure_deg1(u)
        u = ctx.adjust_to(u, u.limbs - P.comp,
                          ctx.canonical_scale(u.limbs - P.comp))
        mark()

        # real/imag split: re = u + conj(u), im = -i (u - conj(u))
        uc = ctx.conjugate(u)
        n = ctx.n
        re = ctx.add(u, uc)
        im = ctx.mult_monomial(ctx.sub(u, uc), 3 * n // 2)

        # EvalMod: (q0/(2 pi delta0)) sin(2 pi K x) ~ (x mod 1/K)-ish
        coeffs = self._sine_coeffs(delta0)
        re = eval_chebyshev_series_ps(ctx, re, coeffs)
        im = eval_chebyshev_series_ps(ctx, im, coeffs)
        mark()

        # recombine and SlotsToCoeffs
        comb = ctx.add(re, ctx.mult_monomial(im, n // 2))
        out = self._eval_lt(comb, self._diags(self._E_lo))
        out = ctx._ensure_deg1(out)
        mark()
        return out

    # sugar so a Bootstrapper can be passed directly as bootstrap_hook
    def __call__(self, ct: Ciphertext) -> Ciphertext:
        return self.bootstrap(ct)


class BootstrapHook:
    """Slot-count-dispatching bootstrap hook: lazily builds one
    Bootstrapper per slot width (pipelines change packing mid-flight,
    e.g. constructRank's partition packing vs the final N-slot result)."""

    def __init__(self, ctx: CkksContext, K: int | None = None):
        self.ctx = ctx
        self.K = K
        self._per_slots: dict[int, Bootstrapper] = {}

    def setup(self, slots: int) -> Bootstrapper:
        """The Bootstrapper of width `slots`, built with its keys on first
        use."""
        if slots not in self._per_slots:
            self._per_slots[slots] = Bootstrapper(
                self.ctx, slots, K=self.K).setup_keys()
        return self._per_slots[slots]

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        return self.setup(ct.slots).bootstrap(ct)
