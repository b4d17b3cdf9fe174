"""Plaintext mock of the CkksContext op surface.

Copy of sorting_fhe_tpu/utils/plain.py (numpy only), so that this
package's tests drive its models without the JAX package.

Runs any algorithm written against the evaluator API on numpy slot vectors
(exact arithmetic, no crypto).  The algorithm structure — masks, rotations,
packing, polynomial approximations — is exercised identically, so this is
the fast oracle tier of the test strategy (the reference's equivalent:
scripts/direct_sort_rank.py + scripts/bitonic_sort.py, SURVEY.md §2.1 C13,
plus the synthetic-intermediate-state tests of §4.3).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass
class PlainCiphertext:
    data: np.ndarray     # full-width slot vector (length n/2)
    slots: int
    scale: float = 1.0
    noise_deg: int = 1

    @property
    def limbs(self) -> int:
        return 64       # plenty; algorithms only pass it to make_plaintext

    @property
    def k(self) -> int:
        return 2

    def with_slots(self, s: int) -> "PlainCiphertext":
        return replace(self, slots=s)


@dataclass
class PlainPlaintext:
    data: np.ndarray
    scale: float
    slots: int


class PlainContext:
    """Duck-type of CkksContext for plaintext algorithm validation."""

    def __init__(self, ring_dim: int = 1 << 12):
        self.n = ring_dim
        self.half = ring_dim // 2
        self.delta = 2.0 ** 52
        self.mult_count = 0
        self.rot_count = 0

    class _P:
        pass

    @property
    def params(self):
        p = self._P()
        p.num_slots = self.half
        p.nq = 64
        return p

    # ---- client ----
    def encrypt(self, values, slots=None):
        slots = slots or self.half
        v = np.zeros(slots)
        vals = np.asarray(values, dtype=np.float64)
        v[:len(vals)] = vals
        return PlainCiphertext(np.tile(v, self.half // slots), slots)

    def decrypt(self, ct: PlainCiphertext):
        return ct.data[:ct.slots]

    def fresh_zero(self, slots=None):
        slots = slots or self.half
        return PlainCiphertext(np.zeros(self.half), slots)

    def zero_like(self, ct):
        return PlainCiphertext(np.zeros(self.half), ct.slots)

    # ---- plaintext encoding ----
    def make_plaintext(self, values, limbs, scale, slots=None):
        slots = slots or self.half
        v = np.zeros(slots)
        vals = np.asarray(values, dtype=np.float64)
        v[:len(vals)] = vals
        return PlainPlaintext(np.tile(v, self.half // slots), scale, slots)

    # ---- keys (no-ops) ----
    def gen_rotation_keys(self, indices):
        pass

    rot_keys: dict = {}

    # ---- ops ----
    def _val(self, x):
        if isinstance(x, (PlainCiphertext, PlainPlaintext)):
            return x.data
        return float(x)

    def add(self, a, b):
        return replace(a, data=a.data + self._val(b))

    def sub(self, a, b):
        return replace(a, data=a.data - self._val(b))

    def rsub(self, b, a):
        return replace(a, data=self._val(b) - a.data)

    def negate(self, a):
        return replace(a, data=-a.data)

    def mult(self, a, b):
        self.mult_count += 1
        return replace(a, data=a.data * self._val(b))

    def mult_scalar(self, a, c):
        return replace(a, data=a.data * float(c))

    def mult_delta(self, ct):
        return 1.0

    def mult_plain(self, ct, values, slots=None):
        return self.mult(ct, self.make_plaintext(values, ct.limbs, 1.0,
                                                 slots or ct.slots))

    def mult_int(self, a, m):
        return replace(a, data=a.data * int(m))

    def square(self, a):
        self.mult_count += 1
        return replace(a, data=a.data * a.data)

    def rescale(self, a):
        return a

    def level_reduce(self, a, t):
        return a

    # ---- rotations ----
    def rotate(self, ct, k):
        if k % ct.slots == 0:
            return ct
        self.rot_count += 1
        return replace(ct, data=np.roll(ct.data, -k))

    def fast_rotation_precompute(self, ct):
        return None

    def fast_rotation(self, ct, k, precomp):
        return self.rotate(ct, k)

    def rotate_plaintext(self, pt, r):
        """Slot-rotation of a plaintext (ckks.rotate_plaintext mirror)."""
        if r % pt.slots == 0:
            return pt
        from dataclasses import replace as _rep
        return _rep(pt, data=np.roll(pt.data, -r))
