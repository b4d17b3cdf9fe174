"""BitonicSort: log^2(N)-stage compare-and-swap network on one packed
ciphertext.

Rebuild of sort_algo.h:1393-1487: per (k, j) stage,
four plaintext masks derived from the i^j index pattern split the vector
into compare lanes; masked pieces rotate +-j; the algebraic min/max
  compare_and_swap(a1..a4) = c*a3 + (1-c)*a4,  c = compare(a1, a2)
selects sorted positions.  Inputs are normalized by 1/255 on entry and
denormalized at the end (sort_algo.h:1424,1483).

The reference bootstraps when GetLevel() > 29 (sort_algo.h:1436-1438):
pass bootstrap_level and a bootstrap_hook (core/bootstrap.BootstrapHook,
the real EvalBootstrap), or run with enough depth.

The torch port's copy of sorting_fhe_tpu/models/bitonic.py: the same
context calls in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..core.ckks import CkksContext, Ciphertext
from ..ops.sign import SignFunc, SignConfig, CompositeSignConfig
from ..ops.comparison import compare
from ..ops.rotation import RotationComposer, DecomposeAlgo


def bitonic_rotations(N: int) -> list[int]:
    """+-j rotations used by the network: powers of two below N (negative
    handled modulo n/2 by the context)."""
    out = []
    j = 1
    while j < N:
        out.append(j)
        j *= 2
    return out


@dataclass
class BitonicSort:
    ctx: CkksContext
    N: int
    rot_indices: list[int] = field(default_factory=list)
    sign_func: SignFunc = SignFunc.CompositeSign
    bootstrap_level: int | None = None     # consumed-levels trigger
    bootstrap_hook: Callable | None = None

    def __post_init__(self):
        if not self.rot_indices:
            self.rot_indices = bitonic_rotations(self.N)
        half = self.ctx.n // 2
        keys = set()
        for j in self.rot_indices:
            keys.add(j % half)
            keys.add(-j % half)
        self.ctx.gen_rotation_keys(sorted(keys))
        self.rot = RotationComposer(self.ctx, sorted(keys), self.N,
                                    DecomposeAlgo.BINARY)

    def _stage_masks(self, k: int, j: int):
        N = self.N
        m1 = np.zeros(N)
        m2 = np.zeros(N)
        m3 = np.zeros(N)
        m4 = np.zeros(N)
        for i in range(N):
            l = i ^ j
            if i < l:
                if (i & k) == 0:
                    m1[i] = 1.0
                    m2[l] = 1.0
                else:
                    m3[i] = 1.0
                    m4[l] = 1.0
        return m1, m2, m3, m4

    def _compare_and_swap(self, a1, a2, a3, a4, cfg):
        ctx = self.ctx
        c = compare(ctx, a1, a2, self.sign_func, cfg)
        t1 = ctx.mult(c, a3)
        t2 = ctx.mult(ctx.rsub(1.0, c), a4)
        return ctx.add(t1, t2)

    def sort(self, input_array: Ciphertext,
             cfg: SignConfig | None = None) -> Ciphertext:
        ctx = self.ctx
        N = self.N
        cfg = cfg or SignConfig(CompositeSignConfig(3, 2, 2))
        result = ctx.mult_scalar(input_array, 1.0 / 255)

        k = 2
        while k <= N:
            j = k // 2
            while j > 0:
                if self.bootstrap_hook is not None and \
                        self.bootstrap_level is not None and \
                        self._consumed(result) > self.bootstrap_level:
                    result = self.bootstrap_hook(result)
                m1, m2, m3, m4 = self._stage_masks(k, j)
                # canonical-factor mask encodes: products land back on the
                # scale ladder (drift here seeded the round-3 runaway that
                # _anchor was built to contain)
                arr1 = ctx.mult_plain(result, m1, N)
                arr2 = ctx.mult_plain(result, m2, N)
                arr3 = ctx.mult_plain(result, m3, N)
                arr4 = ctx.mult_plain(result, m4, N)
                arr5_1 = self.rot.rotate(arr1, -j)
                arr5_2 = self.rot.rotate(arr3, -j)
                arr6_1 = self.rot.rotate(arr2, j)
                arr6_2 = self.rot.rotate(arr4, j)
                arr7 = ctx.add(ctx.add(arr5_1, arr5_2),
                               ctx.add(arr6_1, arr6_2))
                arr8 = result
                arr9 = ctx.add(ctx.add(arr5_1, arr1), ctx.add(arr6_2, arr4))
                arr10 = ctx.add(ctx.add(arr5_2, arr3), ctx.add(arr6_1, arr2))
                result = self._compare_and_swap(arr7, arr8, arr9, arr10, cfg)
                j //= 2
            k *= 2

        return ctx.mult_scalar(result, 255.0)

    def _consumed(self, ct: Ciphertext) -> int:
        P = self.ctx.params
        return (P.nq - ct.limbs) // P.comp
