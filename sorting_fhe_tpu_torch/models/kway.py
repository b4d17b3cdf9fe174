"""k-way sorting network [HKC+21] for k in {2, 3, 5} on N = k^M elements.

Rebuild of the reference's src/k-way/ (Masking, EvalUtils,
SortUtils, Sorter) and kway_adapter.h.  One packed ciphertext holds the
array; each network stage is characterized by (m, logDist, slope) computed
from the stage index (Masking.cpp:26-47); a slot-role matrix `indices`
(Masking.cpp:49-144) drives mask generation; comparisons are evaluated on
a rotated copy (rightRotateForSort, Sorter.cpp:180-249); primitive
2/3/4/5-sorters place min/max via the algebra

    fcnL(a, b, c) = c*(a-b) + b        (max if c = (a>b))

with middle elements recovered by sum-subtraction (SortUtils.cpp:5-200).

Level budgeting mirrors Sorter.h:85-93 (effective m_level = [0,1,3,5,6,7]
after the Sorter override); checkLevelAndBoot (EvalUtils.cpp:57-94)
bootstraps when the remaining depth is short, here through the sorter's
bootstrap hook (core/bootstrap.BootstrapHook or the test-only
utils/debug.recrypt_hook).

The torch port's copy of sorting_fhe_tpu/models/kway.py: the same context
calls in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..core.ckks import CkksContext, Ciphertext
from ..ops.sign import SignFunc, SignConfig, CompositeSignConfig
from ..ops.comparison import compare


# ---------------- masking / stage geometry (pure logic) ----------------

def sort_type(k: int, M: int, stage: int) -> tuple[int, int, int]:
    """(m, logDist, slope) for a stage (Masking.cpp:26-47)."""
    upperk = (k + 1) // 2
    r = 0
    while stage >= (r + 1 + r * (r + 1) // 2 * upperk):
        r += 1
    n = stage - (r + r * (r - 1) // 2 * upperk)
    m = (n + upperk - 1) // upperk
    log_dist = r - m
    slope = 0 if n == 0 else ((n - 1) % upperk) + 1
    return m, log_dist, slope


def gen_indices(num_slots: int, k: int, M: int, m: int, log_dist: int,
                slope: int) -> np.ndarray:
    """Slot-role matrix [2, num_slots] (Masking.cpp:49-144).

    res[0][slot] = size of the sorter group the slot belongs to;
    res[1][slot] = 1-based position within that group (0 = not involved).
    """
    res = np.zeros((2, num_slots), dtype=np.int64)
    km = k ** m
    dist = k ** log_dist
    nxt = k ** (m + 1)

    def diag_walk(start, s_range, t_range):
        for s in s_range:
            for t in t_range:
                row, col, loc = s, t, 1
                while row < km and col >= 0:
                    for d in range(dist):
                        here = start + dist * (col + k * row) + d
                        res[0, here] = loc
                        if row == km - 1 or col - slope < 0:
                            for i in range(loc):
                                rn = row - i
                                cn = col + i * slope
                                hn = start + dist * (cn + k * rn) + d
                                res[1, hn] = loc - i
                                res[0, hn] += i
                    loc += 1
                    row += 1
                    col -= slope
    total = k ** M
    for start in range(0, total, dist * nxt):
        if slope == 0:
            for s in range(km):
                loc = 1
                row, col = s, 0
                while row >= 0 and col < k:
                    for d in range(dist):
                        here = start + dist * (row + km * col) + d
                        res[0, here] = k
                        res[1, here] = loc
                    loc += 1
                    col += 1
        elif slope > k // 2:
            for t in range(km - 1):
                col = k - k // 2
                for loc in range(1, k):
                    for d in range(dist):
                        here = start + dist * (col + k * t + loc - 1) + d
                        res[0, here] = k - 1
                        res[1, here] = loc
        else:
            diag_walk(start, [0], range(slope, k))
            for s in range(1, km - 1):
                diag_walk(start, [s], range(k - slope, k))
    return res


def gen_mask(indices: np.ndarray, index0: int, index1: int) -> np.ndarray:
    """1.0 where (indices[0], indices[1]) == (index0, index1)
    (Masking.cpp:146-156)."""
    return ((indices[0] == index0) & (indices[1] == index1)).astype(np.float64)


def get_rotate_distance(k: int, log_dist: int, slope: int) -> int:
    """(Masking.cpp:158-167)."""
    dist = k ** log_dist
    if slope == 0 or slope == k // 2 + 1:
        return dist
    return dist * (k - slope)


def kway_rotations(N: int) -> list[int]:
    """Power-of-two +-rotations (kway_adapter.h:48-52)."""
    out = []
    i = 1
    while i < N:
        out += [i, -i]
        i *= 2
    return out


def num_stages(k: int, M: int) -> int:
    """M first-phase + M(M-1)/2 * ceil(k/2) merge stages (Sorter.cpp:298)."""
    return M + M * (M - 1) // 2 * ((k + 1) // 2)


# ---------------- the sorter ----------------

@dataclass
class KWaySorter:
    """kwaySort::Sorter equivalent bound to a context.

    N = k^M values live in the first N slots of one ciphertext.
    """
    ctx: CkksContext
    k: int
    M: int
    sign_func: SignFunc = SignFunc.CompositeSign
    mult_depth: int | None = None         # for boot decisions
    bootstrap_hook: Callable | None = None
    verbose: bool = False

    # effective per-k level requirements (Sorter.h:85-93 after override)
    LEVELS = {2: 3, 3: 5, 4: 6, 5: 7}

    def __post_init__(self):
        assert self.k in (2, 3, 5), "only k = 2, 3, 5 supported"
        self.N = self.k ** self.M
        # batch = next power of two >= N (kway_adapter.h:9-21,44)
        self.num_slots = 1 << (self.N - 1).bit_length()
        half = self.ctx.n // 2
        keys = sorted({r % half for r in kway_rotations(self.num_slots)
                       if r % half})
        self.ctx.gen_rotation_keys(keys)
        if self.mult_depth is None:
            self.mult_depth = self.ctx.params.L // self.ctx.params.comp \
                if self.ctx.params.comp > 1 else self.ctx.params.L

    # ---------- EvalUtils ----------
    def _left_rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Composed power-of-two left rotation (EvalUtils.cpp:106-126)."""
        if r == 0:
            return ct
        out = ct
        bit = 1
        rr = r
        while rr > 0:
            if rr & 1:
                out = self.ctx.rotate(out, bit)
            rr >>= 1
            bit <<= 1
        return out

    def _right_rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        if r == 0:
            return ct
        out = ct
        bit = 1
        rr = r
        while rr > 0:
            if rr & 1:
                out = self.ctx.rotate(out, -bit)
            rr >>= 1
            bit <<= 1
        return out

    def _flip(self, ct: Ciphertext, mask: np.ndarray) -> Ciphertext:
        """ct <- mask - ct (EvalUtils.cpp:101-104)."""
        pt = self.ctx.make_plaintext(mask, ct.limbs, ct.scale, self.num_slots)
        return self.ctx.rsub(pt, ct)

    def _pt(self, vec: np.ndarray, ct: Ciphertext):
        return self.ctx.make_plaintext(vec, ct.limbs, self.ctx.delta,
                                       self.num_slots)

    def _consumed(self, ct: Ciphertext) -> int:
        P = self.ctx.params
        return (P.nq - ct.limbs) // P.comp

    def _check_level_and_boot(self, ct: Ciphertext, level: int) -> Ciphertext:
        """Bootstrap when remaining depth < level + 1 (EvalUtils.cpp:57-86)."""
        if self.bootstrap_hook is None:
            return ct
        if self.mult_depth - self._consumed(ct) < level + 1:
            if self.verbose:
                print(f"[kway] bootstrapping at consumed level "
                      f"{self._consumed(ct)}")
            return self.bootstrap_hook(ct)
        return ct

    # ---------- SortUtils primitives ----------
    def _fcn_l(self, a: Ciphertext, b: Ciphertext,
               c: Ciphertext) -> Ciphertext:
        """c*(a-b) + b = max(a,b) when c = (a>b) (SortUtils.cpp:5-16)."""
        ctx = self.ctx
        return ctx.add(ctx.mult(ctx.sub(a, b), c), b)

    def _compare_max(self, a, b, c):
        return self._fcn_l(a, b, c)

    def _compare_min(self, a, b, c):
        return self._fcn_l(b, a, c)

    def _two_sorter(self, a: Ciphertext, b: Ciphertext,
                    comp: Ciphertext) -> list[Ciphertext]:
        """[min, max] (SortUtils.cpp:32-54)."""
        ctx = self.ctx
        mx = self._fcn_l(a, b, comp)
        mn = ctx.sub(ctx.add(a, b), mx)
        return [mn, mx]

    def _three_sorter(self, c: list[Ciphertext],
                      comp: list[Ciphertext]) -> list[Ciphertext]:
        """comp = [(a>b), (a>c), (b>c)] -> [min, mid, max]
        (SortUtils.cpp:56-78)."""
        ctx = self.ctx
        Mm1 = self._two_sorter(c[0], c[1], comp[0])
        Mm1vsC = self._two_sorter(comp[1], comp[2], comp[0])
        mx = self._compare_max(Mm1[1], c[2], Mm1vsC[1])
        mn = self._compare_min(Mm1[0], c[2], Mm1vsC[0])
        s = ctx.add(ctx.add(c[0], c[1]), c[2])
        mid = ctx.sub(ctx.sub(s, mn), mx)
        return [mn, mid, mx]

    def _four_sorter(self, c: list[Ciphertext],
                     comp: list[Ciphertext]) -> list[Ciphertext]:
        """comp = [a>b, a>c, a>d, b>c, b>d, c>d] (SortUtils.cpp:80-129)."""
        ctx = self.ctx
        Mm1 = self._two_sorter(c[0], c[1], comp[0])
        Mm2 = self._two_sorter(c[2], c[3], comp[5])
        Mm1vsC = self._two_sorter(comp[1], comp[3], comp[0])
        Mm1vsD = self._two_sorter(comp[2], comp[4], comp[0])
        M1vsMm2 = self._two_sorter(Mm1vsC[1], Mm1vsD[1], comp[5])
        m1vsMm2 = self._two_sorter(Mm1vsC[0], Mm1vsD[0], comp[5])
        out3 = self._compare_max(Mm1[1], Mm2[1], M1vsMm2[1])
        left = self._compare_max(Mm1[0], Mm2[1], m1vsMm2[1])
        right = self._compare_max(Mm1[1], Mm2[0], M1vsMm2[0])
        out2 = self._compare_max(left, right, M1vsMm2[1])
        out0 = self._compare_min(Mm1[0], Mm2[0], m1vsMm2[0])
        s = c[0]
        for i in range(1, 4):
            s = ctx.add(s, c[i])
        out1 = ctx.sub(ctx.sub(ctx.sub(s, out0), out2), out3)
        return [out0, out1, out2, out3]

    def _five_sorter(self, c: list[Ciphertext],
                     comp: list[Ciphertext]) -> list[Ciphertext]:
        """comp = [a>b a>c a>d a>e b>c b>d b>e c>d c>e d>e]
        (SortUtils.cpp:131-200)."""
        ctx = self.ctx
        abc_comp = [comp[0], comp[1], comp[4]]
        abc = self._three_sorter([c[0], c[1], c[2]], abc_comp)
        de = self._two_sorter(c[3], c[4], comp[9])
        abc_vs_d = self._three_sorter([comp[2], comp[5], comp[7]], abc_comp)
        abc_vs_e = self._three_sorter([comp[3], comp[6], comp[8]], abc_comp)
        M1vsMm2 = self._two_sorter(abc_vs_d[2], abc_vs_e[2], comp[9])
        D1vsMm2 = self._two_sorter(abc_vs_d[1], abc_vs_e[1], comp[9])
        m1vsMm2 = self._two_sorter(abc_vs_d[0], abc_vs_e[0], comp[9])
        out4 = self._compare_max(abc[2], de[1], M1vsMm2[1])
        out0 = self._compare_min(abc[0], de[0], m1vsMm2[0])
        left = self._compare_max(abc[1], de[1], D1vsMm2[1])
        right = self._compare_max(abc[2], de[0], M1vsMm2[0])
        out3 = self._compare_max(left, right, M1vsMm2[1])
        left = self._compare_min(abc[1], de[0], D1vsMm2[0])
        right = self._compare_min(abc[0], de[1], m1vsMm2[1])
        out1 = self._compare_min(left, right, m1vsMm2[0])
        s = c[0]
        for i in range(1, 5):
            s = ctx.add(s, c[i])
        out2 = s
        for o in (out0, out1, out3, out4):
            out2 = ctx.sub(out2, o)
        return [out0, out1, out2, out3, out4]

    # ---------- slot matching (SortUtils.cpp:202-423) ----------
    def _slot_matching3(self, ct, comp, indices, shift):
        mask3 = gen_mask(indices, 3, 1)
        arr = [self._left_rotate(ct, i * shift) for i in range(3)]
        comp_arr = [None] * 3
        comp_arr[1] = comp
        comp_arr[0] = self._flip(self._left_rotate(comp, shift), mask3)
        comp_arr[2] = self._flip(self._left_rotate(comp, 2 * shift), mask3)
        return arr, comp_arr

    def _slot_matching4(self, ct, comp1, comp2, indices, shift):
        mask4 = gen_mask(indices, 4, 1)
        comp_arr = [None] * 6
        comp_arr[2] = comp1                                   # a > b
        comp_arr[0] = self._left_rotate(comp1, shift)         # a > c
        comp_arr[3] = self._left_rotate(comp1, 2 * shift)     # a > d
        comp_arr[5] = self._left_rotate(comp1, 3 * shift)     # b > c
        comp_arr[1] = comp2                                   # b > d
        comp_arr[4] = self._left_rotate(comp2, shift)         # c > d
        for i in (0, 3, 5):
            comp_arr[i] = self._flip(comp_arr[i], mask4)
        arr = []
        for i in range(4):
            r = self._left_rotate(ct, i * shift)
            arr.append(self.ctx.mult(r, self._pt(mask4, r)))
        return arr, comp_arr

    def _slot_matching5(self, ct, comp1, comp2, indices, shift):
        mask5 = gen_mask(indices, 5, 1)
        arr = [self._left_rotate(ct, i * shift) for i in range(5)]
        comp_arr = [None] * 10
        comp_arr[3] = comp1                                    # a>e
        comp_arr[0] = self._left_rotate(comp1, shift)          # a>b
        comp_arr[4] = self._left_rotate(comp1, 2 * shift)      # b>c
        comp_arr[7] = self._left_rotate(comp1, 3 * shift)      # c>d
        comp_arr[9] = self._left_rotate(comp1, 4 * shift)      # d>e
        comp_arr[2] = comp2                                    # a>d
        comp_arr[6] = self._left_rotate(comp2, shift)          # b>e
        comp_arr[1] = self._left_rotate(comp2, 2 * shift)      # a>c
        comp_arr[5] = self._left_rotate(comp2, 3 * shift)      # b>d
        comp_arr[8] = self._left_rotate(comp2, 4 * shift)      # c>e
        for i in (0, 1, 4, 5, 7, 8, 9):
            comp_arr[i] = self._flip(comp_arr[i], mask5)
        return arr, comp_arr

    def _mixed_masks(self, indices):
        """(mask2345, mask45, mask345, mask3, mask4, mask5)
        (Sorter.cpp:126-152)."""
        n = indices.shape[1]
        m2345 = np.zeros(n)
        m45 = np.zeros(n)
        m345 = np.zeros(n)
        m3 = np.zeros(n)
        m4 = np.zeros(n)
        m5 = np.zeros(n)
        first = indices[1] == 1
        for sz, targets in ((2, (m2345,)), (3, (m2345, m345, m3)),
                            (4, (m2345, m345, m45, m4)),
                            (5, (m2345, m345, m45, m5))):
            sel = first & (indices[0] == sz)
            for t in targets:
                t[sel] = 1.0
        return m2345, m45, m345, m3, m4, m5

    def _slot_matching2345(self, ct, comp1, comp2, indices, shift):
        """(SortUtils.cpp:325-423)."""
        ctx = self.ctx
        m2345, m45, m345, m3, m4, m5 = self._mixed_masks(indices)
        arr = [self._left_rotate(ct, i * shift) for i in range(5)]
        comp_arr = [None] * 10
        # a > b
        comp_arr[0] = self._flip(self._left_rotate(comp1, shift), m2345)
        # a > c: comp1 on 3-groups, flipped rotated comp2 on 4/5-groups
        tmp = ctx.mult(comp1, self._pt(m3, comp1))
        tmp2 = self._left_rotate(comp2, 2 * shift)
        tmp2 = self._flip(ctx.mult(tmp2, self._pt(m45, tmp2)), m45)
        comp_arr[1] = ctx.add(tmp, tmp2)
        # a > d
        comp_arr[2] = ctx.add(ctx.mult(comp1, self._pt(m4, comp1)),
                              ctx.mult(comp2, self._pt(m5, comp2)))
        # a > e
        comp_arr[3] = ctx.mult(comp1, self._pt(m5, comp1))
        # b > c
        t = self._left_rotate(comp1, 2 * shift)
        comp_arr[4] = self._flip(ctx.mult(t, self._pt(m345, t)), m345)
        # b > d
        t = self._left_rotate(comp2, 3 * shift)
        comp_arr[5] = self._flip(ctx.mult(t, self._pt(m45, t)), m45)
        # b > e
        t = self._left_rotate(comp2, shift)
        comp_arr[6] = ctx.mult(t, self._pt(m5, t))
        # c > d
        t = self._left_rotate(comp1, 3 * shift)
        comp_arr[7] = self._flip(ctx.mult(t, self._pt(m45, t)), m45)
        # c > e
        t = self._left_rotate(comp2, 4 * shift)
        comp_arr[8] = self._flip(ctx.mult(t, self._pt(m5, t)), m5)
        # d > e
        t = self._left_rotate(comp1, 4 * shift)
        comp_arr[9] = self._flip(ctx.mult(t, self._pt(m5, t)), m5)
        return arr, comp_arr

    def _slot_assemble(self, sorted_cts: list[Ciphertext],
                       shift: int) -> Ciphertext:
        """(SortUtils.cpp:425-433)."""
        out = sorted_cts[0]
        for i in range(1, len(sorted_cts)):
            out = self.ctx.add(out, self._right_rotate(sorted_cts[i],
                                                       i * shift))
        return out

    # ---------- rotation for comparison (Sorter.cpp:180-249) ----------
    def _right_rotate_for_sort(self, ct, indices, log_dist, slope):
        """Returns (ctxt_rot, ctxt_fix)."""
        ctx = self.ctx
        k = self.k
        mask_left = (indices[1] < indices[0]).astype(np.float64)
        mask_right = np.zeros((k, self.num_slots))
        sel = (indices[0] > 0) & (indices[0] == indices[1])
        for i in np.nonzero(sel)[0]:
            mask_right[indices[0, i] - 1, i] = 1.0

        left = ctx.mult(ct, self._pt(mask_left, ct))
        rot = get_rotate_distance(k, log_dist, slope)
        fix = None
        if slope == 0:
            right = ctx.mult(ct, self._pt(mask_right[k - 1], ct))
            rot_right = self._left_rotate(right, (k - 1) * rot)
            out = ctx.add(self._right_rotate(left, rot), rot_right)
        elif slope == k // 2 + 1:
            right = ctx.mult(ct, self._pt(mask_right[k - 2], ct))
            fix = ctx.sub(ctx.sub(ct, left), right)
            rot_right = self._left_rotate(right, (k - 2) * rot)
            out = ctx.add(self._right_rotate(left, rot), rot_right)
        else:
            rights = [ctx.mult(ct, self._pt(mask_right[i], ct))
                      for i in range(k)]
            fix = ctx.sub(ct, left)
            for r in rights:
                fix = ctx.sub(fix, r)
            out = self._right_rotate(left, rot)
            for i in range(1, k):
                out = ctx.add(out, self._left_rotate(rights[i], i * rot))
        return out, fix

    def _comparison_for_sort(self, ct, indices, log_dist, slope, cfg):
        rot, fix = self._right_rotate_for_sort(ct, indices, log_dist, slope)
        comp = compare(self.ctx, ct, rot, self.sign_func, cfg)
        return comp, fix

    def _comparison_for_sort2(self, ct, indices, log_dist, slope, cfg):
        rot1, fix = self._right_rotate_for_sort(ct, indices, log_dist, slope)
        rot2, _ = self._right_rotate_for_sort(rot1, indices, log_dist, slope)
        c1 = compare(self.ctx, ct, rot1, self.sign_func, cfg)
        c2 = compare(self.ctx, ct, rot2, self.sign_func, cfg)
        return c1, c2, fix

    # ---------- per-stage runners (Sorter.cpp:8-178) ----------
    def _run_two_sorter(self, ct, indices, shift, comp):
        ctx = self.ctx
        mask2 = gen_mask(indices, 2, 1)
        a = ct
        b = self._left_rotate(ct, shift)
        mn, mx = self._two_sorter(a, b, comp)
        mn = ctx.mult(mn, self._pt(mask2, mn))
        mx = ctx.mult(mx, self._pt(mask2, mx))
        return ctx.add(mn, self._right_rotate(mx, shift))

    def _run_three_sorter(self, ct, indices, shift, comp):
        ctx = self.ctx
        mask3 = gen_mask(indices, 3, 1)
        arr, comp_arr = self._slot_matching3(ct, comp, indices, shift)
        srt = self._three_sorter(arr, comp_arr)
        srt = [ctx.mult(s, self._pt(mask3, s)) for s in srt]
        out = ctx.add(srt[0], self._right_rotate(srt[1], shift))
        return ctx.add(out, self._right_rotate(srt[2], 2 * shift))

    def _run_four_sorter(self, ct, indices, shift, comp1, comp2):
        arr, comp_arr = self._slot_matching4(ct, comp1, comp2, indices, shift)
        srt = self._four_sorter(arr, comp_arr)
        return self._slot_assemble(srt, shift)

    def _run_five_sorter(self, ct, indices, shift, comp1, comp2):
        ctx = self.ctx
        mask5 = gen_mask(indices, 5, 1)
        arr, comp_arr = self._slot_matching5(ct, comp1, comp2, indices, shift)
        srt = self._five_sorter(arr, comp_arr)
        srt = [ctx.mult(s, self._pt(mask5, s)) for s in srt]
        return self._slot_assemble(srt, shift)

    def _run_2345_sorter(self, ct, indices, shift, comp1, comp2):
        ctx = self.ctx
        m2345, m45, m345, _, _, m5 = self._mixed_masks(indices)
        arr, comp_arr = self._slot_matching2345(ct, comp1, comp2, indices,
                                                shift)
        srt = self._five_sorter(arr, comp_arr)
        masks = [m2345, m2345, m345, m45, m5]
        srt = [ctx.mult(s, self._pt(m, s)) for s, m in zip(srt, masks)]
        return self._slot_assemble(srt, shift)

    # ---------- main loop (Sorter.cpp:284-404) ----------
    def sort(self, ct: Ciphertext,
             cfg: SignConfig | None = None) -> Ciphertext:
        ctx = self.ctx
        k, M = self.k, self.M
        cfg = cfg or SignConfig(CompositeSignConfig(3, 2, 2))
        if self.bootstrap_hook is not None and cfg.bootstrap_hook is None:
            from dataclasses import replace as _rep
            cfg = _rep(cfg, bootstrap_hook=self.bootstrap_hook)
        LV = self.LEVELS
        for stage in range(num_stages(k, M)):
            m, log_dist, slope = sort_type(k, M, stage)
            shift = get_rotate_distance(k, log_dist, slope)
            if self.verbose:
                print(f"[kway] stage {stage}: m={m} logDist={log_dist} "
                      f"slope={slope} shift={shift}")
            indices = gen_indices(self.num_slots, k, M, m, log_dist, slope)

            if slope == 0:
                if k == 2:
                    ct = self._check_level_and_boot(ct, LV[2])
                    comp, _ = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg)
                    comp = self._check_level_and_boot(comp, LV[2])
                    ct = self._run_two_sorter(ct, indices, shift, comp)
                elif k == 3:
                    ct = self._check_level_and_boot(ct, LV[3])
                    comp, _ = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg)
                    comp = self._check_level_and_boot(comp, LV[3])
                    ct = self._run_three_sorter(ct, indices, shift, comp)
                else:
                    ct = self._check_level_and_boot(ct, LV[5])
                    c1, c2, _ = self._comparison_for_sort2(
                        ct, indices, log_dist, slope, cfg)
                    c1 = self._check_level_and_boot(c1, LV[5])
                    c2 = self._check_level_and_boot(c2, LV[5])
                    ct = self._run_five_sorter(ct, indices, shift, c1, c2)
            elif slope == k // 2 + 1:
                if k == 3:
                    ct = self._check_level_and_boot(ct, LV[2])
                    comp, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg)
                    comp = self._check_level_and_boot(comp, LV[2])
                    ct = ctx.add(self._run_two_sorter(ct, indices, shift,
                                                      comp), fix)
                else:  # k == 5
                    ct = self._check_level_and_boot(ct, LV[4])
                    c1, c2, fix = self._comparison_for_sort2(
                        ct, indices, log_dist, slope, cfg)
                    c1 = self._check_level_and_boot(c1, LV[4])
                    c2 = self._check_level_and_boot(c2, LV[4])
                    ct = ctx.add(self._run_four_sorter(ct, indices, shift,
                                                       c1, c2), fix)
            else:
                if k == 5 and slope == 1:
                    ct = self._check_level_and_boot(ct, LV[5])
                    c1, c2, fix = self._comparison_for_sort2(
                        ct, indices, log_dist, slope, cfg)
                    c1 = self._check_level_and_boot(c1, LV[5])
                    c2 = self._check_level_and_boot(c2, LV[5])
                    ct = ctx.add(self._run_2345_sorter(ct, indices, shift,
                                                       c1, c2), fix)
                elif (k == 5 and slope == 2) or (k == 3 and slope == 1):
                    ct = self._check_level_and_boot(ct, LV[3])
                    comp, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg)
                    comp = self._check_level_and_boot(comp, LV[2])
                    ct2 = self._run_two_sorter(ct, indices, shift, comp)
                    comp = self._check_level_and_boot(comp, LV[3])
                    ct3 = self._run_three_sorter(ct, indices, shift, comp)
                    ct = ctx.add(ctx.add(ct2, fix), ct3)
                elif k == 2 and slope == 1:
                    ct = self._check_level_and_boot(ct, LV[2])
                    comp, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg)
                    comp = self._check_level_and_boot(comp, LV[2])
                    ct2 = self._run_two_sorter(ct, indices, shift, comp)
                    ct = ctx.add(ct2, fix)
                else:
                    raise ValueError(f"no matching k={k} slope={slope}")
        return ct


def kway_factorization(N: int) -> tuple[int, int] | None:
    """(k, M) with k^M == N, preferring small k (KWayAdapter contract)."""
    for k in (2, 3, 5):
        M = 0
        v = N
        while v % k == 0:
            v //= k
            M += 1
        if v == 1 and M > 0:
            return k, M
    return None
