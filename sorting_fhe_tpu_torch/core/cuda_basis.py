"""The RNS fast base conversion: the hand-written kernel (csrc/basis.cu)
and its plain version.

    out[b, j, r] = sum_{a in digit j} xhat[b, a] * conv[a, r]  mod p[r]

`x` is int32 [K, L, n], canonical residues of L source primes, cut into
digits of `alpha` consecutive rows (the last may be shorter); `conv` is
int64 [L, R] (row a: source row a's constant for each of the R targets)
and `p` int64 [R], the target primes.  With `w` and `q` (int64 [L]) each
source row is first pre-scaled, xhat = x * w mod q; without them xhat is
x.  The result is int32 [K, ndig, R, n], canonical.  With `keep_own`
(ModUp: the first L target primes are the source primes) digit j's own
target rows keep its input rows, unconverted and not pre-scaled: the
kernel skips their sums, a fifth of ModUp's multiply-adds at digits of
24 over 119 rows.

Callers: the key switch's ModUp (`_kj_decompose`: one poly, every digit
onto the level's ext rows, keep_own) and ModDown (`_k_moddown`: both polys, the
special rows onto the q rows) in core/ckks.py, and the mesh's copies of
the two (parallel/collective.py `_extend`, `_phase3`).  Mod raise's CRT
extension (`_k_raise_rows`) keeps its own loop: it adds a float32
correction.

Dispatch by core/cuda_lib.py's device rule: a CPU tensor takes the plain
version `base_conv_t`; a CUDA tensor launches the kernel or raises.  The
kernel is built into that module's library.
"""

from __future__ import annotations

import torch

from . import cuda_lib

I32 = torch.int32
I64 = torch.int64
MAX_DIGIT = 40          # csrc/basis.cu's widest register bucket


def base_conv_t(x, conv, p, alpha: int, w=None, q=None,
                keep_own: bool = False) -> torch.Tensor:
    """Plain version: one multiply, remainder and add per source row,
    exact in int64."""
    K, L, n = x.shape
    xh = x.to(I64)
    if w is not None:
        xh = xh * w.reshape(-1, 1) % q.reshape(-1, 1)
    pe = p.reshape(-1, 1)
    out = torch.empty((K, -(-L // alpha), p.numel(), n), dtype=I32,
                      device=x.device)
    for j, lo in enumerate(range(0, L, alpha)):
        hi = min(lo + alpha, L)
        acc = torch.zeros((K, p.numel(), n), dtype=I64, device=x.device)
        for a in range(lo, hi):                   # terms < p: no overflow
            acc += xh[:, a:a + 1] * conv[a].reshape(-1, 1) % pe
        out[:, j] = acc % pe
        if keep_own:
            out[:, j, lo:hi] = x[:, lo:hi]
    return out


def _check(x, conv, p, alpha, w, q, keep_own) -> bool:
    """Raise on what neither version takes; True where the kernel runs."""
    cuda_lib.residues("base_conv", "x", x, 3)
    L, R = x.shape[1], p.numel()
    if (w is None) != (q is None):
        raise ValueError("base_conv takes the pre-scale's w and q together")
    cuda_lib.tables("base_conv", x.device, conv=(conv, (L, R)), p=(p, (R,)),
                    **({} if w is None else {"w": (w, (L,)), "q": (q, (L,))}))
    if alpha < 1:
        raise ValueError(f"digit width {alpha}")
    if keep_own and R < L:
        raise ValueError(f"keep_own needs the {L} source rows among the "
                         f"{R} targets")
    if not cuda_lib.kernel_device("base-conversion", x.device):
        return False
    if min(alpha, L) > MAX_DIGIT:
        raise ValueError(f"digits of {min(alpha, L)} rows are above the "
                         f"kernel's {MAX_DIGIT}")
    if x.data_ptr() % 16 or x.shape[2] % 4:
        raise ValueError("base_conv input must be 16-byte aligned with n a "
                         "multiple of 4")
    return True


def base_conv(x, conv, p, alpha: int, w=None, q=None,
              keep_own: bool = False) -> torch.Tensor:
    """The base conversion of x's digits onto the primes p (module
    docstring): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if not _check(x, conv, p, alpha, w, q, keep_own):
        return base_conv_t(x, conv, p, alpha, w, q, keep_own)
    K, L, n = x.shape
    R = p.numel()
    out = torch.empty((K, -(-L // alpha), R, n), dtype=I32, device=x.device)
    if out.numel():
        cuda_lib.launch("base_conv", x.device, x.data_ptr(), out.data_ptr(),
                        conv.data_ptr(), p.data_ptr(),
                        None if w is None else w.data_ptr(),
                        None if q is None else q.data_ptr(), K, L, alpha, R,
                        n, int(keep_own))
    return out
