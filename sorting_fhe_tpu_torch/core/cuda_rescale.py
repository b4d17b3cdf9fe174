"""The composite rescale's lift: the hand-written kernel (csrc/rescale.cu)
and its plain version.

A composite rescale drops the `comp` primes q_0 = q_{l-1}, q_1 = q_{l-2},
... of a level; step s subtracts the centred lift a_s of the row it drops
(OpenFHE's ModReduce) and divides by q_s.  The steps combine into one:

    (x - (a_0 + a_1 q_0 + a_2 q_0 q_1 + ...)) * (q_0 q_1 ...)^-1  mod p

    rescale_lift:  out[b, r] = (a_0 + a_1 q_0 + ...) * 2^32  mod p_r

`coeffs` is int32 [K, comp, n]: the dropped rows in the coefficient and
Montgomery domain, in chain order (its last row is q_0's).  `drop` and
`keep` are the int64 tables of `rescale_tables`: per step the dropped
prime, its half, 2^-32 mod it and q_s^-1 mod every later dropped prime;
per kept row its prime and the products q_0 ... q_{s-1} R and q_0 ... q_s R
mod it, each multiplier with its Shoup companion floor(w 2^32 / p).  The
result is int32 [K, L, n], canonical, L = len(keep).

Callers: `_kj_rescale` in core/ckks.py (one device: the inverse NTT of the
dropped rows, this lift, the forward NTT of the kept rows and
cuda_keyswitch.moddown_tail with pinv = (q_0 q_1 ...)^-1) and the mesh's
`_rescale_block` (parallel/evaluator.py: the same on a slot's kept rows,
from the gathered dropped rows).

Dispatch by core/cuda_lib.py's device rule: a CPU tensor takes the plain
version (`rescale_lift_t`, int64 torch with the same tables); a CUDA
tensor launches the kernel or raises.  The kernel is built into that
module's library.
"""

from __future__ import annotations

import torch

from . import cuda_lib, nt

I32 = torch.int32
I64 = torch.int64
MAX_COMP = 4              # csrc/rescale.cu's kMaxComp
R = 1 << 32


def _shoup(w: int, p: int) -> int:
    return (w << 32) // p


def rescale_tables(dropped: list, kept: list, device) -> tuple:
    """(drop, keep, pinv) for a rescale that drops the primes `dropped`
    (Python ints, q_0 = the level's last first) onto the primes `kept`:
    the kernel's int64 tables (module docstring; drop [comp, 4 + 2 comp],
    keep [len(kept), 1 + 3 comp]) and int64 pinv [len(kept)], the dropped
    primes' product inverted mod each kept prime, for moddown_tail."""
    comp = len(dropped)
    drop = []
    for s, q in enumerate(dropped):
        ri = nt.mod_inverse(R % q, q)
        row = [q, q // 2, ri, _shoup(ri, q)]
        for t, qt in enumerate(dropped):
            w = nt.mod_inverse(q % qt, qt) if t > s else 0
            row += [w, _shoup(w, qt)]
        drop.append(row)
    prod = 1
    for q in dropped:
        prod *= q
    keep = []
    for p in kept:
        row, c = [p], R % p
        for q in dropped:
            row += [c, _shoup(c, p), c * q % p]
            c = c * q % p
        keep.append(row)
    pinv = [nt.mod_inverse(prod % p, p) for p in kept]

    def i64(rows, shape):
        return torch.tensor(rows, dtype=I64, device=device).reshape(shape)
    return (i64(drop, (comp, 4 + 2 * comp)),
            i64(keep, (len(kept), 1 + 3 * comp)), i64(pinv, (len(kept),)))


def rescale_lift_t(coeffs, drop, keep) -> torch.Tensor:
    """Plain version: the kernel's steps in int64 torch over [K, n] rows,
    remainders in place of the Shoup products."""
    comp = drop.shape[0]
    d = drop.tolist()
    x = coeffs.to(I64)
    # u[s]: step s's dropped row, plain
    u = [x[:, comp - 1 - s] * d[s][2] % d[s][0] for s in range(comp)]
    big = []
    for s in range(comp):
        big.append(u[s] > d[s][1])
        for t in range(s + 1, comp):
            qt, w = d[t][0], d[s][4 + 2 * t]
            u[t] = ((u[t] - u[s]) * w + big[s]) % qt
    k = keep.reshape(keep.shape[0], -1, 1)          # [L, 1 + 3 comp, 1]
    p = k[:, 0]
    acc = torch.zeros((x.shape[0], keep.shape[0], x.shape[2]), dtype=I64,
                      device=x.device)
    for s in range(comp):
        acc += u[s][:, None] * k[:, 1 + 3 * s] % p
        acc -= big[s][:, None] * k[:, 3 + 3 * s]
    return (acc % p).to(I32)


def rescale_lift(coeffs, drop, keep) -> torch.Tensor:
    """The combined lift of the dropped rows on every kept row (module
    docstring): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    cuda_lib.residues("rescale_lift", "coeffs", coeffs, 3)
    K, comp, n = coeffs.shape
    L = keep.shape[0] if keep.dim() == 2 else -1
    cuda_lib.tables("rescale_lift", coeffs.device,
                    drop=(drop, (comp, 4 + 2 * comp)),
                    keep=(keep, (L, 1 + 3 * comp)))
    if not 1 <= comp <= MAX_COMP:
        raise ValueError(f"rescale_lift: {comp} dropped rows, not 1 to "
                         f"{MAX_COMP}")
    if not cuda_lib.kernel_device("rescale_lift", coeffs.device):
        return rescale_lift_t(coeffs, drop, keep)
    if n % 4:
        raise ValueError(f"rescale_lift: n = {n} is not a multiple of 4")
    out = torch.empty((K, L, n), dtype=I32, device=coeffs.device)
    if out.numel():
        cuda_lib.launch("rescale_lift", coeffs.device, coeffs.data_ptr(),
                        drop.data_ptr(), keep.data_ptr(), out.data_ptr(), K,
                        comp, L, n)
    return out
