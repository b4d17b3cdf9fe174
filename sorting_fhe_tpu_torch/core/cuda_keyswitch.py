"""The key switch's second half: the inner product of the hoisted digits
with the key-switching key, and ModDown's tail.  The hand-written kernels
(csrc/keyswitch.cu) and their plain versions.

    ks_inner:      acc[c, r] = (sum_j e_j[r, perm] * key[j, c, kr(r)])
                               * 2^-32  mod p[r]
    moddown_tail:  out[b, r] = (acc_q[b, r] - conv[b, r]) * pinv[r]  mod p[r]

`exts` is int32 [ndig, E, n]: a level's hoisted digits in the NTT and
Montgomery domain on its E ext rows, `lq` q rows and then E - lq special
rows.  `key` is int32 [>= ndig, 2, KR, n], the key as it is kept: ext row
r < lq reads the key's row r and special row s its row kq + s, so the
key's rows are selected where they lie (kq: the key's q rows, nq on one
device, a slot's block on a mesh).  `p` and `rinv` (int64 [E]) are the
ext rows' primes and 2^-32 mod each.  `perm` (int64 [n], a permutation of
the columns; None for relinearisation) is the automorphism the digits are
read through.  `ks_inner` returns the canonical int32 q rows [2, lq, n] and
special rows [2, E - lq, n], each contiguous.  `moddown_tail` takes int32
[K, l, n] canonical residues and int64 [l] `p` and `pinv` and returns int32
[K, l, n]; `acc_q` may be the first l rows of a contiguous [K, la, n],
which the kernel reads in place.

Callers: the key switch (`_k_ks_moddown` in core/ckks.py: relinearisation,
rotations, conjugation, hoisted rotations) and the mesh's copies of it
(parallel/collective.py `_inner`, `_phase3`); `moddown_tail` also ends the
composite rescale (`_kj_rescale` in core/ckks.py, the mesh's
`_rescale_block`), on a ciphertext's kept rows in place.

Dispatch by core/cuda_lib.py's device rule: a CPU tensor takes the plain
version (`ks_inner_t`, `moddown_tail_t`: the int64 torch chains the key
switch ran before); a CUDA tensor launches the kernel or raises.  The
kernels are built into that module's library.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .rns import sub_mod

I32 = torch.int32
I64 = torch.int64


def ks_inner_t(exts, key, p, rinv, lq: int, kq: int, perm=None) -> tuple:
    """Plain version: per digit the key's rows joined, one product,
    remainder and add over [2, E, n] int64, then the factor 2^-32."""
    if perm is not None:
        exts = exts.index_select(-1, perm)
    ks = exts.shape[1] - lq
    pe = p.reshape(-1, 1)
    acc = None
    for j in range(exts.shape[0]):
        k = torch.cat([key[j, :, :lq], key[j, :, kq:kq + ks]], dim=1)
        term = exts[j][None].to(I64) * k
        term %= pe                                    # < p: the sum fits
        acc = term if acc is None else acc.add_(term)
    acc %= pe
    acc *= rinv.reshape(-1, 1)
    acc %= pe
    acc = acc.to(I32)
    return acc[:, :lq].contiguous(), acc[:, lq:].contiguous()


def moddown_tail_t(acc_q, conv, p, pinv) -> torch.Tensor:
    """Plain version: sub_mod, the product and the remainder in int64."""
    pe = p.reshape(-1, 1)
    return (sub_mod(acc_q, conv, pe) * pinv.reshape(-1, 1) % pe).to(I32)


def ks_inner(exts, key, p, rinv, lq: int, kq: int, perm=None) -> tuple:
    """The inner product of the digits with the key, times 2^-32 (module
    docstring): (q rows, special rows), the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    cuda_lib.residues("ks_inner", "exts", exts, 3)
    cuda_lib.residues("ks_inner", "key", key, 4, exts.device)
    ndig, E, n = exts.shape
    D, two, KR, kn = key.shape
    cuda_lib.tables("ks_inner", exts.device, p=(p, (E,)), rinv=(rinv, (E,)),
                    **({} if perm is None else {"perm": (perm, (n,))}))
    if two != 2 or kn != n or D < ndig:
        raise ValueError(f"ks_inner: key {tuple(key.shape)} for digits "
                         f"{tuple(exts.shape)}")
    if not 0 <= lq <= min(E, kq) or kq + E - lq > KR:
        raise ValueError(f"ks_inner: {lq} q rows of {E} and key rows from "
                         f"{kq} do not fit the key's {KR} rows")
    if not cuda_lib.kernel_device("ks_inner", exts.device):
        return ks_inner_t(exts, key, p, rinv, lq, kq, perm)
    if n < 4 or n & (n - 1):
        raise ValueError(f"ks_inner: n = {n} is not a power of two >= 4")
    buf = torch.empty(2 * E * n, dtype=I32, device=exts.device)
    out_q = buf[:2 * lq * n].view(2, lq, n)
    out_sp = buf[2 * lq * n:].view(2, E - lq, n)
    if E:                      # none: a mesh slot with no rows at this level
        cuda_lib.launch("ks_inner", exts.device, exts.data_ptr(),
                        key.data_ptr(), p.data_ptr(), rinv.data_ptr(),
                        None if perm is None else perm.data_ptr(),
                        out_q.data_ptr(), out_sp.data_ptr(), ndig, E, lq, kq,
                        KR, n)
    return out_q, out_sp


def moddown_tail(acc_q, conv, p, pinv) -> torch.Tensor:
    """(acc_q - conv) * pinv mod p (module docstring): the kernel on a
    CUDA tensor, the plain version on a CPU one.  `acc_q` may be a row
    view (cuda_lib.row_pitch)."""
    cuda_lib.residues("moddown_tail", "acc_q", acc_q, 3, row_view=True)
    cuda_lib.residues("moddown_tail", "conv", conv, 3, acc_q.device)
    if conv.shape != acc_q.shape:
        raise ValueError(f"moddown_tail: shapes differ: {tuple(acc_q.shape)}"
                         f", {tuple(conv.shape)}")
    K, l, n = acc_q.shape
    cuda_lib.tables("moddown_tail", acc_q.device, p=(p, (l,)),
                    pinv=(pinv, (l,)))
    if not cuda_lib.kernel_device("moddown_tail", acc_q.device):
        return moddown_tail_t(acc_q, conv, p, pinv)
    if n % 4:
        raise ValueError(f"moddown_tail: n = {n} is not a multiple of 4")
    out = torch.empty_like(conv)
    if out.numel():
        cuda_lib.launch("moddown_tail", acc_q.device, acc_q.data_ptr(),
                        conv.data_ptr(), p.data_ptr(), pinv.data_ptr(),
                        out.data_ptr(), K, l, cuda_lib.row_pitch(acc_q), n)
    return out
