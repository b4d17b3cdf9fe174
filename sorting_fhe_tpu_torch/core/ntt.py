"""Negacyclic NTT over RNS limbs: twiddle tables and the plain versions.

Forward transform: iterative Cooley-Tukey (decimation in time) with the
2n-th root psi merged into the twiddles (Longa–Naehrig form), natural input
order, bit-reversed output order.  Inverse: Gentleman–Sande, bit-reversed
input, natural output, with the final n^{-1} scaling fused as a multiply.
Same tables and element order as sorting_fhe_tpu/core/ntt.py, so the
outputs are bit-identical.

`ntt_fwd_t` / `ntt_inv_t` are the plain torch versions of the two
hand-written CUDA kernels in csrc/ntt.cu: core/cuda_ntt.py runs them for
CPU tensors, and chip_smoke.py holds the kernels against them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nt
from .device import resolve_device
from .rns import add_mod, sub_mod


def _dev_u32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host table -> int32 device tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


class NttContext:
    """Per-prime-chain twiddle tables, resident on `device`.

    Tables have shape [LP, n] (limb-major) and cover the whole chain; every
    level shares them and selects rows by index, so no per-level slices are
    pinned.  Values are the JAX package's uint32 tables stored as int32
    bit patterns (the Shoup companions use all 32 bits).
    """

    def __init__(self, primes: list[int], n: int, device="cuda"):
        dev = resolve_device(device)
        self.n = n
        self.logn = n.bit_length() - 1
        self.primes = list(primes)
        L = len(primes)
        psi = np.empty((L, n), dtype=np.uint32)
        psi_sh = np.empty((L, n), dtype=np.uint32)
        ipsi = np.empty((L, n), dtype=np.uint32)
        ipsi_sh = np.empty((L, n), dtype=np.uint32)
        n_inv = np.empty((L,), dtype=np.uint32)
        n_inv_sh = np.empty((L,), dtype=np.uint32)
        for i, p in enumerate(primes):
            tb = nt.make_ntt_tables(p, n)
            psi[i] = tb["psi_brv"]
            psi_sh[i] = tb["psi_brv_shoup"]
            ipsi[i] = tb["ipsi_brv"]
            ipsi_sh[i] = tb["ipsi_brv_shoup"]
            n_inv[i] = tb["n_inv"]
            n_inv_sh[i] = tb["n_inv_shoup"]
        self.p = _dev_u32(np.asarray(primes, dtype=np.uint32), dev)
        self.psi = _dev_u32(psi, dev)
        self.psi_sh = _dev_u32(psi_sh, dev)
        self.ipsi = _dev_u32(ipsi, dev)
        self.ipsi_sh = _dev_u32(ipsi_sh, dev)
        self.n_inv = _dev_u32(n_inv, dev)
        self.n_inv_sh = _dev_u32(n_inv_sh, dev)


def ntt_fwd_t(a: torch.Tensor, p, psi) -> torch.Tensor:
    """Forward negacyclic NTT with explicit tables (plain version of K1).

    a: int32 [..., L, n] canonical residues; p: [L]; psi: [L, n].  The
    products are exact in int64, so no Shoup companions are needed.
    Returns int32 [..., L, n], bit-reversed order.
    """
    L, n = a.shape[-2], a.shape[-1]
    lead = tuple(a.shape[:-2])
    pb = p.to(torch.int64).reshape(L, 1, 1)
    psi = psi.to(torch.int64)
    x = a.to(torch.int64)
    for s in range(n.bit_length() - 1):
        m = 1 << s
        t = n >> (s + 1)
        x = x.reshape(lead + (L, m, 2, t))
        w = psi[:, m:2 * m].reshape(L, m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :] * w % pb
        x = torch.stack([add_mod(u, v, pb), sub_mod(u, v, pb)], dim=-2)
    return x.reshape(lead + (L, n)).to(torch.int32)


def ntt_inv_t(a: torch.Tensor, p, ipsi, n_inv) -> torch.Tensor:
    """Inverse negacyclic NTT with explicit tables (plain version of K2):
    a: int32 [..., L, n] bit-reversed; ipsi: [L, n]; n_inv: [L]."""
    L, n = a.shape[-2], a.shape[-1]
    lead = tuple(a.shape[:-2])
    pb = p.to(torch.int64).reshape(L, 1, 1)
    ipsi = ipsi.to(torch.int64)
    x = a.to(torch.int64)
    for s in range(n.bit_length() - 1):
        h = n >> (s + 1)          # number of twiddle groups this stage
        t = n // (2 * h)          # butterfly width
        x = x.reshape(lead + (L, h, 2, t))
        w = ipsi[:, h:2 * h].reshape(L, h, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        lo = add_mod(u, v, pb)
        hi = sub_mod(u, v, pb) * w % pb
        x = torch.stack([lo, hi], dim=-2)
    x = x.reshape(lead + (L, n))
    ninv = n_inv.to(torch.int64).reshape(L, 1)
    return (x * ninv % pb.reshape(L, 1)).to(torch.int32)
