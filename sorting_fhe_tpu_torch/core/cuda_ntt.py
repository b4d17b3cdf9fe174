"""Wrappers for the hand-written Hopper NTT kernels (csrc/ntt.cu).

Counterpart of sorting_fhe_tpu/core/pallas_ntt.py:

  K1 `ntt_fwd(x, tabs, rows)`  replaces ntt_fwd_pallas / _fwd_kernel
  K2 `ntt_inv(x, tabs, rows)`  replaces ntt_inv_pallas / _inv_kernel

`x` is int32 [..., L, n] (canonical residues), `tabs` the NttContext of the
whole chain, `rows` an int32 [L] tensor naming the chain row (prime and
twiddle row) of each of the L limbs.  The result is a new int32 tensor in
the same order as the plain versions ntt.ntt_fwd_t / ntt_inv_t.

Dispatch is on the tensor's device: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.  There is no fallback from
the kernel to the plain version.  Rings up to 2^18 (MAX_LOGN) are taken.

Each call is at most two kernel launches (csrc/ntt.cu: a column pass over
[R, C] tiles and a chunk pass).  The C side plans them; `launch_plan`
reads that plan back from the built library.

The kernels are built into core/cuda_lib.py's library, which launches and
counts them.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .ntt import NttContext, ntt_fwd_t, ntt_inv_t

MAX_LOGN = 18              # the ring-2^18 tier: 7 column stages
PLAN_KEYS = ("logc", "logw", "col_blocks", "chunk_blocks", "col_smem",
             "chunk_smem")


def launch_plan(limbs: int, logn: int) -> dict:
    """The kernels' launch plan for `limbs` limbs of 2^logn residues, as
    the built library computes it (make_plan in csrc/ntt.cu): chunk
    2^logc, column tile width 2^logw, blocks and dynamic shared-memory
    bytes of each pass (no column pass when logn <= logc)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = cuda_lib.build().ntt_plan(limbs, logn, out)
    if err:
        raise ValueError(f"ntt_plan({limbs}, {logn}): cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def _check(x: torch.Tensor, tabs: NttContext, rows: torch.Tensor) -> bool:
    """Raise on what neither version takes; True where the kernel runs."""
    cuda_lib.residues("NTT", "input", x)
    if x.dim() < 2 or x.shape[-1] != tabs.n:
        raise ValueError(f"NTT input must be [..., L, {tabs.n}], "
                         f"got {tuple(x.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 1 \
            or rows.numel() != x.shape[-2]:
        raise ValueError(f"rows must be int32 [{x.shape[-2]}], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device != x.device or tabs.p.device != x.device:
        raise ValueError(f"devices differ: x {x.device}, rows "
                         f"{rows.device}, tables {tabs.p.device}")
    if not cuda_lib.kernel_device("NTT", x.device):
        return False
    if tabs.logn > MAX_LOGN:
        raise ValueError(f"ring 2^{tabs.logn} is above the kernels' "
                         f"2^{MAX_LOGN}")
    return True


def _dims(x: torch.Tensor, tabs: NttContext) -> tuple:
    """The launch functions' trailing arguments: L, LP, limbs, logn."""
    return x.shape[-2], len(tabs.primes), x.numel() // tabs.n, tabs.logn


def ntt_fwd(x: torch.Tensor, tabs: NttContext,
            rows: torch.Tensor) -> torch.Tensor:
    """K1: forward negacyclic NTT of every limb of x (natural ->
    bit-reversed order)."""
    if not _check(x, tabs, rows):
        r = rows.long()
        return ntt_fwd_t(x, tabs.p[r], tabs.psi[r])
    out = torch.empty_like(x)
    cuda_lib.launch("ntt_fwd", x.device, x.data_ptr(), out.data_ptr(),
                    rows.data_ptr(), tabs.p.data_ptr(), tabs.psi.data_ptr(),
                    tabs.psi_sh.data_ptr(), *_dims(x, tabs))
    return out


def ntt_inv(x: torch.Tensor, tabs: NttContext,
            rows: torch.Tensor) -> torch.Tensor:
    """K2: inverse negacyclic NTT of every limb of x (bit-reversed ->
    natural order), n^-1 included."""
    if not _check(x, tabs, rows):
        r = rows.long()
        return ntt_inv_t(x, tabs.p[r], tabs.ipsi[r], tabs.n_inv[r])
    out = torch.empty_like(x)
    cuda_lib.launch("ntt_inv", x.device, x.data_ptr(), out.data_ptr(),
                    rows.data_ptr(), tabs.p.data_ptr(), tabs.ipsi.data_ptr(),
                    tabs.ipsi_sh.data_ptr(), tabs.n_inv.data_ptr(),
                    tabs.n_inv_sh.data_ptr(), *_dims(x, tabs))
    return out
