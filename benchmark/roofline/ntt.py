"""Bytes the negacyclic NTT kernels K1 (ntt_fwd) and K2 (ntt_inv) must
move for one call, from the call's logical shape [..., limbs, n]: every
residue read once and written once (4 bytes each), and each limb's
per-prime twiddle row and its Shoup companion read once (2 x n x 4
bytes).  The count does not depend on how many passes or launches the
transform takes, so it reads the same work whatever implements it."""

from __future__ import annotations

RESIDUE_BYTES = 4


def call_bytes(numel: int, limbs: int, n: int) -> int:
    """Bytes of one K1 or K2 call on `numel` residues of `limbs` limbs
    of ring 2^log2(n)."""
    return 2 * numel * RESIDUE_BYTES + 2 * limbs * n * RESIDUE_BYTES
