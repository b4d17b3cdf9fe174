"""Key material and ciphertexts between the JAX package and this one.

The JAX package keeps residues as uint32 arrays (keys, Ciphertext.data) or
uint64 host arrays (the public key); this package keeps int32 tensors with
the same bits.  Residues are below 2^31, so the conversion is a
reinterpretation, exact both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def residues_to_torch(arr, device="cuda") -> torch.Tensor:
    """uint32 (or uint64 < 2^31) residue array -> int32 tensor on device."""
    device = resolve_device(device)
    a = np.asarray(arr)
    if a.dtype == np.uint64:
        if a.size and int(a.max()) >= 1 << 31:
            raise ValueError("residues must be below 2^31")
        a = a.astype(np.uint32)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 residues, got {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()
                            ).to(device)


def residues_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> uint32 numpy array (the JAX package's bits)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def keys_to_torch(public_key, relin_key, rot_keys: dict, conj_key=None,
                  device="cuda"):
    """JAX-side key set -> (public key as host uint64 (b, a), relin key
    tensor, {rotation index: key tensor}, conjugation key tensor or None).
    The public key stays on the host, where the Encryptor uses it.  The
    way back is residues_to_numpy on each tensor."""
    device = resolve_device(device)
    b, a = public_key
    pk = (np.asarray(b, dtype=np.uint64), np.asarray(a, dtype=np.uint64))
    return (pk, residues_to_torch(relin_key, device),
            {int(k): residues_to_torch(v, device)
             for k, v in rot_keys.items()},
            None if conj_key is None else residues_to_torch(conj_key,
                                                            device))
