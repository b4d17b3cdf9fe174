"""Where the port's tensors live.

Every entry point of the package (CkksContext, CkksParams, NttContext,
interop) defaults to the card and resolves its `device` argument here
first, before it builds anything.  Asking for CUDA where torch finds no
CUDA device raises; nothing falls back to the CPU.  Running on the CPU
(the tests, a laptop) is asked for with device="cpu".
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and there is no
    CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but torch finds no CUDA "
            "device; pass device=\"cpu\" to run on the CPU")
    return dev
