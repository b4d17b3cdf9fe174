"""K1/K2 CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a CUDA device (a CUDA kernel has no CPU
mode).  This file imports no JAX, so it also runs where only the port is
installed:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core import cuda_ntt, nt
from sorting_fhe_tpu_torch.core.ntt import NttContext, ntt_fwd_t, ntt_inv_t

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("logn", [8, 12, 17])
def test_kernels_bit_equal_to_plain(device, logn):
    """Prefix rows, row subset [4, 1, 5] with a leading dim, single row;
    n = 2^8 and 2^12 run the shared-memory stages alone, 2^17 adds the
    device-memory stages."""
    n = 1 << logn
    primes = nt.find_ntt_primes(28, 6, n)
    tabs = NttContext(primes, n, device)
    rng = np.random.default_rng(logn)
    for sel, lead in ((list(range(6)), ()), ([4, 1, 5], (2,)), ([3], (2,))):
        p = np.asarray([primes[i] for i in sel], np.uint64).reshape(-1, 1)
        x = (rng.integers(0, 1 << 62, size=lead + (len(sel), n),
                          dtype=np.uint64) % p).astype(np.uint32)
        x = torch.from_numpy(x.view(np.int32)).to(device)
        rows = torch.tensor(sel, dtype=torch.int32, device=device)
        r = rows.long()
        before = cuda_ntt.ntt_fwd.launches
        f = cuda_ntt.ntt_fwd(x, tabs, rows)
        assert cuda_ntt.ntt_fwd.launches == before + 1
        assert torch.equal(f, ntt_fwd_t(x, tabs.p[r], tabs.psi[r]))
        i = cuda_ntt.ntt_inv(f, tabs, rows)
        assert torch.equal(i, ntt_inv_t(f, tabs.p[r], tabs.ipsi[r],
                                        tabs.n_inv[r]))
        assert torch.equal(i, x)


def test_kernel_rejects_bad_input(device):
    n = 1 << 8
    tabs = NttContext(nt.find_ntt_primes(28, 2, n), n, device)
    rows = torch.arange(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((2, n), dtype=torch.int32), tabs, rows)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((3, n), dtype=torch.int32,
                                     device=device), tabs, rows)
