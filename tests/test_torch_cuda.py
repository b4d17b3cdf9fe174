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

torch.set_num_threads(1)   # one thread per test worker: six share the cores

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("logn", [8, 11, 12, 14, 17, 18])
def test_kernels_bit_equal_to_plain(device, logn):
    """Prefix rows, row subset [4, 1, 5] with a leading dim, a single
    dynamic row; n = 2^8 and 2^11 run the chunk pass alone, 2^12, 2^14,
    2^17 and 2^18 add a column pass of 1, 3, 6 and 7 stages at the 2^11
    chunk (calls too small to fill the card take the 2^10 chunk and one
    column stage more)."""
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


def test_kernels_at_ring18_chain(device):
    """The ring-2^18 tier's largest class, [3, 154, 2^18]: the top-level
    decompose of hybrid1 N=1024 (115 q + 39 special primes, dnum 3) on
    its registry chain's rows, bit-equal to the plain versions."""
    from sorting_fhe_tpu_torch.core.params import CkksParams
    from sorting_fhe_tpu_torch.registry import full_config, get_params
    P = CkksParams(full_config(get_params("hybrid1", 1024)), device)
    tabs, n, L = P.ntt, P.n, len(P.all_primes)
    assert (n, L, -(-P.nq // P.alpha)) == (1 << 18, 154, 3)
    p = np.asarray(P.all_primes, np.uint64).reshape(-1, 1)
    x = (np.random.default_rng(18).integers(0, 1 << 62, size=(3, L, n),
                                            dtype=np.uint64) % p)
    x = torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)
    rows = torch.arange(L, dtype=torch.int32, device=device)
    f = cuda_ntt.ntt_fwd(x, tabs, rows)
    assert torch.equal(f, ntt_fwd_t(x, tabs.p, tabs.psi))
    i = cuda_ntt.ntt_inv(f, tabs, rows)
    assert torch.equal(i, ntt_inv_t(f, tabs.p, tabs.ipsi, tabs.n_inv))
    assert torch.equal(i, x)


def test_launch_plan_covers_every_stage(device):
    """The library's plan for every ring the kernels take, at the limb
    counts of the main path's calls (rescale [2, 1, n], special primes
    [2, 24, n], decompose inverse [95, n], moddown/rescale forward
    [2, 95, n], decompose forward [4, 119, n]) and a single limb."""
    for logn in range(1, cuda_ntt.MAX_LOGN + 1):
        for limbs in (1, 2, 48, 95, 190, 476):
            pl = cuda_ntt.launch_plan(limbs, logn)
            logc, logw = pl["logc"], pl["logw"]
            logr = logn - logc
            # every stage once: log2(R) column stages + logc chunk stages
            assert logc == min(logn, 11) or (logc == 10 and logn > 11)
            assert pl["chunk_blocks"] << logc == limbs << logn
            if logr:
                assert 3 <= logw <= 6 and logw <= logc
                assert pl["col_blocks"] << logw == limbs << logc
                assert pl["col_smem"] >= 4 << (logr + logw)
            else:
                assert pl["col_blocks"] == 0 and logw == 0
            assert pl["chunk_smem"] >= 4 << logc
            # within the 48 KB a block takes without opting in
            assert max(pl["col_smem"], pl["chunk_smem"]) <= 48 * 1024
            # >= 132 blocks (one per H100 SM) wherever the shape has them
            if logn > 11 and limbs << (logn - 10) >= 132:
                assert pl["chunk_blocks"] >= 132
            if logr and limbs << 7 >= 132:
                assert pl["col_blocks"] >= 132


def test_kernel_rejects_bad_input(device):
    n = 1 << 8
    tabs = NttContext(nt.find_ntt_primes(28, 2, n), n, device)
    rows = torch.arange(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((2, n), dtype=torch.int32), tabs, rows)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((3, n), dtype=torch.int32,
                                     device=device), tabs, rows)
    n = 1 << 19                     # above the kernels' ring 2^18
    big = NttContext(nt.find_ntt_primes(28, 2, n), n, device)
    for fn in (cuda_ntt.ntt_fwd, cuda_ntt.ntt_inv):
        with pytest.raises(ValueError, match="2\\^18"):
            fn(torch.zeros((2, n), dtype=torch.int32, device=device), big,
               rows)
