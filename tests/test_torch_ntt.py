"""The port's NTT (plain versions of K1/K2 and the CPU side of their
wrappers) is bit-equal to the JAX package's, both its jnp path and its
Pallas kernels in interpret mode.  The CUDA kernels themselves are held to
the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Mirrors tests/test_pallas_ntt.py: full prefix, row subset [4, 1, 5],
batched leading dims, round trip.
"""

import sys
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sorting_fhe_tpu.core import nt
from sorting_fhe_tpu.core.ntt import NttContext as JNtt
from sorting_fhe_tpu.core import ntt as jntt
from sorting_fhe_tpu.core.pallas_ntt import ntt_fwd_pallas, ntt_inv_pallas
from sorting_fhe_tpu_torch.core import cuda_ntt
from sorting_fhe_tpu_torch.core.ntt import NttContext as TNtt
from sorting_fhe_tpu_torch.core.ntt import ntt_fwd_t, ntt_inv_t

torch.set_num_threads(1)   # one thread per test worker: six share the cores


# one XLA compile per shape instead of one per eager stage op
j_fwd = jax.jit(jntt.ntt_fwd_t)
j_inv = jax.jit(jntt.ntt_inv_t)


def _rand(rng, primes, n, lead=()):
    """Canonical residues [*lead, len(primes), n] as uint32."""
    return np.stack([rng.integers(0, p, size=lead + (n,),
                                  dtype=np.uint64).astype(np.uint32)
                     for p in primes], axis=len(lead))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("logn", [8, 11])
def test_plain_ntt_matches_jax(logn):
    """Full prefix rows: tables, forward, inverse and the round trip, for
    the plain versions and the wrappers' CPU path."""
    n = 1 << logn
    primes = nt.find_ntt_primes(28, 5, n)
    jc, tc = JNtt(primes, n), TNtt(primes, n, "cpu")
    np.testing.assert_array_equal(_np(tc.psi), np.asarray(jc.psi))
    np.testing.assert_array_equal(_np(tc.ipsi_sh), np.asarray(jc.ipsi_sh))
    rng = np.random.default_rng(7)
    x = _rand(rng, primes, n)
    rows = torch.arange(len(primes), dtype=torch.int32)

    want = np.asarray(j_fwd(jnp.asarray(x), jc.p, jc.psi, jc.psi_sh))
    got = ntt_fwd_t(_t(x), tc.p, tc.psi)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(cuda_ntt.ntt_fwd(_t(x), tc, rows)),
                                  want)
    winv = np.asarray(j_inv(jnp.asarray(want), jc.p, jc.ipsi, jc.ipsi_sh,
                            jc.n_inv, jc.n_inv_sh))
    ginv = ntt_inv_t(got, tc.p, tc.ipsi, tc.n_inv)
    np.testing.assert_array_equal(_np(ginv), winv)
    np.testing.assert_array_equal(_np(ginv), x)
    np.testing.assert_array_equal(_np(cuda_ntt.ntt_inv(got, tc, rows)), x)


def test_row_subset_lead_dims_match_pallas_interpret():
    """Non-prefix rows [4, 1, 5] with [k, L, n] leading dims through the
    wrappers' CPU path equal the Pallas kernels run in interpret mode (and
    per-row jnp calls), forward and inverse."""
    n = 256
    primes = nt.find_ntt_primes(28, 6, n)
    jc, tc = JNtt(primes, n), TNtt(primes, n, "cpu")
    rng = np.random.default_rng(3)
    sel = np.array([4, 1, 5], dtype=np.int32)
    x = _rand(rng, [primes[r] for r in sel], n, lead=(2,))      # [2, 3, n]
    pk, jsel, tsel = jc.pallas_tables(), jnp.asarray(sel), torch.from_numpy(sel)
    want = np.asarray(ntt_fwd_pallas(jnp.asarray(x), pk, jsel,
                                     interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(j_fwd(jnp.asarray(x), jc.p[sel], jc.psi[sel],
                               jc.psi_sh[sel])))
    got = cuda_ntt.ntt_fwd(_t(x), tc, tsel)
    np.testing.assert_array_equal(_np(got), want)
    winv = np.asarray(ntt_inv_pallas(jnp.asarray(want), pk, jsel,
                                     interpret=True))
    back = cuda_ntt.ntt_inv(got, tc, tsel)
    np.testing.assert_array_equal(_np(back), winv)
    np.testing.assert_array_equal(_np(back), x)


def test_wrapper_cpu_path_launches_nothing_and_checks_inputs():
    n = 256
    primes = nt.find_ntt_primes(28, 2, n)
    tc = TNtt(primes, n, "cpu")
    rows = torch.arange(2, dtype=torch.int32)
    x = torch.zeros((2, n), dtype=torch.int32)
    cuda_ntt.reset_launch_counts()
    cuda_ntt.ntt_fwd(x, tc, rows)
    cuda_ntt.ntt_inv(x, tc, rows)
    assert cuda_ntt.ntt_fwd.launches == 0
    assert cuda_ntt.ntt_inv.launches == 0
    assert cuda_ntt._lib is None        # nothing was built or loaded
    with pytest.raises(TypeError):
        cuda_ntt.ntt_fwd(x.long(), tc, rows)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((n, 2), dtype=torch.int32).t(), tc,
                         rows)                            # not contiguous
    with pytest.raises(ValueError):
        cuda_ntt.ntt_inv(x, tc, rows[:1])                 # rows mismatch


def test_port_imports_without_jax_or_nvcc():
    code = ("import sys; import sorting_fhe_tpu_torch.models.direct_sort; "
            "import sorting_fhe_tpu_torch.core.cuda_ntt as c; "
            "import sorting_fhe_tpu_torch.bench; "
            "assert 'jax' not in sys.modules, 'port imported jax'; "
            "assert c._lib is None")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
