"""RNS ops of the torch port are bit-equal to the JAX package's.

Random canonical residues from one numpy seed go through both; the JAX
uint32 results must equal the port's int32 results viewed as uint32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sorting_fhe_tpu.core import nt
from sorting_fhe_tpu.core import rns as jrns
from sorting_fhe_tpu_torch.core import rns as trns

torch.set_num_threads(1)   # one thread per test worker: six share the cores

N = 4096
# a 30-bit base prime, a 28-bit rescale-sized prime and a 2^31-edge prime
PRIMES = [nt.find_ntt_primes(30, 1, 1 << 10)[0],
          nt.find_ntt_primes(28, 1, 1 << 10)[0],
          max(nt.ntt_prime_pool(1 << 17))]


def _u32(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


def _consts(p):
    m = nt.montgomery_constants(p)
    return m["neg_p_inv"], nt.mod_inverse((1 << 32) % p, p)


@pytest.mark.parametrize("p", PRIMES)
def test_rns_ops_bit_equal(p):
    rng = np.random.default_rng(p % 1000)
    a = rng.integers(0, p, N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, p, N, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, p - 1]
    b[:3] = [p - 1, 0, p - 1]
    w = int(rng.integers(0, p))
    w_sh = (w << 32) // p
    npi, rinv = _consts(p)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(
        b.view(np.int32))
    pu = jnp.uint32(p)

    cases = {
        "add_mod": (jrns.add_mod(ja, jb, pu), trns.add_mod(ta, tb, p)),
        "sub_mod": (jrns.sub_mod(ja, jb, pu), trns.sub_mod(ta, tb, p)),
        "neg_mod": (jrns.neg_mod(ja, pu), trns.neg_mod(ta, p)),
        "mont_mul": (jrns.mont_mul(ja, jb, pu, jnp.uint32(npi)),
                     trns.mont_mul(ta, tb, p, rinv)),
        "shoup_mul": (jrns.shoup_mul(ja, jnp.uint32(w), jnp.uint32(w_sh), pu),
                      trns.shoup_mul(ta, w, p)),
    }
    for name, (want, got) in cases.items():
        np.testing.assert_array_equal(np.asarray(want), _u32(got), name)


@pytest.mark.parametrize("p", PRIMES)
def test_rns_full_range_ops_bit_equal(p):
    """mont_reduce and barrett_reduce_u32 take full-range uint32 words."""
    rng = np.random.default_rng(p % 997)
    hi = rng.integers(0, p, N, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    npi, rinv = _consts(p)
    pu = jnp.uint32(p)
    t = lambda v: torch.from_numpy(v.view(np.int32))
    want = jrns.mont_reduce(jnp.asarray(hi), jnp.asarray(lo), pu,
                            jnp.uint32(npi))
    np.testing.assert_array_equal(
        np.asarray(want), _u32(trns.mont_reduce(t(hi), t(lo), p, rinv)))
    want = jrns.barrett_reduce_u32(jnp.asarray(x), pu,
                                   jnp.uint32((1 << 32) // p))
    np.testing.assert_array_equal(
        np.asarray(want),
        _u32(trns.barrett_reduce_u32(t(x), p)))
