"""The torch port's CKKS ops are bit-equal to the JAX package's jitted ops.

Both contexts are built without keygen (`_init_common`), so their tables
and rescale constants come from the same config.  Random canonical
residues from one numpy seed stand in for ciphertexts and for the
key-switching key (parity needs no real key); the JAX op and the port's
op must return the same residues.  The port's relinearisation and
rotations are the context's own (`_relin`, `_fast_rotate`), which every
mult, square, rotation and conjugation runs, with the random key set as
its relinearisation key and pinned as its rotation key 1.  Key generation is checked on its own:
the same seed gives the same public and relinearization keys.

Ring 2^12 (not smaller): the JAX package's prime-pool scan for the
composite chain grows as 1/ring and costs tens of seconds below 2^11.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sorting_fhe_tpu.core import ckks as jck
from sorting_fhe_tpu.core.keys import Encryptor as JEncryptor
from sorting_fhe_tpu.core.keys import KeyGenerator as JKeyGen
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu_torch.core import ckks as tck
from sorting_fhe_tpu_torch.core.interop import (keys_to_torch,
                                                residues_to_numpy,
                                                residues_to_torch)
from sorting_fhe_tpu_torch.core.keys import Encryptor as TEncryptor
from sorting_fhe_tpu_torch.core.keys import KeyGenerator as TKeyGen
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CFG = dict(ring_dim=1 << 12, mult_depth=4, scale_bits=52, comp=2, dnum=2,
           seed=11, limb_pad=1)


@pytest.fixture(scope="module")
def ctxs():
    j = jck.CkksContext.__new__(jck.CkksContext)
    j._init_common(JCfg(**CFG))
    t = tck.CkksContext.__new__(tck.CkksContext)
    t._init_common(TCfg(**CFG), "cpu")
    return j, t


def _residues(rng, primes, lead, n):
    """uint32 [*lead, len(primes), n], row r uniform mod primes[r]."""
    p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    return (rng.integers(0, 1 << 62, size=lead + (len(primes), n),
                         dtype=np.uint64) % p).astype(np.uint32)


def _eq(jax_out, torch_out, what):
    np.testing.assert_array_equal(np.asarray(jax_out),
                                  residues_to_numpy(torch_out), what)


def test_ops_bit_equal(ctxs):
    j, t = ctxs
    P = t.params
    n, l = P.n, P.nq - 2            # ragged digits: alpha=6, l=9 -> 6 + 3
    rng = np.random.default_rng(2024)
    a = _residues(rng, P.q[:l], (2,), n)
    b = _residues(rng, P.q[:l], (2,), n)
    ksk = _residues(rng, P.all_primes, (P.cfg.dnum, 2), n)
    ja, jb, jk = jnp.asarray(a), jnp.asarray(b), jnp.asarray(ksk)
    ta, tb, tk = (residues_to_torch(x, "cpu") for x in (a, b, ksk))
    JT, TT = j.tables(l), t.tables(l)
    jperm, tperm = j._perm(1), t._perm(1)
    np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())

    # composite rescale: JAX keeps the bucket's rows, the port drops them
    got = tck._kj_rescale(ta, t._rescale_consts(l), TT)
    want = jck._kj_rescale(ja, j._rescale_consts(l), JT)
    _eq(want[:, :l - 2], got, "rescale")
    # the port's side is the context's own composition, over its keys
    t.relin_key = tk
    t.rot_keys[1] = tk
    _eq(jck._kj_mult_relin(ja, jb, jk, JT),
        t._relin(tck._k_mult3(ta, tb, TT.q_p, TT.q_rinv), l), "mult_relin")
    _eq(jck._kj_rotate_fused(ja, jk, jperm, JT),
        t._fast_rotate(ta, t._decompose(ta[1], l), 1, l), "rotate_fused")
    jpre, tpre = jck._kj_decompose(ja[1], JT), t._decompose(ta[1], l)
    _eq(jpre, tpre, "decompose")
    _eq(jck._kj_fast_rotate(ja, jpre, jk, jperm, JT),
        t._fast_rotate(ta, tpre, 1, l), "fast_rotate")

    rows = _residues(rng, P.q[:l], (), n)
    rmod = np.array([(1 << 32) % p for p in P.q[:l]], dtype=np.uint32)
    rsh = np.array([(int(r) << 32) // p for r, p in zip(rmod, P.q[:l])],
                   dtype=np.uint32)
    _eq(jck._kj_encode(jnp.asarray(rows), jnp.asarray(rmod),
                       jnp.asarray(rsh), JT),
        tck._kj_encode(residues_to_torch(rows, "cpu"), TT.rmod, TT),
        "encode")


def test_keygen_bit_equal():
    """Same seed, same draw order: identical public and relin keys, and
    identical encryptions of the same coefficients (float64 and big
    integers)."""
    jp = jck.CkksParams(JCfg(**CFG))
    tp = tck.CkksParams(TCfg(**CFG), "cpu")
    jg, tg = JKeyGen(jp, seed=5), TKeyGen(tp, seed=5)
    pk, relin, _, _ = keys_to_torch(jg.public_key,
                                    np.asarray(jg.gen_relin_key()), {},
                                    device="cpu")
    for jx, tx in zip(pk, tg.public_key):
        np.testing.assert_array_equal(jx, tx)
    assert torch.equal(relin, tg.gen_relin_key())
    je, te = JEncryptor(jp, jg.public_key), TEncryptor(tp, tg.public_key)
    coeffs = np.rint(np.random.default_rng(3).normal(0, 2.0 ** 60, tp.n))
    for c in (coeffs, coeffs.astype(np.int64).astype(object) * 3 ** 40):
        _eq(je.encrypt_coeffs(c), te.encrypt_coeffs(c), "encrypt")
