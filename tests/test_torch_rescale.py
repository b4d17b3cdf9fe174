"""The composite rescale as one composition (core/ckks.py `_kj_rescale`:
the dropped rows' inverse NTT, `cuda_rescale.rescale_lift`, one forward
NTT, `moddown_tail` on the kept rows in place) against the two-step chain
it replaced and against the JAX package's `_k_rescale`, on one device and
on the row-sharded evaluator.

`old_rescale` below is that chain as it stood: per dropped prime q_d, the
row's inverse NTT, its centred lift onto every kept row in int64, a
forward NTT of the kept rows, then (x - lift) * q_d^-1.  The new
composition must equal it and the JAX op bit for bit (every step is exact
modular arithmetic) for ciphertexts of 2 and 3 polys at the top level, a
middle level and the lowest level a rescale may start from (base_limbs +
comp), at comp = 2, on random residues whose dropped rows also hold
coefficients at the centring edge (0, q // 2, q // 2 + 1, q - 1).  The
mesh's `_rescale_block` runs the same composition on each slot's kept
rows: 4 virtual CPU slots, torch.equal to one device.  The CUDA kernel
against its plain version is in tests/test_torch_cuda.py.

Ring 2^12 as tests/test_torch_ckks.py (the JAX package's prime scan costs
tens of seconds below 2^11).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sorting_fhe_tpu.core import ckks as jck
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu_torch.core import ckks as tck
from sorting_fhe_tpu_torch.core import cuda_keyswitch, cuda_lib, nt
from sorting_fhe_tpu_torch.core import cuda_rescale
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
from sorting_fhe_tpu_torch.core.rns import sub_mod
from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
from sorting_fhe_tpu_torch.parallel.mesh import make_mesh, split_rows

torch.set_num_threads(1)   # one thread per test worker: six share the cores

I32, I64 = torch.int32, torch.int64
CFG = dict(ring_dim=1 << 12, mult_depth=4, scale_bits=52, comp=2, dnum=2,
           seed=11, limb_pad=1)
NQ, BASE = 11, 3            # the chain's q rows and base_limbs
LEVELS = {"top": NQ, "middle": 7, "lowest": BASE + 2}
SLOTS = 4


@pytest.fixture(scope="module")
def ctxs():
    j = jck.CkksContext.__new__(jck.CkksContext)
    j._init_common(JCfg(**CFG))
    t = tck.CkksContext.__new__(tck.CkksContext)
    t._init_common(TCfg(**CFG), "cpu")
    assert (t.params.nq, t.params.base_limbs) == (NQ, BASE)
    return j, t


def old_consts(P, l):
    """The chain's constants: per step (idx, 2^-32 mod q_d, q_d, q_d // 2,
    q_d mod and q_d^-1 mod each row below l)."""
    q, steps = P.q, []
    for i in range(P.comp):
        qd = q[l - i - 1]
        qd_mod = np.zeros(l, dtype=np.int64)
        qdinv = np.zeros(l, dtype=np.int64)
        for r in range(l - i - 1):
            qd_mod[r] = qd % q[r]
            qdinv[r] = nt.mod_inverse(qd % q[r], q[r])
        steps.append((l - i - 1, nt.mod_inverse((1 << 32) % qd, qd), qd,
                      qd // 2, torch.from_numpy(qd_mod),
                      torch.from_numpy(qdinv)))
    return steps


def old_rescale(data, steps, T):
    """The two-step int64 chain the composition replaced."""
    for idx, rinv, qd, half, qd_mod, qdinv in steps:
        lc = tck.ntt_inv(tck._i32(data[:, idx:idx + 1]), T.ntt,
                         T.rows_q[idx:idx + 1])
        v = lc.to(I64) * rinv % qd
        p = tck._col(T.q_p[:idx])
        r = v % p
        r = torch.where(v > half, sub_mod(r, tck._col(qd_mod[:idx]), p), r)
        rn = tck._fwd_q(r * tck._col(T.rmod[:idx]) % p, T, idx)
        data = (sub_mod(data[:, :idx], rn, p) * tck._col(qdinv[:idx])
                % p).to(I32)
    return data


def _data(rng, t, k, l):
    """int32 [k, l, n] residues in the NTT+Montgomery domain; the dropped
    rows' coefficients are drawn half from the centring edge."""
    P, n = t.params, t.n
    p = np.asarray(P.q[:l], dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, size=(k, l, n), dtype=np.uint64)
         % p).astype(np.uint32)
    x = torch.from_numpy(x.view(np.int32))
    T = t.tables(l)
    for d in range(l - P.comp, l):
        q = P.q[d]
        edge = np.array([0, q // 2, q // 2 + 1, q - 1], dtype=np.int64)
        v = np.where(rng.random((k, n)) < 0.5, edge[rng.integers(0, 4,
                                                                 (k, n))],
                     rng.integers(0, q, (k, n)))
        mont = torch.from_numpy(v * ((1 << 32) % q) % q)[:, None]
        x[:, d:d + 1] = tck.ntt_fwd(mont.to(I32).contiguous(), T.ntt,
                                    T.rows_q[d:d + 1])
    return x


@pytest.mark.parametrize("level", list(LEVELS))
def test_rescale_equals_old_chain_and_jax(ctxs, level):
    """For k = 2 and 3: CkksContext._rescale_data (the composition) ==
    old_rescale == JAX _kj_rescale's kept rows; on the CPU no kernel
    launches."""
    j, t = ctxs
    l = LEVELS[level]
    rng = np.random.default_rng(l)
    cuda_lib.reset()
    for k in (2, 3):
        x = _data(rng, t, k, l)
        got = t._rescale_data(x, l)
        assert got.dtype == I32 and got.shape == (k, l - 2, t.n)
        assert torch.equal(got, old_rescale(x, old_consts(t.params, l),
                                            t.tables(l))), (level, k)
        want = jck._kj_rescale(jnp.asarray(residues_to_numpy(x)),
                               j._rescale_consts(l), j.tables(l))
        np.testing.assert_array_equal(np.asarray(want)[:, :l - 2],
                                      residues_to_numpy(got), f"k={k}")
    assert sum(cuda_lib.launches.values()) == 0


def test_mesh_rescale_equals_one_device(ctxs):
    """ShardedContext._rescale_data on 4 virtual CPU slots (blocks of
    3/3/3/2 rows: the two dropped rows lie on one slot or on two, a slot
    keeps no row) gathered == one device at every level a rescale starts
    from, for k = 2 and 3, with a row view of a wider ciphertext as input;
    one "rescale" gather each.  Then the wrappers' checks."""
    _, t = ctxs
    P = t.params
    rng = np.random.default_rng(7)
    t.relin_key = torch.zeros((CFG["dnum"], 2, NQ + P.num_special, t.n),
                              dtype=I32)
    sctx = shard_context(t, make_mesh(devices=[torch.device("cpu")] * SLOTS))
    rescales = 0
    for l in range(NQ, BASE + 1, -2):
        for k in (2, 3):
            wide = _data(rng, t, k, NQ)
            x = wide[:, :l]                        # a row view, pitch NQ
            got = sctx._rescale_data(split_rows(x, sctx.mesh, NQ), l)
            rescales += 1
            full = torch.cat([b for b in got], dim=1)
            assert torch.equal(full, t._rescale_data(x, l)), (l, k)
            assert torch.equal(full, t._rescale_data(x.contiguous(), l))
    assert sctx.mesh.gathers["rescale"]["count"] == rescales

    drop, keep, pinv = t._rescale_consts(NQ)
    c = torch.zeros((2, 2, t.n), dtype=I32)
    with pytest.raises(TypeError):                 # int64 residues
        cuda_rescale.rescale_lift(c.long(), drop, keep)
    with pytest.raises(ValueError):                # tables of another comp
        cuda_rescale.rescale_lift(c[:, :1].contiguous(), drop, keep)
    with pytest.raises(ValueError):
        cuda_rescale.rescale_lift(c, drop, keep[:, :4].contiguous())
    a = torch.zeros((2, NQ, t.n), dtype=I32)
    q_p = t.tables(NQ).q_p
    cuda_keyswitch.moddown_tail(a[:, :4], a[:, :4].contiguous(),
                                q_p[:4].contiguous(), q_p[:4].contiguous())
    with pytest.raises(ValueError):                # not a row view
        cuda_keyswitch.moddown_tail(a[:, :, :8].transpose(1, 2),
                                    torch.zeros((2, 8, NQ), dtype=I32),
                                    q_p[:8].contiguous(),
                                    q_p[:8].contiguous())
    assert cuda_lib.row_pitch(a[:, :4]) == NQ
    assert cuda_lib.row_pitch(a[:, 1:4]) == NQ
    assert cuda_lib.row_pitch(a[:, :, :8]) is None
