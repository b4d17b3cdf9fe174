"""Slice 1 as a whole: the hybrid1 sort through the torch port.

Tier-1: the port's DirectSort (minimal keys) on the port's PlainContext
at the main path's geometry (N=128, ring 2^17) gives the array the JAX
DirectSort gives on the JAX package's, and one encrypted step through the port's
CkksContext decrypts to the expected values.

`slow` (deselected in tier-1): a homomorphic step through both contexts
with bit-equal ciphertexts, and an encrypted hybrid1 N=4 sort with
bit-equal outputs and both within 0.01 of np.sort.
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff
from sorting_fhe_tpu import registry as jreg
from sorting_fhe_tpu.models.direct_sort import DirectSort as JDirectSort
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.models.direct_sort import DirectSort as TDirectSort
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain

torch.set_num_threads(1)   # one thread per test worker: six share the cores


def test_hybrid1_n128_plain_matches_jax():
    N, ring = 128, 1 << 17
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(42))
    outs = []
    for DS, reg, Plain in ((JDirectSort, jreg, JPlain),
                           (TDirectSort, treg, TPlain)):
        ctx = Plain(ring)
        ds = DS(ctx, N, use_minimal_keys=True)
        out = ds.sort_hybrid1(ctx.encrypt(vals, slots=N),
                              reg.get_params("hybrid1", N).sign_config())
        outs.append(ctx.decrypt(out)[:N])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert np.abs(outs[1] - np.sort(vals)).max() < 1e-2


def _step(ctx, v, w):
    """mult + rescale, hoisted and fused rotations, pt-mult, scalar add."""
    ctx.gen_rotation_keys([1, 2])
    a = ctx.encrypt(v, slots=4)
    b = ctx.encrypt(w, slots=4)
    m = ctx.rescale(ctx.mult(a, b))
    pre = ctx.fast_rotation_precompute(m)
    r = ctx.add(ctx.rotate(m, 1), ctx.fast_rotation(m, 2, pre))
    out = ctx.add(ctx.mult_plain(r, np.array([1.0, 0.5, 2.0, 1.0])), 0.25)
    return out, np.asarray(ctx.decrypt(out))[:4]


def _want(v, w):
    m = v * w
    return (np.roll(m, -1) + np.roll(m, -2)) * [1.0, 0.5, 2.0, 1.0] + 0.25


def test_encrypted_step_port():
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.core.params import CkksConfig
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=4,
                                 scale_bits=52, comp=2, dnum=2, seed=11),
                      device="cpu")
    v, w = np.linspace(0.1, 0.9, 4), np.linspace(0.9, 0.1, 4)
    _, got = _step(ctx, v, w)
    assert np.abs(got - _want(v, w)).max() < 1e-2
    assert ctx.op_counts["rotate_fused"] == 1
    assert ctx.op_counts["fast_rotate"] == 1


@pytest.mark.slow
def test_encrypted_step_bit_equal_to_jax():
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
    from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
    cfg = dict(ring_dim=1 << 8, mult_depth=4, scale_bits=52, comp=2, dnum=2,
               seed=11)
    v, w = np.linspace(0.1, 0.9, 4), np.linspace(0.9, 0.1, 4)
    jout, jv = _step(JC(JCfg(**cfg)), v, w)
    tout, tv = _step(TC(TCfg(**cfg), device="cpu"), v, w)
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    np.testing.assert_array_equal(jv, tv)
    assert np.abs(tv - _want(v, w)).max() < 1e-2


@pytest.mark.slow
def test_hybrid1_encrypted_n4_bit_equal_to_jax():
    """The test_hybrid1_encrypted_n4 config (ring 2^10, depth 31)."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu.ops.sign import (SignConfig as JS,
                                          CompositeSignConfig as JCS)
    from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
    from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
    from sorting_fhe_tpu_torch.ops.sign import (SignConfig as TS,
                                                CompositeSignConfig as TCS)
    cfg = dict(ring_dim=1 << 10, mult_depth=31, scale_bits=52, comp=2,
               dnum=6)
    N = 4
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(123))
    runs = []
    for C, Cfg, DS, S, CS, kw in ((JC, JCfg, JDirectSort, JS, JCS, {}),
                                  (TC, TCfg, TDirectSort, TS, TCS,
                                   {"device": "cpu"})):
        ctx = C(Cfg(**cfg), **kw)
        out = DS(ctx, N).sort_hybrid1(ctx.encrypt(vals, slots=N),
                                      S(CS(3, 2, 2)))
        runs.append((out, np.asarray(ctx.decrypt(out))[:N]))
    (jout, jv), (tout, tv) = runs
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    for got in (jv, tv):
        assert np.abs(got - np.sort(vals)).max() < 0.01, got
