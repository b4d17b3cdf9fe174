"""The ring-2^18 tier of the torch port against the JAX package.

`registry._ring_for` gives every depth that does not fit HEStd-128 at ring
2^17 the ring 2^18: hybrid1 N=1024 (depth 56) and mehp24 N=2048.

Tier-1 (two tests, host only, no JAX compile):
- hybrid1 N=1024's registry entry, full config and prime chain (115 q +
  39 special primes, dnum 3, logQP 4477 of 7101) equal the JAX package's,
  and the n = 2^18 NTT tables of two of its primes equal the JAX host
  tables bit for bit;
- hybrid1 N=1024 on each package's PlainContext at ring 2^18 (the bench's
  minimal keys and sign config) gives the same output with the same census
  of context calls, within 0.01 of np.sort.

`slow` (deselected in tier-1): encrypt, mult_relin, rescale and a rotation
on a short ring-2^18 chain with host-PRNG keys, bit-equal to the JAX
package (a JAX compile at a new shape).  The kernels at the chain's
largest class, [3, 154, 2^18], are checked on the card by
tests/test_torch_cuda.py.
"""

import collections
from dataclasses import asdict

import numpy as np
import pytest
import torch

from sorting_fhe_tpu import registry as jreg
from sorting_fhe_tpu.core import params as jparams
from sorting_fhe_tpu.core.ntt import NttContext as JNtt
from sorting_fhe_tpu.models.direct_sort import DirectSort as JDirectSort
from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.core import params as tparams
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.core.ntt import NttContext as TNtt
from sorting_fhe_tpu_torch.models.direct_sort import DirectSort as TDirectSort
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

torch.set_num_threads(1)   # one thread per test worker: six share the cores

ALGO, N = "hybrid1", 1024
CENSUS_OPS = ("rotate", "fast_rotation", "fast_rotation_precompute", "mult",
              "square", "mult_plain", "mult_scalar", "add", "sub", "rsub",
              "make_plaintext", "rotate_plaintext", "rescale",
              "level_reduce")
TABLES = ("psi", "psi_sh", "ipsi", "ipsi_sh", "n_inv", "n_inv_sh")


def test_ring18_chain_matches_jax(monkeypatch):
    jp, tp = jreg.get_params(ALGO, N), treg.get_params(ALGO, N)
    assert jp.ring_dim_full == tp.ring_dim_full == 1 << 18
    for reg in (jreg, treg):
        assert reg.get_params("mehp24", 2048).ring_dim_full == 1 << 18
    jcfg, tcfg = jreg.full_config(jp), treg.full_config(tp)
    assert tparams.CkksConfig(**asdict(jcfg)) == tcfg
    assert (tcfg.ring_dim, tcfg.mult_depth, tcfg.dnum) == (1 << 18, 56, 3)
    # the chain needs the primes only; the whole chain's tables are 0.65 GB
    monkeypatch.setattr(jparams, "NttContext", lambda *a, **kw: None)
    monkeypatch.setattr(tparams, "NttContext", lambda *a, **kw: None)
    J, T = jparams.CkksParams(jcfg), tparams.CkksParams(tcfg, "cpu")
    assert list(T.q) == list(J.q) and len(T.q) == 115
    assert list(T.p_special) == list(J.p_special) and len(T.p_special) == 39
    assert T.alpha == J.alpha and T.canonical_scale == J.canonical_scale
    assert treg.security_check(tcfg, T) == jreg.security_check(jcfg, J) \
        == (4477, 7101, True)
    primes, n = [T.q[0], T.p_special[-1]], tcfg.ring_dim
    tc, jc = TNtt(primes, n, "cpu"), JNtt(primes, n)
    for name in TABLES:
        np.testing.assert_array_equal(
            getattr(tc, name).numpy().view(np.uint32), jc._host[name], name)


def _census_context(Plain, ring: int):
    """A PlainContext that counts its calls by name in `ctx.calls`."""
    ctx = Plain(ring)
    ctx.calls = collections.Counter()
    for name in CENSUS_OPS:
        def counted(*args, _fn=getattr(ctx, name), _name=name, **kw):
            ctx.calls[_name] += 1
            return _fn(*args, **kw)
        setattr(ctx, name, counted)
    return ctx


def _plain_sort(DS, reg, Plain, vals):
    """The bench's sort at the registry's ring: minimal keys, registry
    sign config."""
    p = reg.get_params(ALGO, N)
    ctx = _census_context(Plain, p.ring_dim_full)
    ds = DS(ctx, N, rot_indices=list(p.rotations), use_minimal_keys=True)
    out = ds.sort_hybrid1(ctx.encrypt(vals, slots=N), p.sign_config())
    return ctx.decrypt(out)[:N], ctx


def test_hybrid1_n1024_plain_matches_jax():
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(42))
    jout, jctx = _plain_sort(JDirectSort, jreg, JPlain, vals)
    tout, tctx = _plain_sort(TDirectSort, treg, TPlain, vals)
    np.testing.assert_array_equal(tout, jout)
    assert tctx.calls == jctx.calls
    assert (tctx.mult_count, tctx.rot_count) == \
        (jctx.mult_count, jctx.rot_count) == (2688, 1218)
    assert np.abs(tout - np.sort(vals)).max() < 0.01


@pytest.mark.slow
def test_ring18_ops_bit_equal_to_jax():
    """A chain of 7 q + 4 special primes at ring 2^18 (the registry's
    56-bit levels), limb_pad 1; the same host-PRNG keys and encryptions."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
    cfg = dict(ring_dim=1 << 18, mult_depth=2, scale_bits=56, comp=2,
               dnum=2, seed=11, limb_pad=1)
    v, w = np.linspace(0.1, 0.9, 8), np.linspace(0.9, 0.1, 8)
    runs = []
    for ctx in (JC(jparams.CkksConfig(**cfg)),
                TC(tparams.CkksConfig(**cfg), device="cpu")):
        ctx.gen_rotation_keys([1])
        a, b = ctx.encrypt(v, slots=8), ctx.encrypt(w, slots=8)
        m = ctx.mult(a, b)
        r = ctx.rotate(ctx.rescale(m), 1)
        runs.append((a, m, r, np.asarray(ctx.decrypt(r))[:8]))
    (ja, jm, jr, jv), (ta, tm, tr, tv) = runs
    for jx, tx in ((ja, ta), (jm, tm), (jr, tr)):
        np.testing.assert_array_equal(np.asarray(jx.data),
                                      residues_to_numpy(tx.data))
    np.testing.assert_array_equal(tv, jv)
    assert np.abs(tv - np.roll(v * w, -1)).max() < 1e-2
