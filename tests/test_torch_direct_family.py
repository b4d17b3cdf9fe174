"""The direct family (models/direct_sort.py) through the torch port.

Tier-1: `sort` (direct), `sort_hybrid` and `sort_hybrid2` at N=128, and
`sort_hybrid1` and `sort_hybrid2` at N=512 (the N > 256 two-block path),
all at ring 2^17 with the bench's keys and sign configs, each package's
DirectSort on its own PlainContext: the port's gives exactly the JAX
DirectSort's output, with the same census of context calls, and within
0.01 of np.sort.

The port's registry puts each of these configurations, and the open
cells at N=256-2048, on a ring-2^17 chain within the HEStd-128 ceiling;
where its dnum differs from the JAX registry's, the JAX registry's chain
is over that ceiling.

`slow` (deselected in tier-1): an encrypted direct sort at N=4 gives
ciphertexts bit-equal to the JAX package's.
"""

import collections
from dataclasses import asdict

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff
from sorting_fhe_tpu import registry as jreg
from sorting_fhe_tpu.models.direct_sort import DirectSort as JDirectSort
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.core import params as tparams
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.models.direct_sort import DirectSort as TDirectSort
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain

torch.set_num_threads(1)   # one thread per test worker: six share the cores

SORT_FN = {"direct": "sort", "hybrid": "sort_hybrid",
           "hybrid1": "sort_hybrid1", "hybrid2": "sort_hybrid2"}
CENSUS_OPS = ("rotate", "fast_rotation", "fast_rotation_precompute", "mult",
              "square", "mult_plain", "mult_scalar", "add", "sub", "rsub",
              "make_plaintext", "rotate_plaintext", "rescale",
              "level_reduce")


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


def _plain_sort(DS, reg, Plain, algo, N):
    """The bench's sort: registry keys and sign config, minimal keys."""
    p = reg.get_params(algo, N)
    ctx = _census_context(Plain, 1 << 17)
    ds = DS(ctx, N, rot_indices=list(p.rotations), use_minimal_keys=True)
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(42))
    out = getattr(ds, SORT_FN[algo])(ctx.encrypt(vals, slots=N),
                                     p.sign_config())
    return vals, ctx.decrypt(out)[:N], ctx.calls


@pytest.mark.parametrize("algo,N", [
    ("direct", 128), ("hybrid", 128), ("hybrid2", 128),
    ("hybrid1", 512), ("hybrid2", 512)])
def test_plain_matches_jax(algo, N):
    vals, jout, jcalls = _plain_sort(JDirectSort, jreg, JPlain, algo, N)
    _, tout, tcalls = _plain_sort(TDirectSort, treg, TPlain, algo, N)
    np.testing.assert_array_equal(tout, jout)
    assert tcalls == jcalls
    assert tcalls["rotate"] > 0 and tcalls["mult"] > 0
    assert np.abs(tout - np.sort(vals)).max() < 0.01


@pytest.mark.parametrize("algo,N", [
    ("direct", 128), ("direct", 2048), ("hybrid", 128), ("hybrid2", 128),
    ("hybrid1", 128), ("hybrid1", 256), ("hybrid1", 512),
    ("mehp24", 128), ("mehp24", 512), ("mehp24", 1024)])
def test_registry_chain_within_hestd128(algo, N, monkeypatch):
    # logQP needs the primes only, not the NTT tables
    monkeypatch.setattr(tparams, "NttContext", lambda *a, **kw: None)
    cfg = treg.full_config(treg.get_params(algo, N))
    assert cfg.ring_dim == 1 << 17
    assert treg.security_check(cfg, tparams.CkksParams(cfg, "cpu"))[2]
    jcfg = tparams.CkksConfig(**asdict(jreg.full_config(
        jreg.get_params(algo, N))))
    if jcfg.dnum == cfg.dnum:
        assert jcfg == cfg
    else:
        assert not treg.security_check(jcfg, tparams.CkksParams(jcfg,
                                                                "cpu"))[2]


@pytest.mark.slow
def test_direct_encrypted_n4_bit_equal_to_jax():
    """tests/test_direct_sort.py's encrypted direct sort config (ring
    2^10, depth 30, dnum 6)."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
    from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
    cfg = dict(ring_dim=1 << 10, mult_depth=30, scale_bits=52, comp=2,
               dnum=6)
    N = 4
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(11))
    runs = []
    for ctx, DS in ((JC(JCfg(**cfg)), JDirectSort),
                    (TC(TCfg(**cfg), device="cpu"), TDirectSort)):
        out = DS(ctx, N).sort(ctx.encrypt(vals, slots=N))
        runs.append((out, np.asarray(ctx.decrypt(out))[:N]))
    (jout, jv), (tout, tv) = runs
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    for got in (jv, tv):
        assert np.abs(got - np.sort(vals)).max() < 0.01, got
