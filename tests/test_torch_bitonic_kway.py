"""BitonicSort (models/bitonic.py) and the k-way network (models/kway.py)
through the torch port.

Tier-1, on PlainContext (exact arithmetic, no crypto; each package's
models on its own copy): the port's BitonicSort (N = 4, 8, 16; the registry's sign config, the
bitonic fixture's data and dual gate) and KWaySorter (k=2 M=2..4, k=3
M=2, k=5 M=1) give exactly the JAX models' outputs with the same census
of context calls, and a counting bootstrap hook fires at the same points
with the same values in both packages.

Tier-1, encrypted on the port alone (compared with np.sort, no JAX):
tests/test_bootstrap_depth.py's two fixtures, the real BootstrapHook
behind BitonicSort's level trigger (depth 58, boot at level 29) and
behind k-way k=2 M=4's checkLevelAndBoot (depth 40), at ring 2^8, each
with the fixture's depth, trigger, sign degrees, input and gate.

`slow`: an encrypted BitonicSort N=8 with the real BootstrapHook at
tests/test_bootstrap.py's config (ring 2^9, depth 26, dnum 4, hw 16), and
a KWaySorter k=2 M=2 with recrypt_hook at tests/test_kway.py's config
(ring 2^10, depth 24, dnum 6), against the JAX package.
"""

import collections

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu import registry as jreg
from sorting_fhe_tpu.models.bitonic import BitonicSort as JBitonic
from sorting_fhe_tpu.models.kway import KWaySorter as JKWay
from sorting_fhe_tpu.ops.sign import (SignConfig as JS,
                                      CompositeSignConfig as JCS)
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.bench import BITONIC_GATE
from sorting_fhe_tpu_torch.core.bootstrap import BootstrapHook as THook
from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.models.bitonic import BitonicSort as TBitonic
from sorting_fhe_tpu_torch.models.kway import KWaySorter as TKWay
from sorting_fhe_tpu_torch.ops.sign import (SignConfig as TS,
                                            CompositeSignConfig as TCS)
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CENSUS_OPS = ("rotate", "mult", "square", "mult_plain", "mult_scalar",
              "add", "sub", "rsub", "make_plaintext", "rescale",
              "level_reduce")


def _census_class(Plain):
    class _CensusContext(Plain):
        """A PlainContext that counts its calls by name in `calls`, with
        the level bookkeeping the boot triggers read (every ciphertext
        reports 64 limbs: nothing is ever consumed)."""

        def __init__(self, ring: int):
            super().__init__(ring)
            self.calls = collections.Counter()
            for name in CENSUS_OPS:
                def counted(*args, _fn=getattr(self, name), _name=name,
                            **kw):
                    self.calls[_name] += 1
                    return _fn(*args, **kw)
                setattr(self, name, counted)

        @property
        def params(self):
            p = super().params
            p.comp, p.base_limbs, p.L = 2, 3, 30
            return p
    return _CensusContext


# each package's models run on its own PlainContext
JCensus, TCensus = _census_class(JPlain), _census_class(TPlain)


def _recorder(ctx, seen):
    """A bootstrap hook that records (slots, values) and returns ct."""
    def hook(ct):
        seen.append((ct.slots, ctx.decrypt(ct).copy()))
        return ct
    return hook


def _bitonic(Sort, reg, Census, N, level=None):
    ctx = Census(1 << 13)
    seen = []
    hook = None if level is None else _recorder(ctx, seen)
    bs = Sort(ctx, N, bootstrap_level=level, bootstrap_hook=hook)
    v = vector_with_min_diff(N, 0, 255, 0.01, np.random.default_rng(11 + N))
    out = bs.sort(ctx.encrypt(v, slots=N),
                  reg.get_params("bitonic", N).sign_config())
    return v, ctx.decrypt(out)[:N], ctx.calls, seen


@pytest.mark.parametrize("N", [4, 8, 16])
def test_bitonic_plain_matches_jax(N):
    v, jout, jcalls, _ = _bitonic(JBitonic, jreg, JCensus, N)
    _, tout, tcalls, _ = _bitonic(TBitonic, treg, TCensus, N)
    np.testing.assert_array_equal(tout, jout)
    assert tcalls == jcalls and tcalls["rotate"] > 0
    err = np.abs(tout - np.sort(v))
    assert err.max() < BITONIC_GATE[0] and not (err > BITONIC_GATE[1]).any()


def _kway(Sorter, S, CS, Census, k, M, mult_depth=10 ** 6):
    N = k ** M
    ctx = Census(1 << 12)
    seen = []
    sorter = Sorter(ctx, k, M, mult_depth=mult_depth,
                    bootstrap_hook=_recorder(ctx, seen))
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(42 + N))
    out = sorter.sort(ctx.encrypt(v, slots=sorter.num_slots),
                      S(CS(3, 8, 3)))
    return v, ctx.decrypt(out)[:N], ctx.calls, seen


@pytest.mark.parametrize("k,M", [(2, 2), (2, 3), (2, 4), (3, 2), (5, 1)])
def test_kway_plain_matches_jax(k, M):
    """Near-exact sign (3, 8, 3), as tests/test_kway.py's network test."""
    v, jout, jcalls, _ = _kway(JKWay, JS, JCS, JCensus, k, M)
    _, tout, tcalls, _ = _kway(TKWay, TS, TCS, TCensus, k, M)
    np.testing.assert_array_equal(tout, jout)
    assert tcalls == jcalls and tcalls["mult"] > 0
    assert np.abs(tout - np.sort(v)).max() < 1e-3


@pytest.mark.parametrize("model", ["bitonic N=8", "kway k=2 M=3",
                                   "kway k=3 M=2"])
def test_boot_hook_fires_at_the_same_points(model):
    """Bitonic boots before every stage when its trigger is -1.  The k-way
    checkLevelAndBoot fires where depth - consumed < need + 1: at depth 3
    every check of k=2 fires (need 3); at depth 4, 6 of the 9 checks of
    k=3 M=2 fire (need 5) and the 3 with need 3 do not."""
    if model.startswith("bitonic"):
        runs = [_bitonic(S, reg, C, 8, level=-1)
                for S, reg, C in ((JBitonic, jreg, JCensus),
                                  (TBitonic, treg, TCensus))]
    else:
        k, M = (2, 3) if "k=2" in model else (3, 2)
        runs = [_kway(S, Sg, CS, C, k, M, mult_depth=k + 1)
                for S, Sg, CS, C in ((JKWay, JS, JCS, JCensus),
                                     (TKWay, TS, TCS, TCensus))]
    (_, _, _, jseen), (_, _, _, tseen) = runs
    assert len(tseen) == len(jseen)
    for (js, jv), (ts, tv) in zip(jseen, tseen):
        assert ts == js
        np.testing.assert_array_equal(tv, jv)
    want = {"bitonic N=8": 6, "kway k=2 M=3": 12, "kway k=3 M=2": 6}[model]
    assert len(tseen) == want


def _counting_mod_raise(ctx):
    """Wrap ctx.mod_raise so that every real bootstrap is counted."""
    raised = []
    orig = ctx.mod_raise
    ctx.mod_raise = lambda c, _f=orig, _r=raised: _r.append(_f(c)) or _r[-1]
    return raised


def test_bitonic_real_bootstrap_at_depth():
    """tests/test_bootstrap_depth.py::test_bitonic_real_bootstrap_ring12
    at ring 2^8: N=4, depth 58, boot at consumed level 29, sign (4,3,3),
    inputs in [0, 255], and the reference's dual gate: max error < 1.0
    and no slot over 0.1 (BitonicSortTest.cpp:88-103)."""
    cfg = TCfg(ring_dim=1 << 8, mult_depth=58, scale_bits=52, comp=2,
               dnum=6, secret_hw=32)
    ctx = TC(cfg, device="cpu")
    raised = _counting_mod_raise(ctx)
    N = 4
    bs = TBitonic(ctx, N, bootstrap_level=29, bootstrap_hook=THook(ctx))
    v = vector_with_min_diff(N, 0, 255, 0.01, np.random.default_rng(11))
    out = bs.sort(ctx.encrypt(v, slots=N),
                  TS(TCS(4, 3, 3), mult_depth=cfg.mult_depth))
    err = np.abs(ctx.decrypt(out)[:N] - np.sort(v))
    assert len(raised) >= 1
    assert err.max() < 1.0, err
    assert int((err > 0.1).sum()) == 0, err


def test_kway_k2_m4_real_bootstrap_at_depth():
    """tests/test_bootstrap_depth.py::test_kway_k2_m4_real_bootstrap_ring11
    at ring 2^8: k=2 M=4 (N=16) at depth 40, sign (3,2,5), with real
    bootstraps wherever checkLevelAndBoot fires; gate 0.01."""
    cfg = TCfg(ring_dim=1 << 8, mult_depth=40, scale_bits=52, comp=2,
               dnum=6, secret_hw=32, limb_pad=8)
    ctx = TC(cfg, device="cpu")
    raised = _counting_mod_raise(ctx)
    N = 16
    sorter = TKWay(ctx, 2, 4, mult_depth=cfg.mult_depth,
                   bootstrap_hook=THook(ctx))
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(12))
    out = sorter.sort(ctx.encrypt(v, slots=N),
                      TS(TCS(3, 2, 5), mult_depth=cfg.mult_depth))
    err = np.abs(ctx.decrypt(out)[:N] - np.sort(v))
    assert len(raised) >= 1
    assert err.max() < 0.01, err


def _both(cfg):
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    return JC(JCfg(**cfg)), TC(TCfg(**cfg), device="cpu")


@pytest.mark.slow
def test_bitonic_n8_real_bootstrap_against_jax():
    """tests/test_bootstrap.py::test_bitonic_sort_with_real_bootstrap's
    config with 4 more levels: every mod-raise agrees at this seed, so the
    outputs are bit-equal, and both are within that test's 2.0 gate of
    np.sort.  At its depth 26 a stage runs out of levels after a bootstrap
    and both packages decrypt to about 0 (max error 226.7)."""
    from sorting_fhe_tpu.core.bootstrap import BootstrapHook as JHook
    cfg = dict(ring_dim=1 << 9, mult_depth=30, scale_bits=52, comp=2,
               dnum=4, secret_hw=16)
    N = 8
    rng = np.random.default_rng(7)
    v = (rng.permutation(N).astype(np.float64) + 1.0) * 255.0 / (N + 1)
    runs = []
    for ctx, Sort, Hook, S, CS in zip(_both(cfg), (JBitonic, TBitonic),
                                      (JHook, THook), (JS, TS), (JCS, TCS)):
        raised = _counting_mod_raise(ctx)
        bs = Sort(ctx, N, bootstrap_level=8, bootstrap_hook=Hook(ctx))
        out = bs.sort(ctx.encrypt(v, slots=N),
                      S(CS(3, 2, 2), mult_depth=cfg["mult_depth"]))
        runs.append((out, np.asarray(ctx.decrypt(out))[:N], raised))
    (jout, jv, jr), (tout, tv, tr) = runs
    assert len(jr) == len(tr) > 0
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a.data),
                                      residues_to_numpy(b.data))
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    for got in (jv, tv):
        assert np.abs(got - np.sort(v)).max() < 2.0, got


@pytest.mark.slow
def test_kway_k2_m2_recrypt_bit_equal_to_jax():
    """tests/test_kway.py::test_kway_n4_with_recrypt_boot's config."""
    from sorting_fhe_tpu.utils.debug import recrypt_hook as jrecrypt
    from sorting_fhe_tpu_torch.utils.debug import recrypt_hook as trecrypt
    cfg = dict(ring_dim=1 << 10, mult_depth=24, scale_bits=52, comp=2,
               dnum=6)
    vals = vector_with_min_diff(4, 0, 1, 0.25, np.random.default_rng(7))
    runs = []
    for ctx, Sorter, recrypt, S, CS in zip(_both(cfg), (JKWay, TKWay),
                                           (jrecrypt, trecrypt), (JS, TS),
                                           (JCS, TCS)):
        sorter = Sorter(ctx, 2, 2, mult_depth=24,
                        bootstrap_hook=recrypt(ctx))
        out = sorter.sort(ctx.encrypt(vals, slots=4), S(CS(3, 2, 2)))
        runs.append((out, np.asarray(ctx.decrypt(out))[:4]))
    (jout, jv), (tout, tv) = runs
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    np.testing.assert_array_equal(jv, tv)
    assert np.abs(tv - np.sort(vals)).max() < 0.01, tv
